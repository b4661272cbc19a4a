"""The partition of the blocked quantize kernel's reduction, on the CPU.

The CUDA kernel (csrc/quantize.cu) gives each (token block, column slab)
to one thread block and reads each element once: a thread holds the rows
``r, r + RS, r + 2 RS, ...`` of the block (RS = 256 / lanes rows a sweep,
`kernels.quantize.blocked_lanes`), reduces their column absmax, and the
block max-combines its threads' partials before it quantizes the rows it
holds. Max is order-free, so the partition must not move a bit: here the
plain absmax over row shares (the kernel's strided ones, contiguous ones,
and share counts that do not divide the block), max-combined, then scaled
and quantized, is held BITWISE against `quantize_blocked_plain` and the
reference's jitted `core.quantization.quantize_blocked`, at blocks of 8,
24 and 256, with an all-zero channel and one of absmax 1e-29.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as RQ
from repro_torch.kernels import quantize as K
from torch_parity import to_numpy

jax.config.update("jax_platform_name", "cpu")

quantize_blocked_ref = jax.jit(RQ.quantize_blocked, static_argnums=1)


def _x(shape, seed):
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    x[..., 2] = 0.0                                # an all-zero channel
    x[..., 3] *= np.float32(1e-29)                 # absmax exactly 1e-29
    x[..., 0, 3] = np.float32(1e-29)
    return x


def quantize_by_shares(x: torch.Tensor, bs: int, shares):
    """Quantize (..., T, D) per token block with the column absmax taken
    over each row share of a block (``shares``: lists of row offsets in
    [0, bs)), then max-combined: the kernel's arithmetic."""
    *lead, T, D = x.shape
    xb = x.reshape(*lead, T // bs, bs, D)
    parts = [torch.amax(torch.abs(xb[..., s, :]), dim=-2) for s in shares
             if len(s)]
    absmax = parts[0]
    for p in parts[1:]:
        absmax = torch.maximum(absmax, p)
    scales = K._scales(absmax)
    q = torch.clamp(torch.round(xb / scales.unsqueeze(-2)), -K.QMAX, K.QMAX)
    return q.to(torch.int8).reshape(*lead, T, D), scales


def strided(bs: int, rs: int):
    """The kernel's shares: thread row r holds rows r, r + rs, ..."""
    return [list(range(r, bs, rs)) for r in range(rs)]


def contiguous(bs: int, n: int):
    per = -(-bs // n)
    return [list(range(i * per, min(bs, i * per + per))) for i in range(n)]


# (shape, block): the smoke cache's block 8, a block of 24 and the full
# model's 256 (D 128, and a D of 16 under one 64-byte row)
SHAPES = [((2, 3, 32, 16), 8), ((2, 2, 48, 32), 24), ((1, 2, 512, 128), 256),
          ((2, 1, 256, 16), 256)]


@pytest.mark.parametrize("shape,bs", SHAPES)
def test_kernel_partition_is_bitwise(shape, bs):
    x = _x(shape, seed=bs)
    xt = torch.from_numpy(x)
    *lead, T, D = shape
    lanes = K.blocked_lanes(int(np.prod(lead)), T, D, bs, 132)
    got = quantize_by_shares(xt, bs, strided(bs, K.BLOCKED_THREADS // lanes))
    want = K.quantize_blocked_plain(xt, bs)
    ref = quantize_blocked_ref(jnp.asarray(x), bs)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert to_numpy(g).tobytes() == to_numpy(w).tobytes()
        assert to_numpy(g).tobytes() == np.asarray(r).tobytes()


@pytest.mark.parametrize("bs,n", [(8, 3), (24, 5), (24, 16), (256, 7),
                                  (256, 100)])
@pytest.mark.parametrize("kind", ["strided", "contiguous"])
def test_any_row_partition_is_bitwise(bs, n, kind):
    """Share counts that do not divide the block (and more shares than
    rows: some empty)."""
    x = _x((2, 2 * bs, 32), seed=n)
    xt = torch.from_numpy(x)
    shares = strided(bs, n) if kind == "strided" else contiguous(bs, n)
    assert sorted(t for s in shares for t in s) == list(range(bs))
    got = quantize_by_shares(xt, bs, shares)
    ref = quantize_blocked_ref(jnp.asarray(x), bs)
    for g, w, r in zip(got, K.quantize_blocked_plain(xt, bs), ref):
        assert to_numpy(g).tobytes() == to_numpy(w).tobytes()
        assert to_numpy(g).tobytes() == np.asarray(r).tobytes()


# (N, T, D, block, SMs) -> 16-byte lanes a row of the kernel's slab
LANES = [((32, 256, 128, 256, 132), 4),      # a flush: fill the card
         ((32, 2048, 128, 256, 132), 8),     # the timed quantize shape
         ((1, 131072, 8192, 256, 132), 8),   # the paper's largest
         ((1, 1032, 64, 8, 132), 16),        # D 64: 16 lanes span it
         ((4, 48, 16, 24, 132), 4),          # D 16
         ((32, 1024, 128, 8, 132), 32),      # block 8: one sweep
         ((1, 4096, 128, 1024, 132), 2),     # rows fit 8 sweeps
         ((1, 8192, 128, 4096, 132), 1)]     # past 8 sweeps: read twice


@pytest.mark.parametrize("shape,want", LANES)
def test_slab_lanes_from_shapes(shape, want):
    lanes = K.blocked_lanes(*shape)
    assert lanes == want
    N, T, D, bs, _ = shape
    rows = K.BLOCKED_THREADS // lanes
    assert -(-bs // rows) <= K.BLOCKED_SWEEPS or lanes == 1
