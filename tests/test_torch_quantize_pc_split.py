"""The partition of the per-channel pair's absmax, on the CPU, and the
quantize family's NaN and inf against the reference.

The CUDA absmax (csrc/quantize.cu) cuts each (matrix, column slab) of
(N, T, D) into chunks of T (`kernels.quantize.absmax_plan` picks the slab
width and the split, `chunk_rows` the rows a chunk): a thread holds the
rows ``t0 + r, t0 + r + RS, ...`` of its chunk (RS = 256 / lanes rows a
sweep), a block max-combines its threads, and the blocks of a slab, one
thread block cluster, write their rows into the first block's shared
memory, which folds them. Max is order-free, so the partition must not
move a bit: here the plain absmax over those thread rows and chunks,
folded in several orders, then scaled
and quantized as the second kernel does, is held BITWISE against
`absmax_plain` / `quantize_with_scales_plain` and the reference's Pallas
`quantize_per_channel` in interpret mode, at T 1, 24, 1000, 1032 and 2048
with an all-zero channel and one of absmax 1e-29. The two kernels' grids
(`absmax_plan`, `quantize_plan`) are pinned from shapes.

NaN and inf: a channel (per block: a block's channel) holding a NaN has a
NaN scale, one holding an inf an inf scale, and every int8 value of both
is 0 in the reference; the plain versions (what the kernels are held to on
the card) give the same: NaN at the same positions, every other bit equal.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantize as RK
from repro_torch.kernels import quantize as K
from torch_parity import to_numpy

SMS = 132                                          # an H100's SM count


def _x(shape, seed):
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    x[..., 2] = 0.0                                # an all-zero channel
    x[..., 3] *= np.float32(1e-29)                 # absmax exactly 1e-29
    x[..., 0, 3] = np.float32(1e-29)
    return x


def absmax_by_chunks(x: torch.Tensor, lanes: int, splits: int, order):
    """Column absmax of (N, T, D) as the kernel partitions it: chunks of
    `chunk_rows` rows, thread row r of a chunk holding rows t0 + r + j RS
    (taken PC_BATCH at a time), threads max-combined, then the chunks'
    rows folded in ``order`` (a permutation of the chunks)."""
    N, T, D = x.shape
    rs = K.PC_THREADS // lanes
    rows = K.chunk_rows(T, splits, lanes)
    chunks = -(-T // rows)
    assert chunks <= splits
    parts = []
    for c in range(chunks):
        t0, t1 = c * rows, min(T, (c + 1) * rows)
        threads = []
        for r in range(rs):
            own = list(range(t0 + r, t1, rs))
            m = torch.zeros((N, D))
            for b in range(0, len(own), K.PC_BATCH):
                batch = own[b:b + K.PC_BATCH]
                m = torch.maximum(m, torch.amax(x[:, batch].abs(), dim=1))
            threads.append(m)
        block = threads[0]
        for m in threads[1:]:
            block = torch.maximum(block, m)
        parts.append(block)
    out = torch.zeros((N, D))
    for c in order(chunks):
        out = torch.maximum(out, parts[c])
    return out


ORDERS = {"first-to-last": lambda n: range(n),
          "last-to-first": lambda n: reversed(range(n)),
          "shuffled": lambda n: np.random.RandomState(n).permutation(n)}


def _reference(x):
    """The reference's Pallas pair, interpret mode, one matrix at a time."""
    out = [RK.quantize_per_channel(jnp.asarray(m), interpret=True) for m in x]
    return (np.stack([np.asarray(q) for q, _ in out]),
            np.stack([np.asarray(s) for _, s in out]))


# (N, T, D): the pair's T cases at the smoke cache's head width and the
# model's
CASES = [(2, 1, 64), (2, 24, 64), (2, 1000, 64), (2, 1032, 64),
         (1, 2048, 128)]


@pytest.mark.parametrize("plan", ["planned", (32, 3), (2, 7), (8, 64)],
                         ids=["planned", "32x3", "2x7", "8x64"])
@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("shape", CASES, ids=[f"T{c[1]}" for c in CASES])
def test_absmax_partition_is_bitwise(shape, order, plan):
    x = _x(shape, seed=shape[1])
    xt = torch.from_numpy(x)
    lanes, splits = (K.absmax_plan(*shape, SMS) if plan == "planned"
                     else plan)
    am = absmax_by_chunks(xt, lanes, splits, ORDERS[order])
    want = K.absmax_plain(xt)
    assert to_numpy(am).tobytes() == to_numpy(want).tobytes()
    q, s = K.quantize_with_scales_plain(xt, am)
    pq, ps = K.quantize_with_scales_plain(xt, want)
    rq, rs = _reference(x)
    assert to_numpy(q).tobytes() == to_numpy(pq).tobytes() == rq.tobytes()
    assert to_numpy(s).tobytes() == to_numpy(ps).tobytes() == rs.tobytes()


# (N, T, D, SMs) -> absmax (lanes, chunks), quantize (lanes, vec, chunks)
PLANS = [((32, 1000, 128, 132), (8, 4), (16, 2, 32)),    # generate prefill
         ((32, 2048, 128, 132), (8, 4), (16, 2, 64)),    # the timed shape
         ((32, 2048, 128, 600), (8, 16), (16, 2, 64)),   # more SMs: more
         ((1, 2048, 128, 132), (4, 16), (16, 2, 128)),   # the paper's least
         ((1, 16384, 256, 132), (4, 16), (32, 2, 1024)),  # 1 KB rows
         ((1, 131072, 1024, 132), (8, 16), (32, 2, 8192)),
         ((1, 131072, 8192, 132), (8, 2), (32, 2, 8192)),  # its largest
         ((1, 1, 2048, 132), (8, 1), (32, 2, 1)),        # a final norm
         ((1, 24, 2048, 132), (8, 1), (32, 2, 3)),       # the stacked norms
         ((1, 196608, 2048, 132), (8, 8), (32, 2, 12288)),  # w_down
         ((1, 2048, 92544, 132), (8, 1), (32, 2, 128)),  # lm_head's grad
         ((2, 40, 16, 132), (4, 1), (2, 2, 1)),          # the smoke head
         ((3, 24, 12, 132), (4, 1), (4, 1, 1))]          # D % 8 != 0


@pytest.mark.parametrize("shape,absmax,quant", PLANS)
def test_plans_from_shapes(shape, absmax, quant):
    N, T, D, sms = shape
    assert K.absmax_plan(*shape) == absmax
    assert K.quantize_plan(*shape) == quant
    for lanes, cols, chunks in ((absmax[0], 4 * absmax[0], absmax[1]),
                                (quant[0], 4 * quant[1] * quant[0],
                                 quant[2])):
        rows = K.chunk_rows(T, chunks, lanes)
        assert -(-T // rows) == chunks       # the grid's y extent
        assert cols // 2 < D or lanes == 1   # no slab wider than D needs
    # the absmax: one cluster a slab, about one wave of blocks, a whole
    # sweep of rows a chunk
    lanes, chunks = absmax
    slabs = -(-D // (4 * lanes)) * N
    assert 1 <= chunks <= K.PC_CLUSTER
    assert slabs * chunks <= K.ABSMAX_BLOCKS_PER_SM * sms or chunks == 1
    assert K.chunk_rows(T, chunks, lanes) >= K.PC_THREADS // lanes
    # the quantize pass: as many rows a thread as the grid allows
    lanes, vec, chunks = quant
    rs = K.PC_THREADS // lanes
    per = K.chunk_rows(T, chunks, lanes) // rs
    most, least = K.QUANT_ROWS
    assert per <= most or chunks == 1
    assert per >= least or chunks == 1
    assert (-(-D // (4 * vec * lanes)) * N * chunks >=
            K.PC_BLOCKS_PER_SM * sms or per <= least)


def _with_nan_inf(x):
    """NaN in channel 5, +inf in 6, -inf in 7, NaN and inf in 8."""
    x = x.copy()
    x[..., 1, 5] = np.nan
    x[..., -1, 6] = np.inf
    x[..., 0, 7] = -np.inf
    x[..., 0, 8] = np.nan
    x[..., -1, 8] = np.inf
    return x


def _same_with_nan(port, ref):
    a, b = to_numpy(port), np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        nan = np.isnan(b)
        assert (np.isnan(a) == nan).all()
        a, b = a[~nan], b[~nan]
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("T,D", [(16, 16), (1000, 64), (24, 128)])
def test_per_channel_nan_inf_match_reference(T, D):
    x = _with_nan_inf(_x((T, D), seed=T))
    q, s = K.quantize_per_channel_plain(torch.from_numpy(x))
    rq, rs = RK.quantize_per_channel(jnp.asarray(x), interpret=True)
    _same_with_nan(s, rs)
    _same_with_nan(q, rq)
    assert np.isnan(np.asarray(rs)[[5, 8]]).all()
    assert np.isinf(np.asarray(rs)[[6, 7]]).all()
    assert not to_numpy(q)[:, 5:9].any()


@pytest.mark.parametrize("T,D,bs", [(16, 16, 8), (48, 32, 24),
                                    (512, 128, 256)])
def test_blocked_nan_inf_match_reference(T, D, bs):
    x = _with_nan_inf(_x((T, D), seed=bs))
    q, s = K.quantize_blocked_plain(torch.from_numpy(x), bs)
    rq, rs = RK.quantize_blocked(jnp.asarray(x), bs, interpret=True)
    _same_with_nan(s, rs)
    _same_with_nan(q, rq)
    rs = np.asarray(rs)
    assert np.isnan(rs[1 // bs, 5]) and np.isinf(rs[(T - 1) // bs, 6])
    assert not to_numpy(q)[(T - 1) // bs * bs:, 6].any()


def test_gradient_shapes_are_the_stacked_leaves():
    """The (T, D) that chip_smoke.py times the pair at are what
    --grad-compression quantizes each step: internlm2_1_8b's 12 stacked
    gradient leaves, reshaped to (-1, last) as `optim.compression` does."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    shapes = chip_smoke.grad_shapes()
    assert sum(shapes.values()) == 12
    assert shapes == {(1, 2048): 1, (24, 2048): 2, (49152, 1024): 2,
                      (49152, 2048): 2, (49152, 8192): 2, (196608, 2048): 1,
                      (92544, 2048): 1, (2048, 92544): 1}
