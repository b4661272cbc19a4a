"""The flat decode kernel's split slot walk (flash-decoding), on the CPU.

The CUDA kernel splits each row's T cache slots into runs of ``tps`` slots
(`kernels.quant_attention.flat_decode_splits`, from shapes alone), attends
each run alone and merges the runs' partials
(`kernels.quant_attention.merge_split_partials` is that merge in plain
PyTorch). Here the plain partials of each run, merged, are held

- against the unsplit plain version: m exactly, o and l within the
  float32 error of summing n = T terms in two orders, 2 n 2^-24 times the
  sum of the terms' magnitudes (the merge rescales by e^(m_s - m), one
  rounding apart from the one-pass softmax; over up to 1032 slots the
  summation order alone moves o and l by a few 1e-6 of their scale);
- against the reference's Pallas kernel in interpret mode, within the
  1e-5 + 1e-4 |b| of tests/test_torch_flat_decode.py;

at lengths 0, 1, 63, 64, 65 and T, a ring row (length past T) inside a
window, window 0, per-block and per-channel scales, and the per-channel
generate cache's T = 1032 (no multiple of the 64-slot tile). A row with
nothing live comes out exactly as the plain version's (o = 0, m = -1e30,
l = 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as RQ
from repro.kernels import ops as ROPS
from repro_torch.kernels import quant_attention as QA
from torch_parity import to_torch

jax.config.update("jax_platform_name", "cpu")

HKV, G, D, BS = 2, 2, 16, 64
H = HKV * G
TOL = dict(atol=1e-5, rtol=1e-4)


def _rows(T):
    """(lengths, windows): empty, 1, 63, 64, 65, full, a ring row (T + 77
    tokens written) in a window of 100, and a full row in window 0."""
    lengths = np.asarray([0, 1, 63, 64, 65, T, T + 77, T], np.int32)
    windows = np.asarray([T] * 6 + [100, 0], np.int32)
    return lengths, windows


def _inputs(T, per_channel, seed=0):
    rng = np.random.RandomState(seed)
    B = len(_rows(T)[0])
    k = rng.randn(B, HKV, T, D).astype(np.float32)
    v = rng.randn(B, HKV, T, D).astype(np.float32)
    if per_channel:
        quant = lambda x: (lambda q, s: (q, s[:, :, None]))(
            *RQ.quantize_matrix(jnp.asarray(x)))
    else:
        quant = lambda x: RQ.quantize_blocked(jnp.asarray(x), BS)
    kq, ks = (np.asarray(a) for a in quant(k))
    vq, vs = (np.asarray(a) for a in quant(v))
    q = rng.randn(B, H, D).astype(np.float32)
    return q, kq, ks, vq, vs


def split_partials_plain(args, lengths, windows, tps):
    """The kernel's walk in plain PyTorch: each run of ``tps`` slots
    attended alone, the runs' partials stacked as (B, H, n, D) and
    (B, H, n, 1)."""
    T = args[1].shape[2]
    parts = [QA.flat_decode_partials_plain(*args, lengths, windows,
                                           slots=(t0, t0 + tps))
             for t0 in range(0, T, tps)]
    return tuple(torch.stack(x, dim=2) for x in zip(*parts))


CASES = [(256, False), (256, True), (1032, True)]   # (T, per channel)
IDS = ["T256-per_block", "T256-per_channel", "T1032-per_channel"]


@pytest.mark.parametrize("tps", [64, 128, 192, 1088])
@pytest.mark.parametrize("T,per_channel", CASES, ids=IDS)
def test_split_walk_merged_equals_unsplit_plain(T, per_channel, tps):
    args = tuple(to_torch(a) for a in _inputs(T, per_channel))
    lengths, windows = (to_torch(a) for a in _rows(T))
    whole = QA.flat_decode_partials_plain(*args, lengths, windows)
    merged = QA.merge_split_partials(
        *split_partials_plain(args, lengths, windows, tps))
    for got, want in zip(merged, whole):
        assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(merged[1], whole[1])
    # the terms' magnitudes: sum p |v| (v's codes by absolute value) and l
    o_abs = QA.flat_decode_partials_plain(
        args[0], args[1], args[2], args[3].abs(), args[4], lengths,
        windows)[0]
    bound = 2 * T * 2.0 ** -24
    assert bool(((merged[0] - whole[0]).abs() <= bound * o_abs).all())
    assert bool(((merged[2] - whole[2]).abs() <= bound * whole[2]).all())
    o, m, l = merged                       # nothing live: exactly the plain's
    for row in (0, 7):                     # length 0; window 0
        assert float(o[row].abs().max()) == 0.0
        assert float(l[row].max()) == 0.0
        assert bool((m[row] == np.float32(-1e30)).all())


@pytest.mark.parametrize("T,per_channel", CASES, ids=IDS)
def test_split_walk_merged_matches_pallas_interpret(T, per_channel):
    arrs = _inputs(T, per_channel, seed=3)
    lengths, windows = _rows(T)
    ref = ROPS.quant_attention_decode_partials(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(lengths),
        window=jnp.asarray(windows), impl="pallas_interpret")
    nsplit, tps = QA.flat_decode_splits(len(lengths), HKV, G, T, 132)
    assert nsplit > 1
    merged = QA.merge_split_partials(*split_partials_plain(
        tuple(to_torch(a) for a in arrs), to_torch(lengths),
        to_torch(windows), tps))
    for r, p in zip(ref, merged):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)


# (B, H_kv, G, T, SMs) -> (splits, slots a split): about two blocks an SM
# where T allows, a split a whole number of 64-slot tiles, rounded up
SPLITS = [((4, 8, 2, 2048, 132), (8, 256)),    # the timed decode shape
          ((4, 8, 2, 1032, 132), (9, 128)),    # per-channel generate
          ((2, 8, 2, 2048, 132), (16, 128)),
          ((10, 8, 2, 2048, 132), (4, 512)),
          ((20, 8, 2, 2048, 132), (2, 1024)),
          ((40, 8, 2, 2048, 132), (1, 2048)),  # enough rows: one split
          ((40, 8, 2, 64, 132), (1, 64)),
          ((300, 8, 2, 2048, 132), (1, 2048)),
          ((4, 8, 1, 2048, 132), (8, 256)),
          ((4, 8, 3, 2048, 132), (5, 448)),    # G = 3: two query pairs
          ((8, 2, 2, 1032, 132), (17, 64))]


@pytest.mark.parametrize("shape,want", SPLITS)
def test_split_count_from_shapes_only(shape, want):
    assert QA.flat_decode_splits(*shape) == want
    n, tps = want
    assert tps % QA.FLAT_TILE == 0
    assert (n - 1) * tps < shape[3] <= n * tps
