"""The seed-baseline kernel's split walk, on the CPU.

The seed CUDA kernel walks flat decode's splits (runs of ``tps`` slots from
`kernels.quant_attention.flat_decode_splits`, shapes alone) but copies and
folds EVERY slot of each split, a dead one masked in the fold, and merges
the splits' partials (`kernels.quant_attention.merge_split_partials`).
Here that walk is emulated in plain PyTorch: each split's partials over
all of its slots, the dead ones (past ``min(length, T)``, or outside the
row's window) with logit -inf and probability 0, so a split with no live
slot gives m = -1e30, l = 0, o = 0. Merged, they are held

- against `ops.quant_attention_decode_partials_vmap` on the CPU (the
  plain version the kernel is held against on the card) and against the
  reference's ``quant_attention_decode_partials_vmap`` in Pallas
  interpret mode, within the 1e-5 + 1e-4 |b| of
  tests/test_torch_flat_split.py;

per block and per channel, at lengths 0, 1, partial and full, a ring row
(length past T) inside a window, a window of 0 and rows whose later
splits are wholly dead. A row with nothing live comes out exactly as the
plain version's (o = 0, m = -1e30, l = 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as RQ
from repro.kernels import quant_attention as RQA
from repro_torch.kernels import ops
from repro_torch.kernels import quant_attention as QA
from torch_parity import to_torch

jax.config.update("jax_platform_name", "cpu")

HKV, G, D, BS = 2, 2, 16, 64
H = HKV * G
TOL = dict(atol=1e-5, rtol=1e-4)
NEG_INF = np.float32(-1e30)


def _rows(T):
    """(lengths, windows): empty, 1, a partial first split, full, a ring
    row in a window of 100, a full row in window 0, and a row in a window
    shorter than its length."""
    lengths = np.asarray([0, 1, 70, T, T + 77, T, 150], np.int32)
    windows = np.asarray([T, T, T, T, 100, 0, 40], np.int32)
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


def seed_split_partials_plain(args, lengths, windows, tps):
    """The seed kernel's walk in plain PyTorch: for each run of ``tps``
    slots, every slot dequantized and its logit computed, the dead ones
    masked to -inf; the runs' partials stacked as (B, H, n, D) and
    (B, H, n, 1)."""
    q, kq, ks, vq, vs = args
    B, _, T, _ = kq.shape
    nb = ks.shape[2]
    deq = lambda x, s: (x.reshape(B, HKV, nb, T // nb, D).float()
                        * s[:, :, :, None]).reshape(B, HKV, T, D)
    k, v = deq(kq, ks), deq(vq, vs)
    qg = q.reshape(B, HKV, G, D)
    t = torch.arange(T)[None]
    ln = lengths.long()[:, None]
    live = (t < torch.clamp_max(ln, T)) & \
        (torch.remainder(ln - 1 - t, T) < windows.long()[:, None])
    parts = []
    for t0 in range(0, T, tps):
        t1 = min(t0 + tps, T)
        x = torch.einsum("bhgd,bhtd->bhgt", qg, k[:, :, t0:t1]) \
            * QA.logit_scale(D)
        lv = live[:, None, None, t0:t1]
        x = torch.where(lv, x, torch.full_like(x, -float("inf")))
        m = torch.clamp_min(torch.amax(x, dim=-1, keepdim=True),
                            float(NEG_INF))
        p = torch.exp(x - m)
        o = torch.einsum("bhgt,bhtd->bhgd", p, v[:, :, t0:t1])
        parts.append((o.reshape(B, H, D), m.reshape(B, H, 1),
                      p.sum(-1).reshape(B, H, 1)))
    return tuple(torch.stack(x, dim=2) for x in zip(*parts))


CASES = [(256, False), (256, True), (1032, True)]   # (T, per channel)
IDS = ["T256-per_block", "T256-per_channel", "T1032-per_channel"]


def _splits(T, n_rows):
    nsplit, tps = QA.flat_decode_splits(n_rows, HKV, G, T, 132)
    assert nsplit > 1
    return tps


@pytest.mark.parametrize("T,per_channel", CASES, ids=IDS)
def test_seed_split_walk_merged_matches_vmap_entry(T, per_channel):
    args = tuple(to_torch(a) for a in _inputs(T, per_channel))
    lengths, windows = (to_torch(a) for a in _rows(T))
    tps = _splits(T, len(lengths))
    parts = seed_split_partials_plain(args, lengths, windows, tps)
    # the row of length 1 and the window-0 row: later splits wholly dead
    assert bool((parts[1][1, :, 1:] == NEG_INF).all())
    assert float(parts[2][5].abs().max()) == 0.0
    merged = QA.merge_split_partials(*parts)
    entry = ops.quant_attention_decode_partials_vmap(
        *args, lengths, window=windows)
    for got, want in zip(merged, entry):
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, **TOL)
    o, m, l = merged                       # nothing live: exactly the plain's
    for row in (0, 5):                     # length 0; window 0
        assert float(o[row].abs().max()) == 0.0
        assert float(l[row].max()) == 0.0
        assert bool((m[row] == NEG_INF).all())
        assert torch.equal(m[row], entry[1][row])


@pytest.mark.parametrize("T,per_channel", CASES, ids=IDS)
def test_seed_split_walk_merged_matches_pallas_vmap_interpret(T,
                                                              per_channel):
    arrs = _inputs(T, per_channel, seed=5)
    lengths, windows = _rows(T)
    ref = RQA.quant_attention_decode_partials_vmap(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(lengths),
        window=jnp.asarray(windows), interpret=True)
    merged = QA.merge_split_partials(*seed_split_partials_plain(
        tuple(to_torch(a) for a in arrs), to_torch(lengths),
        to_torch(windows), _splits(T, len(lengths))))
    for r, p in zip(ref, merged):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
