"""The cross-rank merge of flat decode's partials
(`kernels.quant_attention.merge_rank_partials`), rank-free: the int8
cache's key axis cut into n parts anywhere (empty parts, parts past the
live length, a part holding one slot, a block cut in two), each part's
partials from flat decode's plain version over its slots at its local
length (what a rank of a sequence-sharded cache computes), merged in
part order -> within 1e-6 of one softmax over the whole cache and of the
reference's Pallas flat decode kernel (interpret mode) over it; a part
with nothing to attend (m = -1e30) adds nothing (bit for bit), and the
merge is `merge_split_partials`' up to the order of its sums.

The sharded ring (`core.kvcache.ring_slot_args`): for every length
(unwrapped, wrapped once and more), window (none, every width up to
past the ring) and rank of rings of 8 to 32 slots over 1 to 8 ranks,
the kernel's mask at the rank's (length, window) keeps exactly the
slots the one-process kernel keeps there (a run, two runs at both ends,
or none); and the ranks' partials over a wrapped 32-slot ring in 4
parts, merged, equal one kernel over the whole ring within 1e-6 (the
reference's Pallas kernel too)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RQA
from repro_torch.core.kvcache import ring_slot_args
from repro_torch.kernels.quant_attention import (flat_decode_partials_plain,
                                                 merge_rank_partials,
                                                 merge_split_partials)

B, H, HKV, T, D, BS = 3, 4, 2, 64, 16, 8


def _cache(seed: int, per_channel: bool):
    g = torch.Generator().manual_seed(seed)
    nb = 1 if per_channel else T // BS
    kq = torch.randint(-127, 128, (B, HKV, T, D), generator=g,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, HKV, T, D), generator=g,
                       dtype=torch.int8)
    ks = torch.rand((B, HKV, nb, D), generator=g) * 0.02 + 1e-3
    vs = torch.rand((B, HKV, nb, D), generator=g) * 0.02 + 1e-3
    q = torch.randn((B, H, D), generator=g)
    return q, kq, ks, vq, vs


def _cuts(seed: int) -> list[int]:
    """Part boundaries 0 = c_0 <= ... <= c_n = T, n from 2 to 6, with
    repeats (empty parts) allowed."""
    rng = np.random.RandomState(seed)
    n = rng.randint(2, 7)
    return [0, *sorted(rng.randint(0, T + 1, n - 1).tolist()), T]


def _rows(ks, c0: int, c1: int):
    """The scale rows of slots [c0, c1) at the kernel's T / nb slots a row
    (as `ShardedKVCache` builds them where a block may straddle parts)."""
    if ks.shape[2] == 1:
        return ks
    g = int(np.gcd.reduce([BS, c1 - c0, c0]))
    idx = [(c0 + j * g) // BS for j in range((c1 - c0) // g)]
    return ks[:, :, idx]


def _parts(cache, cuts, length):
    q, kq, ks, vq, vs = cache
    outs = []
    win = torch.full((B,), T, dtype=torch.int32)
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        n = min(max(length - c0, 0), c1 - c0)
        if c1 == c0:            # no slots: what a kernel gives for none
            outs.append((torch.zeros((B, H, D)),
                         torch.full((B, H, 1), -1e30), torch.zeros((B, H, 1))))
            continue
        outs.append(flat_decode_partials_plain(
            q, kq[:, :, c0:c1], _rows(ks, c0, c1), vq[:, :, c0:c1],
            _rows(vs, c0, c1), torch.full((B,), n, dtype=torch.int32), win))
    return [torch.stack(x) for x in zip(*outs)]


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_rank_merge_equals_one_softmax(seed, per_channel):
    cache = _cache(seed, per_channel)
    length = [T, 37, 1, 0, 48, 63][seed]
    cuts = _cuts(seed)
    o, m, l = merge_rank_partials(*_parts(cache, cuts, length))
    q, kq, ks, vq, vs = cache
    full = flat_decode_partials_plain(
        q, kq, ks, vq, vs, torch.full((B,), length, dtype=torch.int32),
        torch.full((B,), T, dtype=torch.int32))
    got = o / torch.clamp_min(l, 1e-30)
    want = full[0] / torch.clamp_min(full[2], 1e-30)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)
    # the max logit: the same dot products, summed over a part's slots
    np.testing.assert_allclose(m.numpy(), full[1].numpy(), rtol=1e-6)
    ref = RQA.quant_attention_decode_partials(
        jnp.asarray(q.numpy()), jnp.asarray(kq.numpy()),
        jnp.asarray(ks.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(vs.numpy()), jnp.full((B,), length, jnp.int32),
        impl="pallas_interpret")
    ro, _, rl = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(got.numpy(), ro / np.maximum(rl, 1e-30),
                               atol=1e-6, rtol=1e-5)
    # merge_split_partials' numbers (its sums in another order)
    so, sm, sl = merge_split_partials(*(x.movedim(0, 2) for x in
                                        _parts(cache, cuts, length)))
    np.testing.assert_allclose(o.numpy(), so.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(m.numpy(), sm.numpy())


def test_rank_with_nothing_adds_nothing():
    cache = _cache(7, False)
    o1, m1, l1 = merge_rank_partials(*_parts(cache, [0, 32, 64], 20))
    o2, m2, l2 = merge_rank_partials(*_parts(cache, [0, 32, 64, 64], 20))
    for a, b in ((o1, o2), (m1, m2), (l1, l2)):
        assert torch.equal(a, b)
    empty = _parts(cache, [0, 64], 0)      # no live slot anywhere
    o, m, l = merge_rank_partials(*empty)
    assert torch.all(m == -1e30) and torch.all(l == 0) and torch.all(o == 0)


def _kernel_mask(length: int, window: int, n: int) -> np.ndarray:
    """The slots flat decode keeps over n slots (its plain version's
    mask)."""
    t = np.arange(n)
    return (t < min(length, n)) & (np.mod(length - 1 - t, n) < window)


@pytest.mark.parametrize("total,ranks", [(8, 2), (16, 4), (16, 2), (24, 3),
                                         (32, 8), (32, 1)])
def test_ring_slot_args_keep_the_one_process_slots(total, ranks):
    n = total // ranks
    for length in range(0, 3 * total + 3):
        for window in [None] + list(range(0, total + 3)):
            w = total if window is None else window
            whole = _kernel_mask(length, w, total)
            for r in range(ranks):
                ln, wn = ring_slot_args(length, window, total, r * n, n)
                got = _kernel_mask(ln, wn, n)
                assert np.array_equal(got, whole[r * n:(r + 1) * n]), (
                    length, window, r, ln, wn)


@pytest.mark.parametrize("length,window", [(40, 32), (45, 27), (70, 30),
                                           (100, 5), (35, 30), (67, 30),
                                           (64, 17)])
def test_sharded_ring_partials_merge_to_the_whole_ring(length, window):
    """A 32-slot ring in 4 ranks' parts of 8 (blocks of 8, scale rows a
    rank's own): each rank's plain flat decode at its ring_slot_args,
    merged in rank order, against one kernel over the whole ring and the
    reference's Pallas kernel. The cases wrap the ring and leave a rank
    two runs (35 and 67 tokens at window 30: rank 0 keeps slots 0-2 and
    5-7), a rank none, or all."""
    ring = 32
    g = torch.Generator().manual_seed(length + window)
    kq = torch.randint(-127, 128, (B, HKV, ring, D), generator=g,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, HKV, ring, D), generator=g,
                       dtype=torch.int8)
    ks = torch.rand((B, HKV, ring // BS, D), generator=g) * 0.02 + 1e-3
    vs = torch.rand((B, HKV, ring // BS, D), generator=g) * 0.02 + 1e-3
    q = torch.randn((B, H, D), generator=g)
    i32 = lambda v: torch.full((B,), v, dtype=torch.int32)
    parts = []
    for r in range(4):
        ln, wn = ring_slot_args(length, window, ring, r * 8, 8)
        parts.append(flat_decode_partials_plain(
            q, kq[:, :, r * 8:(r + 1) * 8], ks[:, :, r:r + 1],
            vq[:, :, r * 8:(r + 1) * 8], vs[:, :, r:r + 1], i32(ln),
            i32(wn)))
    o, m, l = merge_rank_partials(*[torch.stack(x) for x in zip(*parts)])
    full = flat_decode_partials_plain(q, kq, ks, vq, vs, i32(length),
                                      i32(window))
    got = o / torch.clamp_min(l, 1e-30)
    np.testing.assert_allclose(got.numpy(), (full[0] / torch.clamp_min(
        full[2], 1e-30)).numpy(), atol=1e-6, rtol=1e-5)
    ref = RQA.quant_attention_decode_partials(
        jnp.asarray(q.numpy()), jnp.asarray(kq.numpy()),
        jnp.asarray(ks.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(vs.numpy()), jnp.full((B,), length, jnp.int32),
        window=window, impl="pallas_interpret")
    ro, _, rl = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(got.numpy(), ro / np.maximum(rl, 1e-30),
                               atol=1e-6, rtol=1e-5)
