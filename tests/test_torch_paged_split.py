"""The paged decode kernel's split page walk (flash-decoding), on the CPU.

The CUDA kernel splits each row's page table into runs of ``pps`` entries,
attends each run alone and merges the runs' partials
(`kernels.quant_attention.merge_split_partials` is that merge in plain
PyTorch). Here the plain partials of each run, merged, are held

- against the unsplit plain version, within 1e-6 (float32: the merge
  rescales by e^(m_s - m), one rounding apart from the one-pass softmax);
- against the reference's Pallas kernel in interpret mode, within the
  1e-5 of tests/test_torch_kernels.py;

at lengths 0, 1, ps - 1, ps, ps + 1 and NT * ps, for int8, fp8_e4m3 and
int4 pages. A row of length 0 comes out exactly as the plain version's
(o = 0, m = -1e30, l = 0). The split count comes from shapes alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paging as RPG
from repro.core import quantization as RQ
from repro.kernels import quant_attention as RQA
from repro_torch.kernels import quant_attention as QA
from torch_parity import to_torch

jax.config.update("jax_platform_name", "cpu")

DTYPES = ["int8", "fp8_e4m3", "int4"]
HKV, G, D, PS, NT = 2, 2, 16, 8, 4
H = HKV * G
LENGTHS = np.asarray([0, 1, PS - 1, PS, PS + 1, NT * PS], np.int32)


def _inputs(kv_dtype, seed=0):
    """numpy q and a quantized pool of len(LENGTHS) x NT random pages
    behind a scrambled page table (page 0 the sentinel)."""
    rng = np.random.RandomState(seed)
    B = len(LENGTHS)
    k = rng.randn(B, HKV, NT * PS, D).astype(np.float32)
    v = rng.randn(B, HKV, NT * PS, D).astype(np.float32)
    kq, ks = RQ.quantize_pages(jnp.asarray(k), PS, kv_dtype)
    vq, vs = RQ.quantize_pages(jnp.asarray(v), PS, kv_dtype)
    pk, pks, pv, pvs, table = (np.asarray(a) for a in
                               RPG.scatter_to_pool(kq, ks, vq, vs))
    perm = np.concatenate([[0], 1 + rng.permutation(len(pk) - 1)])
    pool = tuple(a[perm] for a in (pk, pks, pv, pvs))
    table = np.argsort(perm)[table].astype(np.int32)
    q = rng.randn(B, H, D).astype(np.float32)
    return q, pool, table


def split_partials_plain(q, pool, table, lengths, kv_dtype, pps):
    """The kernel's walk in plain PyTorch: each run of ``pps`` page-table
    entries attended alone (the row's length clipped to the run), the
    runs' partials stacked as (B, H, n, D) and (B, H, n, 1)."""
    ps = pool[0].shape[1] * (2 if kv_dtype == "int4" else 1)
    n_t = table.shape[1]
    parts = []
    for p0 in range(0, n_t, pps):
        p1 = min(n_t, p0 + pps)
        run = torch.clamp(lengths - p0 * ps, 0, (p1 - p0) * ps)
        parts.append(QA.paged_decode_partials_plain(
            q, *pool, table[:, p0:p1].contiguous(), run.to(torch.int32),
            kv_dtype))
    return tuple(torch.stack(x, dim=2) for x in zip(*parts))


def _torch_inputs(kv_dtype):
    q, pool, table = _inputs(kv_dtype)
    return (to_torch(q), tuple(to_torch(a) for a in pool), to_torch(table),
            to_torch(LENGTHS))


@pytest.mark.parametrize("pps", [1, 2, 3, NT])
@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_split_walk_merged_equals_unsplit_plain(kv_dtype, pps):
    q, pool, table, lengths = _torch_inputs(kv_dtype)
    whole = QA.paged_decode_partials_plain(q, *pool, table, lengths,
                                           kv_dtype)
    merged = QA.merge_split_partials(
        *split_partials_plain(q, pool, table, lengths, kv_dtype, pps))
    for got, want in zip(merged, whole):
        assert got.shape == want.shape and got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    o, m, l = merged                        # length 0: exactly the plain's
    assert float(o[0].abs().max()) == 0.0 and float(l[0].max()) == 0.0
    assert bool((m[0] == whole[1][0]).all())


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_split_walk_merged_matches_pallas_interpret(kv_dtype):
    q, pool, table = _inputs(kv_dtype, seed=3)
    ref = RQA.paged_attention_decode_partials(
        jnp.asarray(q), *(jnp.asarray(a) for a in pool), jnp.asarray(table),
        jnp.asarray(LENGTHS), interpret=True, kv_dtype=kv_dtype)
    tq, tpool, ttab = to_torch(q), tuple(to_torch(a) for a in pool), \
        to_torch(table)
    merged = QA.merge_split_partials(*split_partials_plain(
        tq, tpool, ttab, to_torch(LENGTHS), kv_dtype, 1))
    for r, p in zip(ref, merged):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)


# (B, H_kv, G, NT, SMs) -> (splits, pages a split): two blocks an SM where
# the table allows, never less than one page a split
SPLITS = [((4, 8, 2, 8, 132), (8, 1)),     # the timed decode shape
          ((5, 8, 2, 8, 132), (4, 2)),
          ((20, 8, 2, 8, 132), (2, 4)),
          ((40, 8, 2, 8, 132), (1, 8)),    # enough rows: one split
          ((4, 8, 1, 8, 132), (8, 1)),
          ((4, 8, 3, 8, 132), (4, 2)),     # G = 3: two query pairs a head
          ((2, 2, 2, 16, 132), (16, 1))]


@pytest.mark.parametrize("shape,want", SPLITS)
def test_split_count_from_shapes_only(shape, want):
    assert QA.decode_splits(*shape) == want
    n, pps = want
    assert (n - 1) * pps < shape[3] <= n * pps
