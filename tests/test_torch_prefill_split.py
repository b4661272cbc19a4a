"""The paged prefill kernel's precision split, on the CPU.

The CUDA kernel runs its products on the tensor cores in bf16 and keeps the
float32 contract by splitting every float operand into three bf16 terms
(hi + mid + lo == x exactly): the queries times the page's K scale row and
the probabilities against the exact int8 / fp8_e4m3 / int4 codes (3
products), the chunk's own float32 K/V against split queries and
probabilities (6 products). `kernels.quant_prefill.paged_prefill_split_plain`
is that arithmetic in plain PyTorch, walked in the kernel's tiles (64 query
rows, min(64, ps) history keys inside a page, 32 chunk keys). Here it is
held, on every row below ``valid``,

- against the plain version (`paged_prefill_plain`), within the kernel's
  own tolerance on the card, |a - b| <= 1e-5 + 1e-4 |b| (float32: the sums
  run in another order);
- against the reference's Pallas kernel in interpret mode, within the same;

for the three page formats, pages smaller and larger than a history tile,
history walks of 0, 2 and all pages, and a partial ``valid``. A 64-row tile
whose positions are all at or past ``valid`` comes out exactly 0.0; every
other row is finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paging as RPG
from repro.core import quantization as RQ
from repro.kernels import quant_prefill as RQP
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import quant_prefill as QP
from torch_parity import to_torch

jax.config.update("jax_platform_name", "cpu")

DTYPES = ["int8", "fp8_e4m3", "int4"]
TOL = dict(atol=1e-5, rtol=1e-4)
HKV, G, D, C, NB = 2, 2, 16, 128, 4
H = HKV * G
# valid: the whole chunk / one token (lane tiles past 64 dead) / 70 / 64
# (the tile at positions 64..127 dead)
VALID = np.asarray([C, 1, 70, 64], np.int32)


def _hist_len(ps):
    return np.asarray([0, ps, 3 * ps - 3, NB * ps], np.int32)


def _inputs(kv_dtype, ps, seed=0):
    """numpy q/k/v of the chunk and a quantized pool of NB random pages a
    row behind a scrambled page table (page 0 the sentinel)."""
    rng = np.random.RandomState(seed)
    B = len(VALID)
    kh = rng.randn(B, HKV, NB * ps, D).astype(np.float32)
    vh = rng.randn(B, HKV, NB * ps, D).astype(np.float32)
    kq, ks = RQ.quantize_pages(jnp.asarray(kh), ps, kv_dtype)
    vq, vs = RQ.quantize_pages(jnp.asarray(vh), ps, kv_dtype)
    pk, pks, pv, pvs, table = (np.asarray(a) for a in
                               RPG.scatter_to_pool(kq, ks, vq, vs))
    perm = np.concatenate([[0], 1 + rng.permutation(len(pk) - 1)])
    pool = tuple(a[perm] for a in (pk, pks, pv, pvs))
    table = np.argsort(perm)[table].astype(np.int32)
    q = rng.randn(B, H, C, D).astype(np.float32)
    k = rng.randn(B, HKV, C, D).astype(np.float32)
    v = rng.randn(B, HKV, C, D).astype(np.float32)
    return q, k, v, pool, table


def _port_args(q, k, v, pool, table, ps, hist_blocks, kv_dtype):
    B = q.shape[0]
    qg = (to_torch(q).reshape(B, HKV, G * C, D)
          * QA.logit_scale(D)).contiguous()
    return (qg, to_torch(k), to_torch(v), *(to_torch(a) for a in pool),
            to_torch(table), to_torch(_hist_len(ps)), to_torch(VALID),
            hist_blocks, kv_dtype)


def _rows_below_valid(out):
    """(B, H_kv, G*C, D) -> per batch row, the rows below valid."""
    B = out.shape[0]
    o = out.reshape(B, H, C, D)
    return [o[b, :, :VALID[b]] for b in range(B)]


@pytest.mark.parametrize("hist_blocks", [0, 2, NB])
@pytest.mark.parametrize("ps", [8, 128], ids=["ps8", "ps128"])
@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_split_walk_matches_plain(kv_dtype, ps, hist_blocks):
    args = _port_args(*_inputs(kv_dtype, ps), ps, hist_blocks, kv_dtype)
    got = QP.paged_prefill_split_plain(*args)
    want = QP.paged_prefill_plain(*args)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    for g, w in zip(_rows_below_valid(got), _rows_below_valid(want)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_split_walk_matches_pallas_interpret(kv_dtype):
    ps = 8
    q, k, v, pool, table = _inputs(kv_dtype, ps, seed=3)
    ref = RQP.paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *(jnp.asarray(a) for a in pool), jnp.asarray(table),
        jnp.asarray(_hist_len(ps)), jnp.asarray(VALID), hist_blocks=NB,
        interpret=True, kv_dtype=kv_dtype)
    got = QP.paged_prefill_split_plain(
        *_port_args(q, k, v, pool, table, ps, NB, kv_dtype))
    ref = torch.from_numpy(np.array(ref)).reshape(got.shape)
    for g, r in zip(_rows_below_valid(got), _rows_below_valid(ref)):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_dead_row_tiles_are_zero(kv_dtype):
    ps = 8
    args = _port_args(*_inputs(kv_dtype, ps, seed=5), ps, NB, kv_dtype)
    out = QP.paged_prefill_split_plain(*args).reshape(len(VALID), H, C, D)
    # row 1 (valid 1): positions 64.. of each lane are a dead tile;
    # row 3 (valid 64): positions 64..127 too; row 2 (valid 70) has none
    for b in (1, 3):
        assert float(out[b, :, 64:].abs().max()) == 0.0
        assert float(out[b, :, :64].abs().max()) > 0.0
    assert bool((out[2].abs().sum(-1) > 0).all())
    assert bool(torch.isfinite(out).all())


def test_three_term_split_is_exact():
    """Exact down to |x| = 2^-110, where lo would leave float32's normal
    range (far below any logit, probability or value the kernel meets)."""
    rng = np.random.RandomState(0)
    sign = lambda n: rng.choice([-1.0, 1.0], n)
    x = torch.from_numpy(np.concatenate([
        rng.randn(4096), sign(256) * rng.uniform(1, 2, 256) * 2.0 ** -110,
        rng.randn(256) * 1e30,
        [0.0, -0.0, 1.0, -1.0, 1 / 3, 2.0 ** -126]]).astype(np.float32))
    hi, mid, lo = QP.split3(x)
    for t in (hi, mid, lo):               # each term a bf16 value
        assert torch.equal(t.bfloat16().float(), t)
    assert torch.equal(hi + mid + lo, x)  # and the three hold x exactly
    assert bool((mid.abs() <= hi.abs() * 2 ** -7).all())
    assert bool((lo.abs() <= mid.abs() * 2 ** -7).all())
