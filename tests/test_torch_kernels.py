"""The two paged kernels of the port.

On the CPU, each kernel's plain PyTorch version (what `ops` dispatches a
CPU tensor to) is held against the reference's Pallas kernel run in
interpret mode, on identical numpy inputs, across the ragged edges a
dispatch sees, for int8, fp8_e4m3 and int4 pages. Tolerance: float32
atol = rtol = 1e-5 — the summation order differs (one softmax over all
keys vs the kernel's page-by-page online softmax).

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # noqa: F401  (both frameworks in one process)

from repro.core import paging as RPG
from repro.core import quantization as RQ
from repro.kernels import quant_attention as RQA
from repro.kernels import quant_prefill as RQP
from repro_torch.kernels import ops
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import quant_prefill as QP
from torch_parity import to_torch

jax.config.update("jax_platform_name", "cpu")

DTYPES = ["int8", "fp8_e4m3", "int4"]
TOL = dict(atol=1e-5, rtol=1e-5)
HKV, G, D, PS = 2, 2, 16, 8
H = HKV * G


def _pool(kv_dtype, rows, n_blocks, seed):
    """A quantized pool holding ``rows`` x ``n_blocks`` random pages behind
    a scrambled page table (numpy arrays, page 0 the sentinel)."""
    rng = np.random.RandomState(seed)
    k = rng.randn(rows, HKV, n_blocks * PS, D).astype(np.float32)
    v = rng.randn(rows, HKV, n_blocks * PS, D).astype(np.float32)
    kq, ks = RQ.quantize_pages(jnp.asarray(k), PS, kv_dtype)
    vq, vs = RQ.quantize_pages(jnp.asarray(v), PS, kv_dtype)
    pk, pks, pv, pvs, table = (np.asarray(a) for a in
                               RPG.scatter_to_pool(kq, ks, vq, vs))
    perm = np.concatenate([[0], 1 + rng.permutation(len(pk) - 1)])
    inv = np.argsort(perm)
    pool = tuple(a[perm] for a in (pk, pks, pv, pvs))
    return pool, inv[table].astype(np.int32)


# -- paged decode partials --------------------------------------------------

NT = 4
LENGTHS = np.asarray([0, 1, PS - 1, PS, 2 * PS + 3, NT * PS], np.int32)


def _decode_inputs(kv_dtype, seed=0):
    pool, table = _pool(kv_dtype, len(LENGTHS), NT, seed)
    q = np.random.RandomState(seed + 1).randn(len(LENGTHS), H, D).astype(
        np.float32)
    return q, pool, table


@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_decode_plain_matches_pallas_interpret(kv_dtype):
    q, pool, table = _decode_inputs(kv_dtype)
    ref = RQA.paged_attention_decode_partials(
        jnp.asarray(q), *(jnp.asarray(a) for a in pool), jnp.asarray(table),
        jnp.asarray(LENGTHS), interpret=True, kv_dtype=kv_dtype)
    port = ops.paged_attention_decode_partials(
        to_torch(q), *(to_torch(a) for a in pool), to_torch(table),
        to_torch(LENGTHS), kv_dtype=kv_dtype)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL)
    # an empty row still writes its partials: o = 0, m = -1e30, l = 0
    o, m, l = port
    assert float(o[0].abs().max()) == 0.0 and float(l[0].max()) == 0.0
    assert (m[0].numpy() == np.float32(-1e30)).all()


# -- paged chunk prefill ----------------------------------------------------

C, NB = 16, 4
# hist_len: none / one page / a partial cursor / the pow2 boundary;
# valid: C / 1 / C-1 / C — all mixed inside one dispatch
HIST_LEN = np.asarray([0, PS, 2 * PS, NB * PS], np.int32)
VALID = np.asarray([C, 1, C - 1, C], np.int32)


def _prefill_inputs(kv_dtype, seed=0):
    pool, table = _pool(kv_dtype, len(HIST_LEN), NB, seed)
    rng = np.random.RandomState(seed + 1)
    q = rng.randn(len(HIST_LEN), H, C, D).astype(np.float32)
    k = rng.randn(len(HIST_LEN), HKV, C, D).astype(np.float32)
    v = rng.randn(len(HIST_LEN), HKV, C, D).astype(np.float32)
    return q, k, v, pool, table


@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("hist_blocks", [0, 1, 3, NB])
def test_prefill_plain_matches_pallas_interpret(kv_dtype, hist_blocks):
    q, k, v, pool, table = _prefill_inputs(kv_dtype)
    ref = RQP.paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *(jnp.asarray(a) for a in pool), jnp.asarray(table),
        jnp.asarray(HIST_LEN), jnp.asarray(VALID), hist_blocks=hist_blocks,
        interpret=True, kv_dtype=kv_dtype)
    port = ops.paged_attention_prefill(
        to_torch(q), to_torch(k), to_torch(v), *(to_torch(a) for a in pool),
        to_torch(table), to_torch(HIST_LEN), to_torch(VALID),
        hist_blocks=hist_blocks, kv_dtype=kv_dtype)
    for b in range(len(VALID)):        # positions past `valid` are garbage
        np.testing.assert_allclose(port[b, :, :VALID[b]].numpy(),
                                   np.asarray(ref)[b, :, :VALID[b]], **TOL)


def test_cpu_tensors_never_reach_the_cuda_launchers():
    q, pool, table = _decode_inputs("int8")
    with pytest.raises(ValueError, match="CUDA tensor"):
        QA.paged_decode_partials_cuda(
            to_torch(q), *(to_torch(a) for a in pool), to_torch(table),
            to_torch(LENGTHS))
    assert QA.paged_decode_partials_cuda.launches == 0
    assert QP.paged_prefill_cuda.launches == 0

