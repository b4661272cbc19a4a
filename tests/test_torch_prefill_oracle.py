"""The dequantize-gather prefill oracle of the port against the
reference's: `PagedQuantizedKVCache.dequantized_prefix` bit for bit on
int8, fp8_e4m3 and int4 pools; `attention._chunk_attention` within
ORACLE_TOL of the reference's at history lengths 0, one page, a partial
cursor and the pow2 boundary; the port's fused path (the paged prefill
kernel's plain version) against its own oracle over every ragged edge in
one dispatch; the reference's stale-trace toggle protocol on the port's
scheduler; and a smoke `LLMEngine(EngineConfig(paged=True,
use_fused_prefill=False))` giving the reference's tokens, finish reasons
and pool_report."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import internlm2_1_8b as ref_cfgs
from repro.core import paging as RPG
from repro.core import quantization as RQ
from repro.models import attention as RA
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefLLMEngine
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import internlm2_1_8b as port_cfgs
from repro_torch.core import paging as PG
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.serving import (ContinuousBatcher, EngineConfig, LLMEngine,
                                 Request, SamplingParams)
from torch_parity import pallas_interpret, to_numpy, to_torch  # noqa: F401

jax.config.update("jax_platform_name", "cpu")

B, HKV, G, C, D, PS = 4, 2, 3, 16, 32, 8
NB = 4                       # history pages a row
H = HKV * G
# hist 0 / one page / a partial cursor / the pow2 boundary; valid C / 1 /
# C - 1 / C: every ragged edge in one dispatch (the reference's fixture)
HIST_LEN = np.asarray([0, PS, 2 * PS, NB * PS], np.int32)
VALID = np.asarray([C, 1, C - 1, C], np.int32)
# float32, the port's sums against XLA's: einsum orders differ (one
# softmax over up to 48 keys of O(1) logits)
ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed: int):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(B, H, C, D), f(B, HKV, C, D), f(B, HKV, C, D),
            f(B, HKV, NB * PS, D), f(B, HKV, NB * PS, D))


@functools.lru_cache(maxsize=None)
def _caches(kv_dtype: str, seed: int = 0, inputs: int = 0):
    """The same pool in both packages: the history of ``_inputs(inputs)``
    quantized by the reference's `quantize_pages`, its pages scattered
    and the table shuffled (page 0 the sentinel); (reference cache, port
    cache). Cached: a test that writes into the cache builds its own
    through ``_caches.__wrapped__``."""
    _, _, _, hk, hv = _inputs(inputs)
    quant = jax.jit(RQ.quantize_pages, static_argnums=(1, 2))
    kq, ks = quant(jnp.asarray(hk), PS, kv_dtype)
    vq, vs = quant(jnp.asarray(hv), PS, kv_dtype)
    pk, pks, pv, pvs, table = jax.jit(RPG.scatter_to_pool)(kq, ks, vq, vs)
    perm = np.random.RandomState(seed).permutation(B * NB) + 1
    inv = np.zeros(B * NB + 1, np.int64)
    inv[perm] = np.arange(1, B * NB + 1)
    pk, pks, pv, pvs = (a[np.concatenate([[0], inv[1:]])]
                        for a in (pk, pks, pv, pvs))
    table = perm.reshape(B, NB).astype(np.int32)
    lengths = HIST_LEN
    rpool = RPG.PagePool(k_q=pk, v_q=pv, k_s=pks, v_s=pvs,
                         free_stack=jnp.arange(pk.shape[0], dtype=jnp.int32),
                         n_free=jnp.asarray(0, jnp.int32), page_size=PS,
                         kv_dtype=kv_dtype)
    resid = jnp.zeros((B, HKV, PS, D), jnp.float32)
    ref = RPG.PagedQuantizedKVCache(rpool, jnp.asarray(table), resid,
                                    jnp.copy(resid), jnp.asarray(lengths))
    ppool = PG.PagePool(to_torch(pk), to_torch(pv), to_torch(pks),
                        to_torch(pvs), PS, kv_dtype)
    presid = torch.zeros((B, HKV, PS, D))
    port = PG.PagedQuantizedKVCache(ppool, torch.from_numpy(table), presid,
                                    presid.clone(),
                                    torch.from_numpy(lengths))
    return ref, port


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3", "int4"])
@pytest.mark.parametrize("n_blocks", [1, 3, NB])
def test_dequantized_prefix_bitwise(kv_dtype, n_blocks):
    ref, port = _caches(kv_dtype)
    for rdt, pdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jax.jit(lambda c: c.dequantized_prefix(n_blocks, rdt))(ref)
        got = port.dequantized_prefix(n_blocks, pdt)
        for g, w in zip(got, want):
            assert g.dtype == pdt and g.shape == w.shape
            np.testing.assert_array_equal(to_numpy(g), to_numpy(w))


@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["none", "one_page", "partial", "pow2"])
def test_chunk_attention_matches_reference(case, hist_dtype):
    """hist_len 0 with no history read (hk None), one page, a partial
    cursor inside a 3-page read, and every row at the pow2 boundary; the
    history dequantized in float32 or bf16 (the oracle's
    ``oracle_hist_dtype``)."""
    q, k, v, _, _ = _inputs(1)
    nb, hist = {"none": (0, np.zeros(B, np.int32)),
                "one_page": (1, np.minimum(HIST_LEN, PS)),
                "partial": (3, np.asarray([0, PS, 2 * PS + 3, 3 * PS],
                                          np.int32)),
                "pow2": (NB, HIST_LEN)}[case]
    ref, port = _caches("int8", seed=2, inputs=1)
    rdt, pdt = getattr(jnp, hist_dtype), getattr(torch, hist_dtype)
    rh = jax.jit(lambda c: c.dequantized_prefix(nb, rdt))(ref) if nb else \
        (None, None)
    ph = port.dequantized_prefix(nb, pdt) if nb else (None, None)
    want = jax.jit(RA._chunk_attention)(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), *rh,
                                        jnp.asarray(hist))
    got = A._chunk_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), *ph, torch.from_numpy(hist))
    assert got.dtype == torch.float32 and got.shape == (B, H, C, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ORACLE_TOL)


@pytest.mark.parametrize("hist_blocks", [0, 1, 3, NB])
def test_fused_prefill_matches_the_oracle(hist_blocks):
    """The port's fused path (the paged prefill kernel's plain version on
    the CPU) against its own oracle, as tests/test_quant_prefill.py holds
    the reference's: each row's valid chunk positions."""
    q, k, v, _, _ = _inputs(3)
    _, port = _caches("int8", seed=4, inputs=3)
    hist = np.minimum(HIST_LEN, hist_blocks * PS)
    pool = port.pool
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out = ops.paged_attention_prefill(
        qt, kt, vt, pool.k_q, pool.k_s, pool.v_q, pool.v_s, port.page_table,
        torch.from_numpy(hist), torch.from_numpy(VALID),
        hist_blocks=hist_blocks)
    hkv = port.dequantized_prefix(hist_blocks) if hist_blocks else \
        (None, None)
    want = A._chunk_attention(qt, kt, vt, *hkv, torch.from_numpy(hist))
    for b in range(B):
        np.testing.assert_allclose(out[b, :, :VALID[b]].numpy(),
                                   want[b, :, :VALID[b]].numpy(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hist_dtype", ["float32", "bfloat16"])
def test_prefill_chunk_oracle_matches_reference(hist_dtype):
    """`prefill_chunk(use_fused=False, oracle_hist_dtype=...)` on one
    layer's projections against the reference's: rows with 0, 1 and 2
    pages of history, the chunk written at each row's cursor; the merged
    output within ORACLE_TOL at every valid position; the chunk's pages
    by the page rule (its K/V differ from XLA's in ulps: scales within
    1e-6, codes within one step)."""
    cfgs = [dataclasses.replace(m.smoke(), dtype="float32", n_heads=H,
                                n_kv_heads=HKV, head_dim=D)
            for m in (ref_cfgs, port_cfgs)]
    rng = np.random.RandomState(6)
    d = cfgs[0].d_model
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, H * D)), ("wk", (d, HKV * D)),
                      ("wv", (d, HKV * D)), ("wo", (H * D, d)))}
    hist = np.minimum(HIST_LEN, 2 * PS)
    positions = (hist[:, None] + np.arange(C)).astype(np.int32)
    x = rng.standard_normal((B, C, d)).astype(np.float32)
    ref, port = _caches.__wrapped__("int8", seed=5, inputs=4)
    step = jax.jit(lambda p, x, pos, c, v: RA.prefill_chunk(
        p, x, cfgs[0], pos, c, hist_blocks=2, valid=v, use_fused=False,
        oracle_hist_dtype=getattr(jnp, hist_dtype)))
    want, ref = step({n: jnp.asarray(a) for n, a in w.items()},
                     jnp.asarray(x), jnp.asarray(positions), ref,
                     jnp.asarray(VALID))
    got, port = A.prefill_chunk(
        {n: torch.from_numpy(a) for n, a in w.items()}, torch.from_numpy(x),
        cfgs[1], torch.from_numpy(positions), port, hist_blocks=2,
        valid=torch.from_numpy(VALID), use_fused=False,
        oracle_hist_dtype=getattr(torch, hist_dtype))
    for b in range(B):
        np.testing.assert_allclose(got[b, :VALID[b]].numpy(),
                                   np.asarray(want)[b, :VALID[b]],
                                   **ORACLE_TOL)
    for r, g in ((ref.pool.k_s, port.pool.k_s), (ref.pool.v_s, port.pool.v_s)):
        np.testing.assert_allclose(to_numpy(g), to_numpy(r), rtol=1e-6)
    for r, g in ((ref.pool.k_q, port.pool.k_q), (ref.pool.v_q, port.pool.v_q)):
        diff = to_numpy(g).astype(np.int32) - to_numpy(r).astype(np.int32)
        assert np.abs(diff).max() <= 1


@functools.lru_cache(maxsize=None)
def _smoke():
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype="float32")
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype="float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(2))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


def _run_one(b, prompt, uid):
    b.submit(Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                     max_new_tokens=4))
    done = b.run_to_completion(max_ticks=400)
    assert len(done) == 1
    return done[0].generated


def test_fused_toggle_no_stale_trace():
    """The reference's protocol (tests/test_quant_prefill.py): the flag is
    part of the chunk step's key, so flipping it on a live scheduler
    builds a new step for the same hist_blocks buckets rather than
    serving the old one; greedy output is identical either way."""
    _, (cfg, params) = _smoke()
    assert EngineConfig().use_fused_prefill is True
    b = ContinuousBatcher(params, cfg, EngineConfig(
        batch=1, max_len=64, paged=True, prefill_chunk=8), device="cpu")
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, cfg.vocab, (29,)).astype(np.int32)
    got_fused = _run_one(b, prompt, 0)
    fused_keys = set(b._chunk_prefill_fns)
    assert fused_keys and all(f is True for _, f, _dt in fused_keys)
    b.config.use_fused_prefill = False
    got_oracle = _run_one(b, prompt, 1)
    oracle_keys = set(b._chunk_prefill_fns) - fused_keys
    assert oracle_keys and all(f is False for _, f, _dt in oracle_keys)
    assert {hb for hb, _, _ in oracle_keys} <= \
        {hb for hb, _, _ in fused_keys}
    assert got_fused == got_oracle


# a partial page, 3 chunks, a third request admitted mid-stream
PROMPT_LENS = [13, 40, 21]
MAX_NEW = [6, 7, 5]
ENGINE = dict(batch=2, max_len=128, paged=True, prefill_chunk=16,
              use_fused_prefill=False)


def test_oracle_engine_matches_reference(pallas_interpret):
    """A smoke `LLMEngine` serving through the oracle: the reference's
    greedy tokens, finish reasons and pool_report."""
    (rcfg, rparams), (pcfg, pparams) = _smoke()
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, rcfg.vocab, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    eng = LLMEngine(pparams, pcfg, EngineConfig(**ENGINE), device="cpu")
    outs = eng.generate(prompts, [SamplingParams.greedy(max_new_tokens=n)
                                  for n in MAX_NEW])
    ref = RefLLMEngine(rparams, rcfg, RefEngineConfig(**ENGINE))
    routs = ref.generate(prompts, [RefSamplingParams.greedy(
        max_new_tokens=n) for n in MAX_NEW])
    assert [o.token_ids for o in outs] == [o.token_ids for o in routs]
    assert [o.finish_reason for o in outs] == \
        [o.finish_reason for o in routs]
    rep, rrep = eng.pool_report(), ref.pool_report()
    counts = [k for k in rrep if not k.startswith("ttft_")]   # host clocks
    assert len(counts) > 10
    assert {k: rep[k] for k in counts} == {k: rrep[k] for k in counts}
    assert any(not f for _, f, _ in eng.batcher._chunk_prefill_fns)
