"""The port's whisper_small (`models/encdec.py`) against the reference's,
smoke, float32, the reference's weights bridged, frames from each
package's `make_frames` (equal arrays), the reference on its Pallas
kernels in interpret mode:

- `make_frames` equal; the bridge keeps every weight of the encoder and
  decoder stacks (LayerNorm scales and biases, ``norm_x``, ``enc_norm``
  float32) and `tree_to_numpy` gives the reference's tree back;
- `encode` within atol 1e-5 and `forward_train` logits within 1e-5
  (float32, other summation orders: measured 1.7e-6 and 2.7e-7 on jax
  0.9.0 and torch 2.13.0 on the CPU);
- `make_serve_fns`: prefill with the reference's ``{"frames",
  "tokens"}`` batch, then 12 greedy decode steps (the self cache flushes
  a block at step 8): logits within atol 2e-3 (an int8 value one step
  apart moves them, tests/test_torch_arch_forward.py), tokens identical;
  the cross caches' int8 bytes within the page rule and scales within
  1e-5 relative (their K/V come from the float32 encoder output, equal to
  a few ulps), ``length`` / ``valid_len`` equal (24 / 24 over 24 slots;
  the full config's 1500 over 1504); the self caches within the page
  rule after the flush, lengths equal; fed the reference's own cross K/V,
  the port's padded per-channel prefill gives its bytes and scales bit
  for bit;
- the decode step's sinusoid rows: the angles bit for bit against the
  reference's 131072-row table's, the rows equal to the port's own table
  at those positions and within 2^-22 of the reference's (XLA's and
  torch's float32 sin / cos differ in the last bits);
- the reference's refusals: paged and a non-int8 dtype (`make_serve_fns`),
  chunk prefill; the batcher, `generate` and the serve CLI refuse with a
  named `ValueError` (the reference's batcher fails on the missing
  frames) and the paged batcher with the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.core import kvcache as RKV
from repro.data import DataConfig as RefDataConfig
from repro.data import make_frames as ref_make_frames
from repro.models import attention as RA
from repro.models import common as RC
from repro.models import encdec as RE
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefLLMEngine
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving.engine import make_serve_fns as ref_make_serve_fns
from repro_torch.checkpoint.bridge import params_from_numpy, tree_to_numpy
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, make_frames
from repro_torch.models import encdec as PE
from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
from repro_torch.serving.engine import (generate, make_chunk_prefill_fn,
                                        make_serve_fns)
from test_torch_mixed_plan import INT8_STEP_FRAC
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper_small"
B, S, MAX_LEN, STEPS = 2, 16, 32, 12
ATOL = 2e-3
NAMED = "is an encoder-decoder model"
PAGED = "paged serving is decoder-only"


@pytest.fixture(scope="module")
def models():
    rcfg = dataclasses.replace(ref_get_config(ARCH, smoke=True),
                               dtype="float32")
    pcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    rparams = RE.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


def _frames(cfg):
    return make_frames(DataConfig(seq_len=S, global_batch=B,
                                  vocab=cfg.vocab), cfg.d_model,
                       cfg.encoder_seq)


def _tokens(cfg):
    return np.random.RandomState(3).randint(0, cfg.vocab,
                                            (B, S)).astype(np.int32)


def _close_int8(x, y, label):
    """The page rule: values at most one step apart in at most
    INT8_STEP_FRAC of the places."""
    d = np.abs(np.asarray(x).astype(np.int32) - np.asarray(y).astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= INT8_STEP_FRAC, (label, d.mean())


def _ref_layer(cache, layer):
    """One layer of the reference's stacked cache."""
    return jax.tree.map(lambda a: a[layer], cache)


def test_make_frames_and_bridge(models):
    (rcfg, rparams), (pcfg, pparams) = models
    for kw in (dict(seed=0), dict(seed=5, shard_id=1, num_shards=2)):
        np.testing.assert_array_equal(
            make_frames(DataConfig(seq_len=8, global_batch=4, vocab=256,
                                   **kw), 64, 24, step=3),
            ref_make_frames(RefDataConfig(seq_len=8, global_batch=4,
                                          vocab=256, **kw), 64, 24, step=3))
    assert len(pparams["enc_layers"]) == rcfg.n_encoder_layers
    assert len(pparams["dec_layers"]) == rcfg.n_layers
    assert sorted(pparams["dec_layers"][0]) == sorted(rparams["dec_blocks"])
    back = tree_to_numpy(pparams, pcfg)
    flat_r = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, rparams))[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_r) == len(flat_p)
    for path, leaf in flat_r:
        np.testing.assert_array_equal(flat_p[path], leaf, str(path))
    # what the reference keeps float32 in a bf16 model stays float32
    bf = params_from_numpy(jax.tree.map(np.asarray, RE.init_params(
        ref_get_config(ARCH, smoke=True), jax.random.PRNGKey(1))),
        get_config(ARCH, smoke=True), "cpu")
    dec = bf["dec_layers"][0]
    assert dec["norm_x"]["bias"].dtype == bf["enc_norm"]["scale"].dtype == \
        bf["final_norm"]["bias"].dtype == torch.float32
    assert dec["cross_attn"]["wq"].dtype == bf["embed"].dtype == \
        torch.bfloat16
    assert sorted(PE.init_params(get_config(ARCH, smoke=True),
                                 device="cpu")) == sorted(bf)


def test_encode_and_forward_train_match(models):
    (rcfg, rparams), (pcfg, pparams) = models
    frames, toks = _frames(pcfg), _tokens(pcfg)
    want = RE.encode(rparams, jnp.asarray(frames), rcfg, remat=False)
    got = PE.encode(pparams, torch.from_numpy(frames), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want, _ = RE.forward_train(rparams, jnp.asarray(frames),
                               jnp.asarray(toks), rcfg, remat=False)
    got, aux = PE.forward_train(pparams, torch.from_numpy(frames),
                                torch.from_numpy(toks), pcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    assert float(aux) == 0.0


def test_serve_fns_match_reference(pallas_interpret, models):
    (rcfg, rparams), (pcfg, pparams) = models
    frames, toks = _frames(pcfg), _tokens(pcfg)
    r_init, r_prefill, r_decode = ref_make_serve_fns(rcfg, max_len=MAX_LEN)
    p_init, p_prefill, p_decode = make_serve_fns(pcfg, max_len=MAX_LEN,
                                                 device="cpu")
    rl, rs = jax.jit(r_prefill)(rparams, {"frames": jnp.asarray(frames),
                                          "tokens": jnp.asarray(toks)},
                                r_init(B))
    pl, ps = p_prefill(pparams, {"frames": torch.from_numpy(frames),
                                 "tokens": torch.from_numpy(toks)}, p_init(B))
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=ATOL)
    enc_len = PE.enc_cache_len(pcfg)
    for layer in range(pcfg.n_layers):
        rc, pc = _ref_layer(rs["cross"], layer), ps["cross"][layer]
        assert pc.k_q.shape[2] == rc.k_q.shape[2] == enc_len
        assert pc.length == int(rc.length) == pcfg.encoder_seq
        assert pc.valid_len == int(rc.valid_len) == pcfg.encoder_seq
        for name in ("k_q", "v_q"):
            _close_int8(getattr(rc, name), getattr(pc, name).numpy(),
                        f"cross {layer} {name}")
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(getattr(pc, name).numpy(),
                                       np.asarray(getattr(rc, name)),
                                       rtol=1e-5, atol=0)
    r_dec = jax.jit(r_decode)
    rtok = np.asarray(jnp.argmax(rl[:, :rcfg.vocab], -1), np.int32)
    ptok = pl[:, :pcfg.vocab].argmax(-1).numpy().astype(np.int32)
    pos = np.full((B,), S, np.int32)
    for j in range(STEPS):
        np.testing.assert_array_equal(ptok, rtok, f"step {j}")
        rl, rs = r_dec(rparams, jnp.asarray(rtok[:, None]), rs,
                       jnp.asarray(pos))
        pl, ps = p_decode(pparams, torch.from_numpy(ptok[:, None]), ps,
                          torch.from_numpy(pos))
        assert pl.dtype == torch.float32
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=ATOL,
                                   err_msg=f"step {j}")
        rtok = np.asarray(jnp.argmax(rl[:, :rcfg.vocab], -1), np.int32)
        ptok = pl[:, :pcfg.vocab].argmax(-1).numpy().astype(np.int32)
        pos = pos + 1
    assert S + STEPS > 3 * pcfg.quant.block_size     # a block flushed
    for layer in range(pcfg.n_layers):
        rc, pc = _ref_layer(rs["self"], layer), ps["self"][layer]
        assert pc.length == int(rc.length) == S + STEPS
        for name in ("k_q", "v_q"):
            _close_int8(getattr(rc, name), getattr(pc, name).numpy(),
                        f"self {layer} {name}")
        for name in ("k_s", "v_s"):
            np.testing.assert_allclose(getattr(pc, name).numpy(),
                                       np.asarray(getattr(rc, name)),
                                       rtol=1e-5, atol=0)
        # the cross caches are written once, at prefill
        assert ps["cross"][layer].length == pcfg.encoder_seq


def test_cross_cache_prefill_bitwise(models):
    """The reference's cross K/V of one layer through both packages'
    padded per-channel prefill (the reference's compiled): bytes and
    scales bit for bit, the full config's 1504 slots for its 1500
    frames."""
    (rcfg, rparams), (pcfg, _) = models
    assert PE.enc_cache_len(get_config(ARCH)) == 1504
    x = jnp.asarray(np.random.RandomState(4).randn(B, S, rcfg.d_model)
                    .astype(np.float32))
    enc = RE.encode(rparams, jnp.asarray(_frames(pcfg)), rcfg, remat=False)
    bp = jax.tree.map(lambda a: a[0], rparams["dec_blocks"])
    _, (ck, cv) = RA.cross_train(bp["cross_attn"],
                                 RC.layernorm(bp["norm_x"], x), enc, rcfg)
    for T_enc in (PE.enc_cache_len(pcfg), 40):
        qcfg = dataclasses.replace(rcfg.quant, granularity="per_channel")
        rc = jax.jit(lambda k, v: dataclasses.replace(
            RKV.QuantizedKVCache.init(B, rcfg.n_kv_heads, T_enc,
                                      rcfg.head_dim, qcfg).prefill(
                RE._pad_t(k, T_enc), RE._pad_t(v, T_enc)),
            length=jnp.asarray(k.shape[2], jnp.int32)))(ck, cv)
        pc = dataclasses.replace(pcfg, encoder_seq=T_enc)
        pc = PE.init_decode_state(pc, B, MAX_LEN, device="cpu")["cross"][0]
        k, v = (torch.from_numpy(np.array(a)) for a in (ck, cv))
        pc.prefill(PE._pad_t(k, T_enc), PE._pad_t(v, T_enc))
        pc.length = k.shape[2]
        for name in ("k_q", "v_q", "k_s", "v_s"):
            np.testing.assert_array_equal(getattr(pc, name).numpy(),
                                          np.asarray(getattr(rc, name)),
                                          f"T {T_enc} {name}")
        assert pc.valid_len == int(rc.valid_len) == k.shape[2]


def test_sinusoid_rows():
    d = 64
    table = RE._sinusoid(1 << 17, d)[0]
    pos = np.array([0, 1, 17, 1499, 70001, (1 << 17) - 1], np.int32)
    rows = PE.sinusoid_rows(torch.from_numpy(pos), d).numpy()
    np.testing.assert_array_equal(
        rows, PE._sinusoid(1 << 17, d, "cpu")[0].numpy()[pos])
    np.testing.assert_allclose(rows, np.asarray(table)[pos], atol=2.0 ** -22,
                               rtol=0)
    dim = jnp.arange(0, d, 2, dtype=jnp.float32)[None]
    ref_ang = np.asarray(jnp.asarray(pos, jnp.float32)[:, None]
                         / jnp.power(10000.0, dim / d))
    port_ang = (torch.from_numpy(pos).float()[:, None] / torch.pow(
        torch.tensor(10000.0), torch.arange(0, d, 2).float() / d)).numpy()
    np.testing.assert_array_equal(port_ang, ref_ang)


def test_refusals_match_reference(models):
    (rcfg, rparams), (pcfg, pparams) = models
    for make, cfg in ((ref_make_serve_fns, rcfg),
                      (lambda c, **kw: make_serve_fns(c, device="cpu", **kw),
                       pcfg)):
        with pytest.raises(ValueError, match=PAGED):
            make(cfg, max_len=MAX_LEN, paged=True)
        with pytest.raises(ValueError, match="a paged-backend feature"):
            make(cfg, max_len=MAX_LEN, kv_cache_dtype="int4")
    with pytest.raises(ValueError, match="chunked prefill is decoder-only"):
        make_chunk_prefill_fn(pcfg)
    prompts = [np.arange(1, 9, dtype=np.int32)]
    sp = SamplingParams.greedy(max_new_tokens=2)
    # the reference: the paged batcher refuses at construction, the
    # contiguous one fails at its first prefill on the missing frames
    with pytest.raises(ValueError, match=PAGED):
        RefLLMEngine(rparams, rcfg, RefEngineConfig(batch=2, max_len=MAX_LEN,
                                                    paged=True))
    with pytest.raises(KeyError, match="frames"):
        RefLLMEngine(rparams, rcfg, RefEngineConfig(
            batch=2, max_len=MAX_LEN)).generate(
            prompts, RefSamplingParams.greedy(max_new_tokens=2))
    # the port: the paged batcher with the reference's error, the
    # contiguous one, generate and the CLI with the named one
    with pytest.raises(ValueError, match=PAGED):
        LLMEngine(pparams, pcfg, EngineConfig(batch=2, max_len=MAX_LEN,
                                              paged=True), device="cpu")
    with pytest.raises(ValueError, match=NAMED):
        LLMEngine(pparams, pcfg, EngineConfig(batch=2, max_len=MAX_LEN),
                  device="cpu").generate(prompts, sp)
    with pytest.raises(ValueError, match=NAMED):
        generate(pparams, pcfg, np.stack(prompts), steps=2, device="cpu")
    from repro_torch.launch import serve
    argv = ["--arch", "whisper-small", "--smoke", "--batch", "2",
            "--max-len", "32", "--requests", "2", "--prompt-len", "8",
            "--max-new", "2", "--device", "cpu"]
    with pytest.raises(ValueError, match=NAMED):
        serve.main(argv)
    with pytest.raises(ValueError, match=PAGED):
        serve.main(argv + ["--paged"])
