"""The port's model on llama3_2_3b, codeqwen1_5_7b, qwen2_5_32b and
qwen2_moe_a2_7b (smoke, float32, non-zero QKV biases, the reference's
weights bridged) against `repro.models.transformer`, the reference on its
Pallas kernels in interpret mode:

- the bridge keeps every weight: attention with its biases, the MLP or
  the MoE (router, stacked experts, shared experts and their gate);
- paged: two prompt chunks (the second over the first's pages, ending in
  a partial page) and one decode step give logits within atol 2e-3, the
  pages within the page rule; contiguous: a prompt prefill and one decode
  step likewise. Float32 sums run in other orders, so a K or V value on
  an int8 rounding boundary may land one step apart (the page rule), and
  the chunk and step that read it move by more than rounding: measured
  (jax 0.9.0, torch 2.13.0 on the CPU) 3.5e-4 on codeqwen's second chunk
  with 9 values one step apart in layer 1, 1.6e-3 on qwen2_moe's decode
  step in the row that reads such a page (1.2e-6 in the other row; the
  routing margins there are 3e-3 and more, no expert changes), 2.6e-6
  where no value differs (llama);
- `kv_cache_memory_report` of each full config (MHA pools at H_kv 32 and
  16 included) equals the reference's;
- the entry points serve these configs and train them (the train CLI,
  two smoke steps, finite losses; tests/test_torch_train_families.py holds
  the steps against the reference's); M-RoPE serves on both backends
  (tests/test_torch_vlm.py holds qwen2_vl_2b); a sliding window serves
  from the contiguous ring and the paged backend refuses it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models import transformer as RT
from repro.serving import engine as RE
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serving import kv_cache_memory_report
from test_mixed_precision_plan import _layer_cache as ref_layer_cache
from test_torch_mixed_plan import assert_pages_close
from torch_arch import ARCHS, smoke_models
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")

B, MAX_LEN, C = 2, 64, 16
N_PAGES = B * MAX_LEN // 8 + 1
ATOL = 2e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_every_weight(arch):
    (rcfg, rparams), (pcfg, pparams) = smoke_models(arch)
    ref = _flat(rparams["blocks"]["p0"])
    for i, layer in enumerate(pparams["layers"]):
        port = _flat(layer)
        assert sorted(port) == sorted(ref)
        for name, t in port.items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(ref[name][i]), name)
    names = set(ref)
    if rcfg.qkv_bias:          # seeded in both trees, not init's zeros
        assert {"attn/bq", "attn/bk", "attn/bv"} <= names
        assert float(np.asarray(ref["attn/bq"]).std()) > 0.1
    if rcfg.family == "moe":
        assert {"moe/router", "moe/w_gate", "moe/shared/w_up",
                "moe/shared_gate"} <= names and "mlp/w_up" not in names
        assert pparams["layers"][0]["moe"]["w_gate"].shape == (
            rcfg.n_experts, rcfg.d_model, rcfg.moe_d_ff)
        assert pparams["layers"][0]["moe"]["router"].dtype == torch.float32


def _paged_states(rcfg, pcfg):
    table = (1 + np.random.RandomState(0).permutation(N_PAGES - 1)).reshape(
        B, -1).astype(np.int32)
    rstate = RT.init_decode_state(rcfg, B, MAX_LEN, paged=True,
                                  n_pages=N_PAGES)
    rstate["p0"] = dataclasses.replace(
        rstate["p0"], page_table=jnp.broadcast_to(
            jnp.asarray(table), rstate["p0"].page_table.shape))
    pstate = T.init_decode_state(pcfg, B, MAX_LEN, paged=True,
                                 n_pages=N_PAGES, device="cpu")
    for c in pstate:
        c.page_table = torch.from_numpy(table)
    return rstate, pstate


def _decode_both(rp, pp, rcfg, pcfg, rs, ps, rl, pos):
    tok = np.array(jnp.argmax(rl[:, :rcfg.vocab], -1), np.int32)[:, None]
    rl, rs = RT.decode_step(rp, jnp.asarray(tok), rcfg, rs, jnp.asarray(pos))
    pl, ps = T.decode_step(pp, torch.from_numpy(tok), pcfg, ps,
                           torch.from_numpy(pos))
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_match(pallas_interpret, arch):
    (rcfg, rp), (pcfg, pp) = smoke_models(arch)
    rs, ps = _paged_states(rcfg, pcfg)
    toks = np.random.RandomState(1).randint(
        0, rcfg.vocab, (2, B, C)).astype(np.int32)
    chunks = [(np.zeros(B, np.int32), np.full(B, C, np.int32), 0),
              (np.full(B, C, np.int32), np.asarray([C, 5], np.int32), 2)]
    mask = np.ones(B, bool)
    for (start, valid, hb), tk in zip(chunks, toks):
        rl, rs = RT.prefill_chunk(rp, jnp.asarray(tk), rcfg, rs,
                                  start=jnp.asarray(start),
                                  row_mask=jnp.asarray(mask), hist_blocks=hb,
                                  valid=jnp.asarray(valid))
        pl, ps = T.prefill_chunk(pp, torch.from_numpy(tk), pcfg, ps,
                                 start=torch.from_numpy(start),
                                 row_mask=torch.from_numpy(mask),
                                 hist_blocks=hb,
                                 valid=torch.from_numpy(valid))
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=ATOL)
    for layer in range(rcfg.n_layers):
        assert_pages_close(ref_layer_cache(rs, layer).pool, ps[layer].pool,
                           "int8", f"layer {layer}")
    pos = (chunks[1][0] + chunks[1][1]).astype(np.int32)
    _decode_both(rp, pp, rcfg, pcfg, rs, ps, rl, pos)


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_prefill_and_decode_match(pallas_interpret, arch):
    (rcfg, rp), (pcfg, pp) = smoke_models(arch)
    S = 24                              # three 8-token blocks
    rs = RT.init_decode_state(rcfg, B, MAX_LEN)
    ps = T.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
    toks = np.random.RandomState(2).randint(
        0, rcfg.vocab, (B, S)).astype(np.int32)
    rl, rs = RT.prefill(rp, jnp.asarray(toks), rcfg, rs)
    pl, ps = T.prefill(pp, torch.from_numpy(toks), pcfg, ps)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), atol=ATOL)
    _decode_both(rp, pp, rcfg, pcfg, rs, ps, rl, np.full(B, S, np.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_report_matches_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for batch, seq in ((128, 32_768), (4, 2048)):
        assert kv_cache_memory_report(cfg, batch, seq) == \
            RE.kv_cache_memory_report(rcfg, batch, seq)


def test_entry_points_serve_and_refuse():
    from repro_torch.launch import train
    for arch in ARCHS + ("internlm2_1_8b",):
        cfg = get_config(arch, smoke=True)
        T.check_servable(cfg)
        losses = []
        assert train.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "16"],
                          on_step=lambda i, m, s: losses.append(
                              m["loss"])) == 0
        assert len(losses) == 2 and np.isfinite(losses).all()
    # a sliding window serves from the contiguous ring, not from pages
    window = dataclasses.replace(get_config("qwen2_moe_a2_7b", smoke=True),
                                 sliding_window=16)
    T.init_params(window, device="cpu")
    with pytest.raises(ValueError, match="full-attention stacks only"):
        T.check_servable(window, paged=True)
    # M-RoPE serves, on both backends (qwen2_vl_2b's text mode)
    mrope = dataclasses.replace(get_config("qwen2_moe_a2_7b", smoke=True),
                                mrope_sections=(2, 3, 3))
    params = T.init_params(mrope, device="cpu")
    for paged in (False, True):
        state = T.init_decode_state(mrope, 2, 64, paged=paged, device="cpu")
        logits, _ = T.prefill_chunk(
            params, torch.zeros((2, 8), dtype=torch.long), mrope, state,
            start=torch.zeros((2,), dtype=torch.int32)) if paged else \
            T.prefill(params, torch.zeros((2, 8), dtype=torch.long), mrope,
                      state)
        assert logits.shape == (2, T.padded_vocab(mrope))
        assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_each_arch(arch, capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", arch.replace("_", "-"), "--smoke",
                       "--batch", "2", "--max-len", "64", "--requests", "3",
                       "--prompt-len", "13", "--max-new", "4", "--paged",
                       "--device", "cpu"]) == 0
    assert "completed 3/3 requests" in capsys.readouterr().out
