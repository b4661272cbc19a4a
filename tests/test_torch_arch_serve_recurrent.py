"""The port's recurrent and sliding-window models (recurrentgemma_9b:
RG-LRU + local attention, pattern (rglru, rglru, local_attn) with a tail of
2; xlstm_350m: mLSTM / sLSTM; mixtral_8x22b: MoE with a sliding window)
against the reference on the contiguous backend, smoke configs in float32
with the reference's weights bridged and the RG-LRU gate vectors seeded
per channel (tests/torch_arch.py), the reference on its Pallas kernels in
interpret mode:

- `LLMEngine.generate` (tests/torch_arch.py's protocol: prompts of 13 to
  70 tokens, longer than the smoke window of 16, so the ring cache wraps
  in every rebuild) gives the reference's tokens, finish reasons and
  ticks;
- a paged engine raises the reference's `ValueError`, same text;
  tests/test_torch_arch_forward_recurrent.py holds the prefill and decode
  logits;
- the decode state has one entry per layer by kind (a ring of 16 slots
  for attention, RG-LRU / mLSTM / sLSTM states), updated in place;
- the bridge round-trips the reference tree (blocks p0..p{period-1} and
  the tail) leaf for leaf, and in bfloat16 keeps each leaf's dtype (the
  reference's float32 gate vectors, norms and router; bfloat16
  projections and conv)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefLLMEngine
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.checkpoint.bridge import params_from_numpy, tree_to_numpy
from repro_torch.core.kvcache import QuantizedKVCache
from repro_torch.core.tree import leaves
from repro_torch.models import rglru, xlstm
from repro_torch.models import transformer as T
from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
from test_torch_arch_serve import check_engines
from torch_arch import prompts, smoke_models
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("recurrentgemma_9b", "xlstm_350m", "mixtral_8x22b")
B, MAX_LEN = 2, 64


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(pallas_interpret, arch):
    check_engines(smoke_models(arch), paged=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_refuses_like_reference(arch):
    (rcfg, rparams), (pcfg, pparams) = smoke_models(arch)
    errors = []
    for eng_cls, cfg_cls, sp_cls, params, cfg, kw in (
            (RefLLMEngine, RefEngineConfig, RefSamplingParams, rparams, rcfg,
             {}),
            (LLMEngine, EngineConfig, SamplingParams, pparams, pcfg,
             {"device": "cpu"})):
        eng = eng_cls(params, cfg, cfg_cls(batch=2, max_len=64, paged=True),
                      **kw)
        with pytest.raises(ValueError) as e:
            eng.generate(prompts(cfg.vocab)[:1],
                         sp_cls.greedy(max_new_tokens=2))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[1].startswith("paged serving supports full-attention "
                                "stacks only")
    with pytest.raises(ValueError, match="full-attention stacks only"):
        T.init_decode_state(pcfg, B, MAX_LEN, paged=True, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_by_kind(arch):
    (rcfg, _), (pcfg, _) = smoke_models(arch)
    state = T.init_decode_state(pcfg, B, MAX_LEN, device="cpu")
    assert len(state) == pcfg.n_layers
    want = {"rglru": rglru.RGLRUState, "mlstm": xlstm.MLSTMState,
            "slstm": xlstm.SLSTMState}
    for i, entry in enumerate(state):
        kind = pcfg.block_kind(i)
        if kind in T.ATTN_KINDS:
            # a ring of the window's block-rounded length (16 < 64)
            assert isinstance(entry, QuantizedKVCache) and entry.ring
            assert entry.max_len == 16 and entry.k_q.shape[1] == \
                pcfg.n_kv_heads
        else:
            assert type(entry) is want[kind], (i, kind)
    if arch == "xlstm_350m":
        m = state[0]
        dh = pcfg.d_model // pcfg.n_heads
        assert m.C.dtype == torch.float32 and m.C.shape == (
            B, pcfg.n_heads, dh, dh)
        assert float(m.m.max()) == float(np.float32(-1e30))
    if arch == "recurrentgemma_9b":
        # layers 3 and 4 are the tail (rglru, rglru); layer 2 local_attn
        assert [pcfg.block_kind(i) for i in range(5)] == [
            "rglru", "rglru", "local_attn", "rglru", "rglru"]
        assert state[4].conv.shape == (B, pcfg.conv1d_width - 1,
                                       pcfg.rnn_width)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_pattern_and_tail(arch):
    (rcfg, rparams), (pcfg, pparams) = smoke_models(arch)
    period, n_groups, tail = T.pattern_layout(pcfg)
    assert (period, n_groups, tail) == RT._pattern_layout(rcfg)
    assert len(pparams["layers"]) == pcfg.n_layers
    for i, layer in enumerate(pparams["layers"]):
        kind = pcfg.block_kind(i)
        mixer = "attn" if kind in T.ATTN_KINDS else kind
        assert mixer in layer, (i, kind, sorted(layer))
    back = tree_to_numpy(pparams, pcfg)
    ref = jax.tree.map(np.asarray, rparams)
    assert sorted(back["blocks"]) == sorted(ref["blocks"]) == [
        f"p{i}" for i in range(period)]
    assert len(back["tail"]) == len(ref["tail"]) == tail
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32),
                                      err_msg=str(path))
    if arch == "recurrentgemma_9b":
        # seeded per channel, not init's constants
        assert float(pparams["layers"][3]["rglru"]["lam"].std()) > 0.1
    # in the configs' own bfloat16, every leaf keeps the reference's dtype
    # (float32 gate vectors, norms, router; bfloat16 projections and conv)
    rcfg16, pcfg16 = (dataclasses.replace(c, dtype="bfloat16")
                      for c in (rcfg, pcfg))
    r16 = RT.init_params(rcfg16, jax.random.PRNGKey(0))
    p16 = params_from_numpy(jax.tree.map(np.asarray, r16), pcfg16, "cpu")
    stacked = T.stack_layers(p16, period)
    stacked.setdefault("tail", [])
    got = [str(t.dtype).split(".")[1] for t in leaves(stacked)]
    want = [np.dtype(a.dtype).name for a in jax.tree.leaves(r16)]
    assert got == want
    assert "bfloat16" in got and "float32" in got
