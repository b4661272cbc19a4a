"""The port's serving stack against the reference's: `LLMEngine.generate`
in both packages (internlm2_1_8b smoke in float32, bridged weights, the
reference on its Pallas kernels in interpret mode) gives identical token
streams, finish reasons and scheduler ticks for 5 requests on 2 batch
rows — prompts with a partial page, several chunks, a mid-stream
admission, a stop token and a stop string. Plus: options that are not
ported raise, and entry points default to the card."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import internlm2_1_8b as ref_cfgs
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefLLMEngine
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import internlm2_1_8b as port_cfgs
from repro_torch.models import transformer as T
from repro_torch.serving import (ContinuousBatcher, EngineConfig, LLMEngine,
                                 SamplingParams)
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")

PROMPT_LENS = [13, 70, 5, 40, 21]      # partial page / 3 chunks / ...
MAX_NEW = [6, 9, 5, 7, 8]
ENGINE = dict(batch=2, max_len=128)


def _models():
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype="float32")
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype="float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


def _run_port(pcfg, pparams, prompts, stops):
    eng = LLMEngine(pparams, pcfg, EngineConfig(**ENGINE), device="cpu")
    outs = eng.generate(prompts, [SamplingParams.greedy(
        max_new_tokens=n, **s) for n, s in zip(MAX_NEW, stops)])
    return outs, eng.ticks, eng.pool_report()


def test_generate_matches_reference_engine(pallas_interpret):
    (rcfg, rparams), (pcfg, pparams) = _models()
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, rcfg.vocab, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    # pick stops from the port's own unstopped streams: request 3 stops on
    # the token it would emit third, request 4 on a string of its fourth
    free, _, _ = _run_port(pcfg, pparams, prompts, [{}] * 5)
    stops = [{}, {}, {},
             {"stop_token_ids": (free[3].token_ids[2],)},
             {"stop": (f"<{free[4].token_ids[3]}>",)}]
    outs, ticks, rep = _run_port(pcfg, pparams, prompts, stops)

    ref = RefLLMEngine(rparams, rcfg, RefEngineConfig(paged=True, **ENGINE))
    routs = ref.generate(prompts, [RefSamplingParams.greedy(
        max_new_tokens=n, **s) for n, s in zip(MAX_NEW, stops)])
    assert [o.token_ids for o in outs] == [o.token_ids for o in routs]
    assert [o.finish_reason for o in outs] == \
        [o.finish_reason for o in routs]
    assert ticks == ref.ticks
    assert outs[3].finish_reason == "stop_token"
    assert outs[4].finish_reason == "stop_string"
    assert outs[0].finish_reason == "length"
    rrep = ref.pool_report()
    for key in ("pages_total", "pages_free", "prefill_tokens_computed",
                "decode_tokens_computed"):
        assert rep[key] == rrep[key], key


@pytest.mark.parametrize("option", [
    dict(paged=False), dict(prefix_cache=True), dict(host_pages=8),
    dict(evictor="freq"), dict(host_tier_dtype="int4"), dict(watermark=2),
    dict(aging_ticks=4), dict(fault_injector=object()), dict(stall_ticks=50),
    dict(kv_cache_dtype=("int8", "int4")), dict(use_fused_prefill=False)])
def test_unported_engine_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EngineConfig(**option)


@pytest.mark.parametrize("option", [dict(temperature=0.7),
                                    dict(temperature=0.0, priority=2)])
def test_unported_sampling_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SamplingParams(**option)


def test_entry_points_default_to_the_card():
    cfg = port_cfgs.smoke()
    params = T.init_params(cfg, device="cpu")
    if torch.cuda.is_available():
        assert T.init_params(cfg)["embed"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(params, cfg, EngineConfig(**ENGINE))
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(params, cfg, EngineConfig(**ENGINE))
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "internlm2_1_8b", "--smoke"])


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "internlm2_1_8b", "--smoke", "--batch", "2",
                       "--max-len", "64", "--requests", "3",
                       "--prompt-len", "13", "--max-new", "4",
                       "--device", "cpu"]) == 0
    assert "completed 3/3 requests" in capsys.readouterr().out
