"""The contiguous backend and the reference generate path of the port
against the reference, on the CPU: internlm2_1_8b smoke in float32 with
bridged weights, the reference on its Pallas kernels in interpret mode.

- `greedy_generate` gives the reference's tokens, token for token, in
  per-block and per-channel mode, for a prompt with a remainder fed
  through decode and a prompt shorter than a block (nothing prefilled).
- `LLMEngine(EngineConfig(paged=False))` gives the reference's tokens,
  finish reasons and scheduler ticks for requests that force rebuilds
  (mid-stream admissions, left-padded re-prefill), with a stop token.
- The serve CLI runs on the CPU without ``--paged``, and `EngineConfig()`
  selects the same backend in both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import internlm2_1_8b as ref_cfgs
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefLLMEngine
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import engine as RE
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import internlm2_1_8b as port_cfgs
from repro_torch.core import quantization as Q
from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams,
                                 engine)
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


def _models(granularity="per_block"):
    from repro.core.quantization import QuantConfig as RefQuantConfig
    rcfg = dataclasses.replace(ref_cfgs.smoke(), dtype="float32")
    pcfg = dataclasses.replace(port_cfgs.smoke(), dtype="float32")
    if granularity == "per_channel":
        rcfg = dataclasses.replace(rcfg, quant=RefQuantConfig("per_channel"))
        pcfg = dataclasses.replace(pcfg, quant=Q.QuantConfig("per_channel"))
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


@pytest.mark.parametrize("granularity,S", [("per_block", 13),
                                           ("per_block", 5),
                                           ("per_channel", 13)])
def test_greedy_generate_matches_reference(pallas_interpret, granularity, S):
    (rcfg, rparams), (pcfg, pparams) = _models(granularity)
    prompts = np.random.RandomState(S).randint(
        0, rcfg.vocab, (2, S)).astype(np.int32)
    ref = RE.greedy_generate(rparams, rcfg, jnp.asarray(prompts), steps=7)
    port = engine.greedy_generate(pparams, pcfg, prompts, steps=7,
                                  device="cpu")
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


PROMPT_LENS = [13, 5, 20, 9]
MAX_NEW = [6, 9, 5, 7]
ENGINE = dict(batch=2, max_len=64)


def _run_port(pcfg, pparams, prompts, stops):
    eng = LLMEngine(pparams, pcfg, EngineConfig(**ENGINE), device="cpu")
    outs = eng.generate(prompts, [SamplingParams.greedy(
        max_new_tokens=n, **s) for n, s in zip(MAX_NEW, stops)])
    return outs, eng


def test_contiguous_engine_matches_reference(pallas_interpret):
    (rcfg, rparams), (pcfg, pparams) = _models()
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, rcfg.vocab, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    # request 2 stops on the token it would emit second (from the port's
    # own unstopped stream)
    free, _ = _run_port(pcfg, pparams, prompts, [{}] * 4)
    stops = [{}, {}, {"stop_token_ids": (free[2].token_ids[1],)}, {}]
    outs, eng = _run_port(pcfg, pparams, prompts, stops)
    assert not eng.batcher.paged
    ref = RefLLMEngine(rparams, rcfg, RefEngineConfig(**ENGINE))
    routs = ref.generate(prompts, [RefSamplingParams.greedy(
        max_new_tokens=n, **s) for n, s in zip(MAX_NEW, stops)])
    assert [o.token_ids for o in outs] == [o.token_ids for o in routs]
    assert [o.finish_reason for o in outs] == \
        [o.finish_reason for o in routs]
    assert outs[2].finish_reason == "stop_token"
    assert eng.ticks == ref.ticks
    assert eng.batcher.decode_tokens_computed == \
        ref.batcher.decode_tokens_computed
    rep = eng.pool_report()
    assert rep["ticks"] == ref.ticks
    assert set(ref.pool_report()) <= set(rep)


def test_engine_config_selects_the_reference_backend():
    assert EngineConfig().paged is RefEngineConfig().paged is False
    for option in (dict(kv_cache_dtype="int4"),
                   dict(kv_cache_dtype="fp8_e4m3")):
        with pytest.raises(ValueError, match="paged=True"):
            RefEngineConfig(**option)
        with pytest.raises(ValueError, match="paged=True"):
            EngineConfig(**option)
        assert EngineConfig(paged=True, **option).paged


def test_contiguous_submit_rejects_what_the_reference_rejects():
    from repro_torch.serving import ContinuousBatcher, Request
    (_, _), (pcfg, pparams) = _models()
    b = ContinuousBatcher(pparams, pcfg, EngineConfig(**ENGINE), device="cpu")
    with pytest.raises(ValueError, match="max_len"):   # padded 57 -> 64
        b.submit(Request(uid=0, prompt=np.zeros(57, np.int32),
                         max_new_tokens=1))
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(pparams, pcfg, EngineConfig(prefill_chunk=16,
                                                      **ENGINE), device="cpu")


def test_serve_cli_contiguous_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "internlm2_1_8b", "--smoke", "--batch", "2",
                       "--max-len", "64", "--requests", "3",
                       "--prompt-len", "13", "--max-new", "4",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "completed 3/3 requests" in out
    assert "contiguous int8 cache" in out
