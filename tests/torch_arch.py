"""Helpers of the parity tests of the architectures the port serves beside
internlm2_1_8b (tests/test_torch_arch_*.py): the smoke models of both
packages in float32 with the reference's weights bridged, QKV biases drawn
non-zero in both trees (the reference's init draws zeros, so a test on it
would pass with the bias ignored), the RG-LRU gate vectors drawn per
channel in both trees (init draws constants: lam 2, w_a = w_x = 0.5,
b_a = b_x = 0, under which a channel permutation would pass), and the
serving protocol of tests/test_torch_serving.py run through either
package's `LLMEngine`."""
import dataclasses

import jax
import numpy as np

from repro.configs.registry import get_config as ref_get_config
from repro.models import transformer as RT
from repro.serving import EngineConfig as RefEngineConfig
from repro.serving import LLMEngine as RefLLMEngine
from repro.serving import SamplingParams as RefSamplingParams
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams

ARCHS = ("llama3_2_3b", "codeqwen1_5_7b", "qwen2_5_32b", "qwen2_moe_a2_7b")
# 5 requests on 2 rows: a partial page, several 8-token chunks, a
# mid-stream admission (tests/test_torch_serving.py)
PROMPT_LENS = [13, 70, 5, 40, 21]
MAX_NEW = [6, 9, 5, 7, 8]
BIAS_STD = 0.5
# RG-LRU gate vectors: (mean, std) of each channel's draw
RGLRU_GATES = {"lam": (2.0, 0.5), "w_a": (0.5, 0.25), "w_x": (0.5, 0.25),
               "b_a": (0.0, 0.25), "b_x": (0.0, 0.25)}


def seed_rglru_gates(rparams, seed: int = 3):
    """Every RG-LRU block's gate vectors (stacked groups and tail) drawn
    N(mean, std^2) per channel from a numpy seed, in place of init's
    constants."""
    rng = np.random.RandomState(seed)
    blocks = list(rparams["blocks"].values()) + list(rparams["tail"])
    for b in blocks:
        if "rglru" not in b:
            continue
        for name, (mean, std) in RGLRU_GATES.items():
            shape = b["rglru"][name].shape
            b["rglru"][name] = jax.numpy.asarray(
                (mean + std * rng.randn(*shape)).astype(np.float32))
    return rparams


def smoke_models(arch: str):
    """((reference cfg, params), (port cfg, params)) of ``arch``'s smoke
    config in float32; with QKV bias, bq / bk / bv seeded N(0, 0.5^2);
    with RG-LRU blocks, their gate vectors seeded (`seed_rglru_gates`)."""
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               dtype="float32")
    pcfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    rparams = RT.init_params(rcfg, jax.random.PRNGKey(0))
    if rcfg.qkv_bias:
        attn = rparams["blocks"]["p0"]["attn"]
        rng = np.random.RandomState(1)
        for name in ("bq", "bk", "bv"):
            attn[name] = jax.numpy.asarray(
                BIAS_STD * rng.randn(*attn[name].shape).astype(np.float32))
    if "rglru" in rcfg.block_pattern:
        seed_rglru_gates(rparams)
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams), pcfg,
                                "cpu")
    return (rcfg, rparams), (pcfg, pparams)


def prompts(vocab: int, seed: int = 7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def serve(engine_cls, config_cls, sampling_cls, params, cfg, paged: bool,
          **kw):
    """The protocol through one package: (engine, outputs)."""
    eng = engine_cls(params, cfg, config_cls(batch=2, max_len=128,
                                             paged=paged), **kw)
    outs = eng.generate(prompts(cfg.vocab), [
        sampling_cls.greedy(max_new_tokens=n) for n in MAX_NEW])
    return eng, outs


def serve_both(models, paged: bool):
    """(reference engine, its outputs), (port engine, its outputs)."""
    (rcfg, rparams), (pcfg, pparams) = models
    return (serve(RefLLMEngine, RefEngineConfig, RefSamplingParams, rparams,
                  rcfg, paged),
            serve(LLMEngine, EngineConfig, SamplingParams, pparams, pcfg,
                  paged, device="cpu"))
