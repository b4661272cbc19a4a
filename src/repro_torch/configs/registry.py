"""Architecture registry of the port: the reference's ten architectures.

Dense full-attention stacks (``internlm2_1_8b``, ``llama3_2_3b``, and with
QKV bias ``codeqwen1_5_7b``, ``qwen2_5_32b`` and the M-RoPE text model
``qwen2_vl_2b``) and the MoE stack ``qwen2_moe_a2_7b``, served on both
cache backends; the sliding-window MoE ``mixtral_8x22b``, the RG-LRU /
local-attention hybrid ``recurrentgemma_9b`` and the xLSTM stack
``xlstm_350m``, served on the contiguous backend (as the reference's paged
backend, the port's refuses them); the encoder-decoder ``whisper_small``,
served through `serving.engine.make_serve_fns` with its frames (the
batchers feed tokens only, as the reference's).
"""
from __future__ import annotations

import importlib

ARCHS = ("internlm2_1_8b", "llama3_2_3b", "codeqwen1_5_7b", "qwen2_5_32b",
         "qwen2_moe_a2_7b", "mixtral_8x22b", "recurrentgemma_9b",
         "xlstm_350m", "qwen2_vl_2b", "whisper_small")


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCHS)}")
    return name


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke() if smoke else mod.config()


def all_configs(smoke: bool = False):
    return {a: get_config(a, smoke) for a in ARCHS}
