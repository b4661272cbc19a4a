"""Architecture registry of the port: the configs ported so far.

The five architectures the paged serving path accepts: dense
full-attention stacks (``internlm2_1_8b``, ``llama3_2_3b``, and with QKV
bias ``codeqwen1_5_7b`` and ``qwen2_5_32b``) and the MoE stack
``qwen2_moe_a2_7b``. The reference's other five wait on ROADMAP queue 1:
``mixtral_8x22b`` on item 13 (its sliding window), the rest on item 15.
"""
from __future__ import annotations

import importlib

ARCHS = ("internlm2_1_8b", "llama3_2_3b", "codeqwen1_5_7b", "qwen2_5_32b",
         "qwen2_moe_a2_7b")


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; ported: "
                       f"{list(ARCHS)} (ROADMAP queue 1, items 13 and 15)")
    return name


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke() if smoke else mod.config()
