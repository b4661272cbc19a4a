"""Architecture registry of the port: the configs ported so far.

Only ``internlm2_1_8b`` — the one model the paged serving path accepts —
is ported; the reference's other nine architectures wait on ROADMAP
queue 1, item 15.
"""
from __future__ import annotations

import importlib

ARCHS = ("internlm2_1_8b",)


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {name!r}; ported: "
                       f"{list(ARCHS)} (ROADMAP queue 1, item 15)")
    return name


def get_config(name: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.smoke() if smoke else mod.config()
