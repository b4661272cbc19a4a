"""SwiGLU MLP (port of ``repro.models.mlp``; without a mesh the
reference's `apply` is exactly this plain form)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init(cfg, gen: torch.Generator, device, d_ff: int | None = None) -> dict:
    """``d_ff`` overrides the config's width (an MoE's shared experts)."""
    d, dff, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.activation_dtype
    return {"w_gate": dense_init(gen, d, dff, dt, device),
            "w_up": dense_init(gen, d, dff, dt, device),
            "w_down": dense_init(gen, dff, d, dt, device)}


def apply(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
