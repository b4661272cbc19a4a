"""SwiGLU MLP (port of ``repro.models.mlp``).

Without a mesh, the reference's plain form. Under a mesh (a
`parallel.shard.Layout` and the layer's specs), the reference's
Megatron-SP ``shard_map`` body where its ``_sp_plan`` takes it (the
sequence sharded over "model", d_ff sharded over "model"): the sequence
shards gathered over "model", the FSDP shards of the weights gathered,
``silu(x Wg) * (x Wu)`` over this rank's d_ff / n columns, and the
down-projection's partial sums reduce-scattered back to sequence shards.
Otherwise ``_apply_plain`` on the layout `logical_spec` gives: with d_ff
sharded and the sequence whole, the partial sums all-reduced; with d_ff
whole, this rank's rows alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.parallel.shard import gather_param


def init(cfg, gen: torch.Generator, device, d_ff: int | None = None) -> dict:
    """``d_ff`` overrides the config's width (an MoE's shared experts)."""
    d, dff, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.activation_dtype
    return {"w_gate": dense_init(gen, d, dff, dt, device),
            "w_up": dense_init(gen, d, dff, dt, device),
            "w_down": dense_init(gen, dff, d, dt, device)}


def _swiglu(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def apply(p, x: torch.Tensor, lay=None, sp=None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d); under a mesh x and the result are this
    rank's part of ``lay`` and ``sp`` holds the specs of p's leaves."""
    if lay is None:
        return _swiglu(p, x)
    tp = sp["w_gate"][1]                      # the d_ff axes ("model")
    w = {k: gather_param(v, sp[k], lay.mesh, keep=tp) for k, v in p.items()}
    if tp and lay.seq:                        # _sp_plan: _apply_shard_map
        return lay.to_layout(_swiglu(w, lay.whole_seq(x)), tp)
    y = _swiglu(w, x)
    return lay.to_layout(y, tp) if tp else y
