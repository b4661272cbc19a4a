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
whole (or the rows split over "model" too, `Layout.free`), this rank's
rows alone. Serving under a mesh calls `serve` (`serve_cols` on the
rank's shards, `launch.specs.serve_param_specs`: the hidden channels of
``w_gate`` / ``w_up`` and the output columns of ``w_down`` over
"model"): ``silu(x Wg) * (x Wu)`` on its channels, the hidden
activations gathered, then its output columns, gathered; every family's
MLP (a decoder's, a recurrent stack's, whisper's encoder and decoder)
and an MoE's shared experts (`moe.serve_tp`) serve so.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.parallel.shard import gather_cols, gather_param


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
    rank's part of ``lay`` and ``sp`` holds the specs of p's leaves (None:
    p is whole)."""
    if lay is None or sp is None:
        return _swiglu(p, x)
    tp = lay.free(sp["w_gate"][1])            # the d_ff axes ("model")
    w = {k: gather_param(v, sp[k], lay.mesh, keep=tp) for k, v in p.items()}
    if tp and lay.seq:                        # _sp_plan: _apply_shard_map
        return lay.to_layout(_swiglu(w, lay.whole_seq(x)), tp)
    y = _swiglu(w, x)
    return lay.to_layout(y, tp) if tp else y


def serve_cols(p, sp, x: torch.Tensor, mesh) -> torch.Tensor:
    """x (B, S, d) whole on the ranks of "model" -> this rank's output
    columns (B, S, d / n) of the SwiGLU (``sp``: p's serving specs): the
    hidden activations on the rank's channels, gathered over their axes,
    times the rank's columns of ``w_down`` (every element one whole dot
    product over d_ff, as one process sums it)."""
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return gather_cols(h, sp["w_gate"][-1], mesh) @ p["w_down"]


def serve(p, x: torch.Tensor, sp=None, mesh=None) -> torch.Tensor:
    """A serving step's SwiGLU: the plain form on one device (``sp``
    None); under a mesh `serve_cols` on this rank's shards (``sp`` their
    specs) with its output columns gathered: (B, S, d) whole."""
    if sp is None:
        return _swiglu(p, x)
    return gather_cols(serve_cols(p, sp, x, mesh), sp["w_down"][-1], mesh)
