"""INT8 gradient compression with error feedback (port of
``repro.optim.compression``): the paper's per-channel symmetric INT8
scheme applied to gradients, the quantization residual carried to the next
step (e' = (g + e) - Q(g + e)).

The reference stacks its layers, so each parameter kind is one
(n_layers, ...) array and its per-channel scales span every layer's rows
(``_quant_roundtrip`` reshapes to (-1, last)). The port keeps a list of
layers; to compute the same scales it quantizes the STACKED view of each
kind, and keeps the error state in the reference's stacked layout
(`models.transformer.stack_layers`). Quantization goes through `kernels.ops`: on a CUDA
tensor the absmax, quantize-with-scales and dequantize kernels.

``int8_psum`` (the compressed all-reduce across devices) waits for the
distribution item (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map, unflatten
from repro_torch.kernels import ops
from repro_torch.models.transformer import stack_layers, unstack_layers


def init_error_state(grads) -> dict:
    """Zero float32 error state in the reference's stacked layout."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device),
                    stack_layers(grads))


def _quant_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Per-channel INT8 roundtrip over the last axis (channels)."""
    g2 = g.reshape(-1, g.shape[-1]) if g.ndim > 1 else g.reshape(1, -1)
    q, s = ops.quantize_per_channel(g2)
    return ops.dequantize(q, s).reshape(g.shape)


@torch.no_grad()
def compress_with_feedback(grads, err_state):
    """grads in the port's layout, err_state stacked (`init_error_state`)
    -> (compressed grads in the port's layout and dtypes, new error
    state)."""
    errs = []

    def one(g, e):
        g32 = g.float() + e
        gq = _quant_roundtrip(g32)
        errs.append(g32 - gq)
        return gq.to(g.dtype)
    comp = tree_map(one, stack_layers(grads), err_state)
    return unstack_layers(comp), unflatten(err_state, errs)
