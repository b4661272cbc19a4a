"""INT8 gradient compression with error feedback (port of
``repro.optim.compression``): the paper's per-channel symmetric INT8
scheme applied to gradients, the quantization residual carried to the next
step (e' = (g + e) - Q(g + e)).

The reference stacks its layers, so each parameter of a pattern position
is one (n_groups, ...) array and its per-channel scales span every
group's rows (``_quant_roundtrip`` reshapes to (-1, last)); the layers
past the last whole group (a ``tail``) and an encoder-decoder's two
stacks are laid out as its tree has them. The port keeps lists of
layers; to compute the same scales it quantizes, one stacked leaf at a
time, the stack of the layers' leaves that the reference's leaf holds
(`checkpoint.bridge.reference_layout`), and keeps the error state in the
reference's layout. The compressed values are written back into the
gradients and the new error into the error state, in place, so a step
holds no second copy of either. Quantization goes through `kernels.ops`:
on a CUDA tensor the absmax, quantize-with-scales and dequantize kernels.

``int8_psum`` (the compressed all-reduce across devices) waits for the
distribution item (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.bridge import reference_layout
from repro_torch.core.tree import leaves, tree_map
from repro_torch.kernels import ops


class _Stack:
    """The layers' leaves that one stacked leaf of the reference's tree
    holds, unstacked (a leaf of `core.tree`)."""

    def __init__(self, parts: list):
        self.parts = parts


def _zeros(g) -> torch.Tensor:
    shape = ((len(g.parts), *g.parts[0].shape) if isinstance(g, _Stack)
             else g.shape)
    dev = g.parts[0].device if isinstance(g, _Stack) else g.device
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def init_error_state(params, cfg) -> dict:
    """Zero float32 error state in the reference's layout of ``cfg``."""
    return tree_map(_zeros, reference_layout(params, cfg, _Stack))


def _quant_roundtrip(g: torch.Tensor) -> torch.Tensor:
    """Per-channel INT8 roundtrip over the last axis (channels). The
    kernels take rows of whole 16-byte groups, so a width that is no
    multiple of 4 (an MoE's shared-expert gate, (d, 1)) is padded with
    zero channels, each with its own scale, and cut back."""
    g2 = g.reshape(-1, g.shape[-1]) if g.ndim > 1 else g.reshape(1, -1)
    D = g2.shape[1]
    if D % 4:
        g2 = torch.nn.functional.pad(g2, (0, -D % 4))
    q, s = ops.quantize_per_channel(g2)
    return ops.dequantize(q, s)[:, :D].reshape(g.shape)


@torch.no_grad()
def compress_with_feedback(grads, err_state, cfg):
    """grads in the port's layout, err_state in the reference's layout of
    ``cfg`` (`init_error_state`) -> (the compressed grads, the new error
    state): each leaf of the reference's tree quantized as the reference
    does, the gradients (in their dtypes) and the error state updated in
    place and returned."""
    groups = leaves(reference_layout(grads, cfg, _Stack))
    errs = leaves(err_state)
    if len(groups) != len(errs):
        raise ValueError(f"{len(groups)} gradient leaves in the "
                         f"reference's layout against {len(errs)} in the "
                         f"error state")
    for g, e in zip(groups, errs):
        parts = g.parts if isinstance(g, _Stack) else [g]
        stacked = torch.stack(parts) if isinstance(g, _Stack) else g
        if stacked.shape != e.shape:
            raise ValueError(f"gradient {tuple(stacked.shape)} against "
                             f"error state {tuple(e.shape)}")
        g32 = stacked.float() + e
        del stacked
        gq = _quant_roundtrip(g32)
        torch.sub(g32, gq, out=e)
        del g32
        gq = gq.to(parts[0].dtype)
        if isinstance(g, _Stack):
            for i, x in enumerate(parts):
                x.copy_(gq[i])
        else:
            g.copy_(gq)
    return grads, err_state
