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

Under a mesh the gradients and the error state are this rank's shards
(the error state sharded like its leaf: `launch.specs.error_specs`,
passed in by the train step): each
stacked leaf's column absmax is all-reduced with MAX over the mesh axes
that shard any of its dims but the last, between the two passes, so the
scales, and the compressed gradient, are those of the whole (global)
gradient, which is what the reference's jitted step compresses.

`int8_psum` is the reference's compressed all-reduce across ranks: each
rank quantizes its own gradient per channel, the int8 payloads and f32
scale rows are all-gathered, and every rank dequantizes each payload and
sums them in rank order.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.bridge import reference_layout
from repro_torch.core.tree import leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.parallel.shard import current_mesh, spec_leaves


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


def _channels(g: torch.Tensor) -> torch.Tensor:
    """g as (rows, channels) over its last axis (a vector is one row).
    The kernels take rows of whole 16-byte groups, so a width that is no
    multiple of 4 (an MoE's shared-expert gate, (d, 1)) is padded with
    zero channels, each with its own scale (cut back by the caller)."""
    g2 = g.reshape(-1, g.shape[-1]) if g.ndim > 1 else g.reshape(1, -1)
    D = g2.shape[1]
    return torch.nn.functional.pad(g2, (0, -D % 4)) if D % 4 else g2


def _quant_roundtrip(g: torch.Tensor, mesh=None, axes=()) -> torch.Tensor:
    """Per-channel INT8 roundtrip over the last axis (channels); the
    absmax all-reduced with MAX over ``axes`` of ``mesh`` (the axes that
    shard the rows)."""
    g2 = _channels(g)
    amax = ops.absmax(g2)
    if axes:
        amax = mesh.all_reduce(amax, axes, "max")
    q, s = ops.quantize_with_scales(g2, amax)
    return ops.dequantize(q, s)[:, :g.shape[-1]].reshape(g.shape)


@torch.no_grad()
def compress_with_feedback(grads, err_state, cfg, mesh=None, specs=None):
    """grads in the port's layout, err_state in the reference's layout of
    ``cfg`` (`init_error_state`) -> (the compressed grads, the new error
    state): each leaf of the reference's tree quantized as the reference
    does, the gradients (in their dtypes) and the error state updated in
    place and returned. Under ``mesh`` both are this rank's shards, the
    error state's laid out by ``specs`` (module docstring)."""
    groups = leaves(reference_layout(grads, cfg, _Stack))
    errs = leaves(err_state)
    if mesh is None:
        row_axes = [()] * len(errs)
    else:
        row_axes = [tuple(a for axes in spec[:-1] for a in axes)
                    for spec in spec_leaves(specs)]
    if len(groups) != len(errs):
        raise ValueError(f"{len(groups)} gradient leaves in the "
                         f"reference's layout against {len(errs)} in the "
                         f"error state")
    for g, e, axes in zip(groups, errs, row_axes):
        parts = g.parts if isinstance(g, _Stack) else [g]
        stacked = torch.stack(parts) if isinstance(g, _Stack) else g
        if stacked.shape != e.shape:
            raise ValueError(f"gradient {tuple(stacked.shape)} against "
                             f"error state {tuple(e.shape)}")
        g32 = stacked.float() + e
        del stacked
        gq = _quant_roundtrip(g32, mesh, axes)
        torch.sub(g32, gq, out=e)
        del g32
        gq = gq.to(parts[0].dtype)
        if isinstance(g, _Stack):
            for i, x in enumerate(parts):
                x.copy_(gq[i])
        else:
            g.copy_(gq)
    return grads, err_state


@torch.no_grad()
def int8_psum(g: torch.Tensor, axes, mesh=None) -> torch.Tensor:
    """The compressed all-reduce of ``g`` over the mesh ``axes`` (a name
    or names; the current mesh by default): this rank's int8 payload and
    float32 scale row go on the wire (all-gathered), and the sum of the
    dequantized payloads, in rank order, comes back on every rank. The
    reference's psum of dequantized contributions, up to the order of
    the sum."""
    mesh = mesh or current_mesh()
    g2 = _channels(g.float())
    q, s = ops.quantize_with_scales(g2, ops.absmax(g2))
    qs = mesh.all_gather(q[None], axes, 0)
    ss = mesh.all_gather(s[None], axes, 0)
    deq = ops.dequantize(qs, ss)
    out = deq[0]
    for i in range(1, deq.shape[0]):
        out = out + deq[i]
    return out[:, :g.shape[-1]].reshape(g.shape)
