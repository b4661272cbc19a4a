"""Weight bridge between the reference's pytrees, already turned into
numpy arrays, and the port's trees.

The reference stacks its layers on a leading ``n_groups`` axis under
``tree["blocks"]["p0"]`` (one block per group for a stack of one block
kind) and holds ``embed``, ``lm_head`` and ``final_norm`` beside it; the
port keeps a list of per-layer dicts under ``layers``. Arrays go through
float32, which is exact for bfloat16 (numpy's ml_dtypes bfloat16 cannot
go through `torch.from_numpy`).

- `params_from_numpy`: the reference's ``init_params`` tree -> the port's
  parameters, in the config's dtype (norm scales, an MoE's router and
  shared-expert gate float32) on ``device``: attention with its QKV
  biases, and an MLP or an MoE (stacked experts (E, d, f) / (E, f, d),
  shared experts) per layer.
- `opt_state_from_numpy`: the reference's ``init_opt_state`` tree (m, v,
  master, step, optional grad_err) -> the port's (`training.step`).
- `tree_to_numpy`: the port's parameters (or moments, master weights) ->
  the reference's stacked layout, float32 numpy, for leaf-by-leaf
  comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.models.transformer import (check_servable, stack_layers,
                                            unstack_layers)


def _stacked_ref(tree, cfg) -> dict:
    """The reference tree without its (empty) tail, checked for a dense
    stack of cfg.n_layers."""
    n = np.asarray(tree["blocks"]["p0"]["norm1"]["scale"]).shape[0]
    if n != cfg.n_layers or tree.get("tail"):
        raise ValueError(f"expected {cfg.n_layers} stacked layers and no "
                         f"tail, got {n} and {len(tree.get('tail') or [])}")
    return {k: v for k, v in tree.items() if k != "tail"}


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


# the leaves the reference keeps in float32 whatever the model's dtype: the
# norm scales and an MoE's router and shared-expert gate
_F32 = {"final_norm", "norm1", "norm2", "router", "shared_gate"}


def _port_layout(tree, cfg, device, dtype_of) -> dict:
    """Reference layout -> port layout; each leaf a tensor of
    ``dtype_of(is_float32_leaf)``, layers as copies (not views of a
    stack)."""
    ref = _stacked_ref(tree, cfg)

    def conv(node, f32=False):
        if isinstance(node, dict):
            return {k: conv(v, f32 or k in _F32) for k, v in node.items()}
        return _tensor(node, dtype_of(f32), device)
    port = unstack_layers(conv(ref))
    port["layers"] = tree_map(lambda x: x.clone(), port["layers"])
    return port


def params_from_numpy(tree, cfg, device) -> dict:
    check_servable(cfg)
    dt = cfg.activation_dtype
    return _port_layout(tree, cfg, device,
                        lambda f32: torch.float32 if f32 else dt)


def opt_state_from_numpy(tree, cfg, device) -> dict:
    """{"adam": {m, v, master, step}, "grad_err"?} -> the port's optimizer
    state: m, v and master float32 in the port's layout, step an int32
    tensor, grad_err float32 in the stacked layout it keeps."""
    f32 = lambda norm: torch.float32
    adam = tree["adam"]
    out = {"adam": {k: _port_layout(adam[k], cfg, device, f32)
                    for k in ("m", "v", "master")}}
    out["adam"]["step"] = torch.tensor(int(np.asarray(adam["step"])),
                                       dtype=torch.int32, device=device)
    if "grad_err" in tree:
        out["grad_err"] = tree_map(
            lambda a: _tensor(a, torch.float32, device),
            _stacked_ref(tree["grad_err"], cfg))
    return out


def tree_to_numpy(tree) -> dict:
    """The port's layout (or the stacked one) -> the reference's stacked
    layout as float32 numpy, with an empty ``tail``."""
    stacked = stack_layers(tree) if "layers" in tree else tree
    out = tree_map(lambda x: x.detach().float().cpu().numpy(), stacked)
    out["tail"] = []
    return out
