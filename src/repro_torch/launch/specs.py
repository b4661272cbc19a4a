"""Sharding specs of parameters, optimizer state, batches and caches
(port of ``repro.launch.specs``), and the moves between whole trees and
each rank's shards.

Rules are keyed on a leaf's name (its last dict key) and give the logical
axes of its TRAILING dims; leading dims (the reference's layer stacking)
are replicated. The port keeps one dict a layer, whose leaves have the
trailing dims of the reference's stacked ones, so a leaf's spec is the
reference's without the stacked axis. `parallel.shard.logical_spec` maps
the logical axes onto the mesh, so one set of rules serves the (16, 16),
the (2, 16, 16) and the (1, 1) mesh.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.shard import (MeshShape, gather_leaf, logical_spec,
                                        take_shard)

# leaf name -> logical axes of trailing dims
PARAM_RULES: dict[str, tuple] = {
    "embed": ("vocab", "fsdp"),
    "lm_head": ("fsdp", "vocab"),
    "wq": ("fsdp", "heads"), "wk": ("fsdp", "heads"), "wv": ("fsdp", "heads"),
    "wo": ("heads", "fsdp"),
    "bq": ("heads",), "bk": ("heads",), "bv": ("heads",),
    "w_gate": ("fsdp", "ffn"), "w_up": ("fsdp", "ffn"),
    "w_down": ("ffn", "fsdp"),
    "w_in": ("fsdp", "ffn"), "w_out": ("ffn", "fsdp"),
    "router": ("fsdp", None), "shared_gate": ("fsdp", None),
    "conv_w": (None, "ffn"),
    "lam": ("ffn",), "w_a": ("ffn",), "b_a": ("ffn",),
    "w_x": ("ffn",), "b_x": ("ffn",),
    "w_if": ("fsdp", None), "b_if": (None,),
    "w_gates": ("fsdp", "heads"), "r_gates": ("fsdp", "heads"),
    "b": (None,),
    "scale": (None,), "bias": (None,),
}

# serving-cache leaf name -> logical axes of trailing dims
CACHE_RULES: dict[str, tuple] = {
    # INT8 KV cache: batch DP, cache length sharded over "model"
    "k_q": ("batch", None, "seq_shard", None),
    "v_q": ("batch", None, "seq_shard", None),
    "k_s": ("batch", None, "seq_shard", None),
    "v_s": ("batch", None, "seq_shard", None),
    "resid_k": ("batch", None, None, None),
    "resid_v": ("batch", None, None, None),
    "length": (),
    # RG-LRU state
    "h": ("batch", "ffn"),
    "conv": ("batch", None, "ffn"),
    # mLSTM matrix memory
    "C": ("batch", None, "heads", None),
    "n": ("batch", None, "heads"),
    "m": ("batch", None),
    "C_s": ("batch", None, "heads"),
    # sLSTM state
    "c": ("batch", "ffn"),
}


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def spec_for(name: str, shape, rules: dict, mesh) -> tuple:
    """The spec of a leaf called ``name`` of ``shape`` (every dim
    replicated where no rule names it, or the leaf has fewer dims)."""
    logical = rules.get(name)
    if logical is None or len(shape) < len(logical):
        return ((),) * len(shape)
    pad = (None,) * (len(shape) - len(logical))
    return logical_spec(pad + tuple(logical), shape, mesh)


def _map_named(tree, fn, name: str = ""):
    """``fn(leaf name, leaf)`` over a tree of dicts and lists, the name a
    leaf's last dict key."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(v, fn, name) for v in tree]
    return None if tree is None else fn(name, tree)


def param_shardings(params, mesh):
    """A spec for each leaf of a parameter tree (whole shapes)."""
    return _map_named(params, lambda n, x: spec_for(n, _shape(x),
                                                    PARAM_RULES, mesh))


def opt_shardings(opt_state, mesh):
    """{"adam": {m, v, master, step}, "grad_err"?}: moments, master and
    error state by the parameters' rules (the leaf names are theirs), the
    step replicated."""
    return param_shardings(opt_state, mesh)


def _fields(obj) -> dict:
    return {k: v for k, v in vars(obj).items()
            if isinstance(v, (torch.Tensor, int)) and not isinstance(v, bool)
            and k in CACHE_RULES}


def cache_shardings(state, mesh, cfg):
    """A {field: spec} for each layer's serving state (a cache, or a
    recurrent state) of ``cfg``'s `transformer.init_decode_state` list (an
    encoder-decoder's dict of lists: a dict of them). The reference's
    cache rules see a stacked state, its layer axis first: a layer's spec
    is its stack's without that axis (the layers past the last whole
    pattern group are unstacked)."""
    if isinstance(state, dict):
        return {k: _layer_specs(v, mesh, len(v)) for k, v in state.items()}
    from repro_torch.models.transformer import pattern_layout
    period, n_groups, _ = pattern_layout(cfg)
    return _layer_specs(state, mesh, n_groups, n_groups * period)


def _layer_specs(layers, mesh, n_stack: int, stacked: int | None = None):
    stacked = len(layers) if stacked is None else stacked
    out = []
    for i, c in enumerate(layers):
        lead = (n_stack,) if i < stacked else ()
        out.append({k: spec_for(k, lead + _shape(v), CACHE_RULES,
                                mesh)[len(lead):]
                    for k, v in _fields(c).items()})
    return out


def batch_shardings(batch, mesh):
    """Every leaf's first dim over "batch", the rest replicated."""
    return {k: logical_spec(("batch",) + (None,) * (v.ndim - 1), v.shape,
                            mesh) for k, v in batch.items()}


def replicated(tree):
    return _map_named(tree, lambda n, x: ((),) * len(_shape(x)))


# -- specs from a config ------------------------------------------------------------

_SPECS: dict = {}


def param_shapes(cfg):
    """The parameter tree of ``cfg`` on the meta device (shapes only)."""
    from repro_torch.models import encdec, transformer
    init = encdec.init_params if cfg.family == "encdec" else \
        transformer.init_params
    return init(cfg, torch.Generator(), device="meta")


def param_specs(cfg, mesh):
    """`param_shardings` of ``cfg``'s parameters (cached by config and
    mesh shape)."""
    key = (cfg, MeshShape(mesh.axis_names, mesh.sizes).key)
    if key not in _SPECS:
        _SPECS[key] = param_shardings(param_shapes(cfg), mesh)
    return _SPECS[key]


def error_specs(cfg, mesh):
    """The specs of the error state of `optim.compression`: the
    parameters' specs in the reference's layout, a stacked leaf with its
    layer axis replicated."""
    from repro_torch.checkpoint.bridge import reference_layout
    key = ("err", cfg, MeshShape(mesh.axis_names, mesh.sizes).key)
    if key not in _SPECS:
        _SPECS[key] = param_shardings(
            reference_layout(param_shapes(cfg), cfg), mesh)
    return _SPECS[key]


def train_specs(cfg, mesh, grad_compression: bool = False) -> dict:
    """Specs of {"params", "opt"} as `training.step` keeps them."""
    p = param_specs(cfg, mesh)
    opt = {"adam": {"m": p, "v": p, "master": p, "step": ()}}
    if grad_compression:
        opt["grad_err"] = error_specs(cfg, mesh)
    return {"params": p, "opt": opt}


# -- whole trees <-> shards ----------------------------------------------------------

def _zip_specs(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _zip_specs(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip_specs(v, s, fn) for v, s in zip(tree, specs)]
    return None if tree is None else fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """Whole arrays -> this rank's shards (tensors as copies that hold
    no reference to the whole; numpy arrays as views)."""
    def one(x, spec):
        s = take_shard(x, spec, mesh)
        if isinstance(s, torch.Tensor) and s.numel() < x.numel():
            return s.clone(memory_format=torch.contiguous_format)
        return s
    return _zip_specs(tree, specs, one)


def init_shards(cfg, generator, device, specs, mesh):
    """This rank's shards of `transformer.init_params`'s weights (the same
    draws from ``generator``): each part is cut to its shards as it is
    made, so a rank never holds more of the whole model than one layer,
    or the embedding or head. ``specs`` are `param_specs`'. An
    encoder-decoder (trained on a mesh of one rank only) is made whole
    and cut."""
    from repro_torch.models import encdec, transformer
    if cfg.family == "encdec":
        return shard_tree(encdec.init_params(cfg, generator, device=device),
                          specs, mesh)

    def keep(key, part):
        sp = specs
        for k in key:
            sp = sp[k]
        return shard_tree(part, sp, mesh)
    return transformer.init_params(cfg, generator, device=device, keep=keep)


def gather_tree(tree, specs, mesh):
    """This rank's shards -> whole arrays, on every rank (a collective:
    every rank calls it)."""
    return _zip_specs(tree, specs, lambda x, s: gather_leaf(x, s, mesh)
                      if isinstance(x, torch.Tensor) else x)
