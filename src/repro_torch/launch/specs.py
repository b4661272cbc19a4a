"""Sharding specs of parameters, optimizer state, batches and caches
(port of ``repro.launch.specs``), and the moves between whole trees and
each rank's shards.

Rules are keyed on a leaf's name (its last dict key) and give the logical
axes of its TRAILING dims; leading dims (the reference's layer stacking)
are replicated. The port keeps one dict a layer, whose leaves have the
trailing dims of the reference's stacked ones, so a leaf's spec is the
reference's without the stacked axis. `parallel.shard.logical_spec` maps
the logical axes onto the mesh, so one set of rules serves the (16, 16),
the (2, 16, 16) and the (1, 1) mesh. A serving state's shards are made
at their local shapes (`init_serve_state`), never whole and then cut.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.parallel.shard import (MeshShape, current_rules,
                                        gather_leaf, logical_spec,
                                        shard_slices, spec_leaves,
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


def serve_state_specs(cfg, batch: int, max_len: int, mesh, *,
                      paged: bool = False, n_pages: int | None = None,
                      kv_cache_dtype="int8") -> tuple[list, list]:
    """(specs, whole): each layer's specs of ``cfg``'s serving state for
    ``batch`` rows (`cache_shardings`; paged: `paged_cache_specs`) and
    the whole state they are computed from, on the meta device (shapes
    only). An encoder-decoder's are dicts of two lists, ``self`` and
    ``cross`` (`encdec.init_decode_state`)."""
    from repro_torch.models import encdec
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.parallel.shard import paged_cache_specs
    if cfg.family == "encdec":
        whole = encdec.init_decode_state(cfg, batch, max_len, device="meta")
        return cache_shardings(whole, mesh, cfg), whole
    whole = init_decode_state(cfg, batch, max_len, paged=paged,
                              n_pages=n_pages, kv_cache_dtype=kv_cache_dtype,
                              device="meta")
    if paged:
        return [paged_cache_specs(c, mesh) for c in whole], whole
    return cache_shardings(whole, mesh, cfg), whole


def _local(shape, spec, mesh) -> tuple[int, ...]:
    return tuple(len(range(*s.indices(n))) for s, n in zip(
        shard_slices(spec, shape, mesh), shape))


# a recurrent state's initial values where they are not 0
# (`rglru.init_state`, `xlstm.mlstm_init_state`, `xlstm.slstm_init_state`)
_STATE_FILL = {"m": -1e30, "C_s": 1e-30}


def init_serve_state(cfg, batch: int, max_len: int, mesh, *,
                     paged: bool = False, n_pages: int | None = None,
                     kv_cache_dtype="int8", device="cuda"):
    """This rank's shards of `transformer.init_decode_state`'s state, each
    made at its local shapes (never whole, then cut; as `init_shards`):
    a contiguous layer's rows and slots of `cache_shardings`' spec (a
    `ShardedKVCache` where the slots are sharded, a ring under a sliding
    window, else a `QuantizedKVCache` of the rank's rows), a paged
    layer's rows (page table, residual, lengths) and its pool's kv heads
    of `paged_cache_specs`' (``kv_axes`` the heads' axes; every page, the
    allocator being replicated), a recurrent layer's state as each
    leaf's spec cuts it, the specs kept on it as ``spec``
    (`models.recurrent_mesh`). An encoder-decoder's is the dict of its
    ``self`` and ``cross`` lists, each cache cut as a contiguous layer's
    (the cross caches per channel over the encoder's slots)."""
    specs, whole = serve_state_specs(cfg, batch, max_len, mesh, paged=paged,
                                     n_pages=n_pages,
                                     kv_cache_dtype=kv_cache_dtype)
    if isinstance(whole, dict):
        return {k: _local_state(cfg, whole[k], specs[k], mesh, max_len,
                                False, device) for k in whole}
    return _local_state(cfg, whole, specs, mesh, max_len, paged, device)


def _local_state(cfg, whole, specs, mesh, max_len, paged, device) -> list:
    """This rank's part of each layer of ``whole`` (meta) by its
    ``specs``, made at its local shapes (`init_serve_state`)."""
    from repro_torch.core.kvcache import QuantizedKVCache, ShardedKVCache
    from repro_torch.core.paging import PagedQuantizedKVCache
    out = []
    for c, sp in zip(whole, specs):
        if paged:
            B_l, H_l = _local(c.resid_k.shape, sp["resid_k"], mesh)[:2]
            new = PagedQuantizedKVCache.init(
                B_l, H_l, max_len, cfg.head_dim, cfg.quant,
                n_pages=c.pool.k_q.shape[0], kv_dtype=c.kv_dtype,
                device=device)
            new.kv_axes = sp["pool"]["k_q"][2]
        elif isinstance(c, QuantizedKVCache):
            B_l = _local(c.k_q.shape, sp["k_q"], mesh)[0]
            quant = dataclasses.replace(cfg.quant, granularity=(
                "per_channel" if c.per_channel else "per_block"))
            if sp["k_q"][2]:
                new = ShardedKVCache.init(
                    B_l, cfg.n_kv_heads, c.max_len, cfg.head_dim, quant,
                    c.ring, device=device, mesh=mesh, axes=sp["k_q"][2],
                    scale_axes=sp["k_s"][2])
            else:
                new = QuantizedKVCache.init(B_l, cfg.n_kv_heads, c.max_len,
                                            cfg.head_dim, quant, c.ring,
                                            device=device)
        else:
            new = type(c)(**{f: torch.full(
                _local(v.shape, sp[f], mesh), _STATE_FILL.get(f, 0.0),
                dtype=v.dtype, device=device) for f, v in vars(c).items()})
            new.spec = sp
        out.append(new)
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


def _key(*parts) -> tuple:
    """A spec cache key: ``parts``, the mesh shape's and the logical rules
    in force (`parallel.shard.current_rules`, an override included), so a
    cached spec never answers for other rules."""
    *parts, mesh = parts
    rules = tuple(sorted((k, tuple(v)) for k, v in current_rules().items()))
    return (*parts, MeshShape(mesh.axis_names, mesh.sizes).key, rules)


def param_specs(cfg, mesh):
    """`param_shardings` of ``cfg``'s parameters (cached by config, mesh
    shape and rules)."""
    key = _key(cfg, mesh)
    if key not in _SPECS:
        _SPECS[key] = param_shardings(param_shapes(cfg), mesh)
    return _SPECS[key]


def _tp_axes(logical: str, units: int, mesh) -> tuple[str, ...]:
    """The mesh axes that cut ``units`` whole units (heads, channels,
    vocabulary rows) of a serving weight by the ``logical`` rule, ``()``
    where they do not divide it or where the rules give the axes to the
    rows (an override such as `SSM_RULES`: each rank then computes
    whole)."""
    axes = logical_spec((logical,), (units,), mesh)[0]
    rows = set(current_rules().get("batch", ()))
    return () if rows & set(axes) else axes


# (block kind, leaf name) -> (the dim "model" cuts, counted from the end;
# what it cuts: "q" query heads, "kv" kv heads, "heads" the mLSTM's heads,
# "ffn" hidden channels, "out" the d_model output columns, "vocab"
# vocabulary rows or columns). A leaf's kind is the nearest key above it
# that names one (an MoE's shared experts are its "moe"'s); the leaf names
# collide across kinds (the RG-LRU's ``w_gate``, the mLSTM's ``wq``), so
# the cut is keyed on both
_ATTN_CUTS = {"wq": (-1, "q"), "bq": (-1, "q"), "wk": (-1, "kv"),
              "wv": (-1, "kv"), "bk": (-1, "kv"), "bv": (-1, "kv"),
              "wo": (-1, "out")}
_FFN_CUTS = {"w_gate": (-1, "ffn"), "w_up": (-1, "ffn"),
             "w_down": (-1, "out")}
_SERVE_CUTS = {
    "": {"embed": (-2, "vocab"), "lm_head": (-1, "vocab")},
    "attn": _ATTN_CUTS, "self_attn": _ATTN_CUTS, "cross_attn": _ATTN_CUTS,
    "mlp": _FFN_CUTS, "moe": _FFN_CUTS,
    "rglru": {**{k: (-1, "ffn") for k in ("w_in", "w_gate", "conv_w", "lam",
                                          "w_a", "b_a", "w_x", "b_x")},
              "w_out": (-1, "out")},
    "mlstm": {"wq": (-1, "heads"), "wk": (-1, "heads"), "wv": (-1, "heads"),
              "wo": (-1, "out")},
    "slstm": {},
}


def _map_kinds(tree, fn, kind: str = "", name: str = ""):
    """``fn(block kind, leaf name, leaf)`` over a parameter tree, the kind
    the nearest key above the leaf in `_SERVE_CUTS` ("" at the top)."""
    if isinstance(tree, dict):
        return {k: _map_kinds(v, fn, k if k in _SERVE_CUTS else kind, k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_kinds(v, fn, kind, name) for v in tree]
    return None if tree is None else fn(kind, name, tree)


def serve_param_specs(cfg, mesh):
    """The layout serving takes the parameters in under ``mesh``, for
    every family (cached by config, mesh shape and rules): tensor
    parallel over "model", cut on whole units, keyed on the block kind
    and the leaf name (`_SERVE_CUTS`).

    - Attention (a decoder's, whisper's encoder self, decoder self and
      cross attention): ``wq`` / ``bq`` by query head, ``wk``, ``wv``,
      ``bk``, ``bv`` by kv head, ``wo`` by its OUTPUT (d_model) columns.
      A unit count the axes do not divide stays whole (kv heads fewer
      than "model": every rank projects and stores every kv head, the
      paged pool's kv heads replicated as `page_pool_specs` keeps them;
      recurrentgemma_9b's one kv head); query heads split only where
      each rank's lie in whole groups of one or more kv heads (query
      head h reads kv head h // G).
    - MLP and MoE: ``w_gate`` / ``w_up`` (an MLP's, the experts' and the
      shared experts') by hidden channel, ``w_down`` by its output
      columns; the router stays whole.
    - RG-LRU: ``w_in``, ``w_gate``, ``conv_w`` and the gate vectors
      ``lam``, ``w_a``, ``b_a``, ``w_x``, ``b_x`` by channel, the same
      slices `cache_shardings` gives the state's ``h`` and ``conv`` (both
      the "ffn" rule over the same width), so a step reads and writes
      only the rank's own state; ``w_out`` by its output columns.
    - mLSTM: ``wq``, ``wk``, ``wv`` by whole head, ``wo`` by its output
      columns; ``w_if`` / ``b_if`` whole on every rank (float32, a head's
      i and f columns are h and nh + h: not one block; a rank slices its
      heads' locally, `models.recurrent_mesh`).
    - sLSTM: every leaf whole on every rank, by layout (nothing gathers
      them): ``w_gates`` / ``r_gates`` (d, 4d) hold the gate blocks [i,
      f, z, o] side by side, so a contiguous column cut gives a rank
      whole gates rather than channels, and the recurrence ``h @
      r_gates`` couples every channel at every token: any cut needs a
      collective a token inside `xlstm.slstm_seq`'s host loop. The cost
      is ~18.9 MB a layer in bf16 at xlstm_350m's width (56.6 MB for its
      three sLSTM layers); training keeps them so too.
    - ``embed``'s (padded) vocabulary rows and ``lm_head``'s columns;
      the norms stay whole.

    Each output element of a projection is then one whole dot product,
    the one one process computes, gathered rather than summed from
    partial products (a reduced row split moves the residual's bf16
    bits and, through the next layer's K/V, the int8 pages).

    Unlike training's `param_specs` nothing lies over "data": a serving
    rank's rows are independent requests, and FSDP shards gathered
    every step would send most of the model each token; the ranks of a
    "data" axis hold replicas of their "model" shard. Where the rules
    give "model" to the rows (`SSM_RULES`) every leaf is whole, a
    replica by layout, never gathered."""
    key = _key("serve", cfg, mesh)
    if key not in _SPECS:
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        kv, q = _tp_axes("kv_heads", Hkv, mesh), _tp_axes("heads", H, mesh)
        if q and not kv and (H // Hkv) % (
                H // math.prod(mesh.shape[a] for a in q)):
            q = ()                          # a rank's heads span kv heads
        units = {"q": q, "kv": kv, "heads": _tp_axes("heads", H, mesh)}

        def spec(kind, name, leaf):
            shape = _shape(leaf)
            dim, what = _SERVE_CUTS[kind].get(name, (None, None))
            out = [()] * len(shape)
            if what is not None and len(shape) >= -dim:
                out[dim] = units[what] if what in units else _tp_axes(
                    "vocab" if what == "vocab" else "ffn", shape[dim], mesh)
            return tuple(out)
        _SPECS[key] = _map_kinds(param_shapes(cfg), spec)
    return _SPECS[key]


def _zip3(tree, have, want, fn):
    if isinstance(tree, dict):
        return {k: _zip3(v, have[k], want[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zip3(*a, fn) for a in zip(tree, have, want)]
    return None if tree is None else fn(tree, have, want)


def refit_tree(tree, have, want, mesh):
    """This rank's shards laid out by the specs ``have`` -> by ``want``
    (`parallel.shard.refit` leaf by leaf, each a contiguous copy; a
    collective): a tree saved or restored in training's layout
    (`param_specs`) re-cut once to the serving layout
    (`serve_param_specs`)."""
    from repro_torch.parallel.shard import refit
    return _zip3(tree, have, want, lambda x, h, w: refit(x, h, w, mesh).clone(
        memory_format=torch.contiguous_format))


def shard_shapes(cfg, specs, mesh) -> list:
    """The local shape of each of this rank's shards of ``cfg``'s
    parameters laid out by ``specs``, in `core.tree.leaves` order."""
    from repro_torch.core.tree import leaves
    return [_local(x.shape, s, mesh) for x, s in zip(
        leaves(param_shapes(cfg)), spec_leaves(specs), strict=True)]


def error_specs(cfg, mesh):
    """The specs of the error state of `optim.compression`: the
    parameters' specs in the reference's layout, a stacked leaf with its
    layer axis replicated."""
    from repro_torch.checkpoint.bridge import reference_layout
    key = _key("err", cfg, mesh)
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
    or the embedding or head. ``specs`` are `param_specs`' (training) or
    `serve_param_specs`' (serving). An encoder-decoder's come from
    `encdec.init_params` the same way."""
    from repro_torch.models import encdec, transformer

    def keep(key, part):
        sp = specs
        for k in key:
            sp = sp[k]
        return shard_tree(part, sp, mesh)
    init = encdec.init_params if cfg.family == "encdec" else \
        transformer.init_params
    return init(cfg, generator, device=device, keep=keep)


def gather_tree(tree, specs, mesh):
    """This rank's shards -> whole arrays, on every rank (a collective:
    every rank calls it)."""
    return _zip_specs(tree, specs, lambda x, s: gather_leaf(x, s, mesh)
                      if isinstance(x, torch.Tensor) else x)
