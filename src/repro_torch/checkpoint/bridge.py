"""Weight bridge between the reference's pytrees, already turned into
numpy arrays, and the port's trees.

The reference stacks its layers by pattern position: ``blocks.p{i}`` for
i < period (the block pattern's length) holds layer g * period + i at
index g of a leading ``n_groups`` axis, and the n_layers - n_groups *
period layers left over follow unstacked in the list ``tail``;
``embed``, ``lm_head`` (none with tied embeddings) and ``final_norm``
sit beside them. The port keeps a list of per-layer dicts under
``layers``. An encoder-decoder (``cfg.family == "encdec"``) stacks its
encoder blocks (norm1, attn, norm2, mlp) under ``enc_blocks`` and its
decoder blocks (norm1, self_attn, norm_x, cross_attn, norm2, mlp) under
``dec_blocks``, beside ``embed``, ``enc_norm`` and ``final_norm``; the
port keeps the lists ``enc_layers`` and ``dec_layers``. Arrays go
through float32, which is exact for bfloat16 (numpy's ml_dtypes
bfloat16 cannot go through `torch.from_numpy`).

- `params_from_numpy`: the reference's ``init_params`` tree -> the port's
  parameters, in the config's dtype (the leaves the reference keeps
  float32 stay float32: norm scales and LayerNorm biases, an MoE's
  router and shared-expert gate, the RG-LRU gate vectors, the mLSTM gate
  projection and bias, the sLSTM bias) on ``device``: each layer's mixer (attention with its QKV
  biases, RG-LRU, mLSTM or sLSTM) and its MLP or MoE (stacked experts
  (E, d, f) / (E, f, d), shared experts).
- `opt_state_from_numpy`: the reference's ``init_opt_state`` tree (m, v,
  master, step, optional grad_err) -> the port's (`training.step`).
  Both take a ``mesh`` and ``specs`` (`launch.specs.train_specs`'
  "params" and "opt"; for serving, `launch.specs.serve_param_specs`):
  each rank then takes its shards straight from the numpy arrays, with no
  whole copy on the device.
- `reference_layout`: the port's layout -> the reference's, by the
  config (what `optim.compression` keeps its error state in).
- `tree_to_numpy`: the port's parameters (or moments, master weights,
  error state) -> the reference's stacked layout (with the config, its
  pattern's period and tail; an encoder-decoder's two stacks), float32
  numpy, for leaf-by-leaf comparison.
- `serve_state_to_numpy` / `serve_state_from_numpy`: an attention
  stack's serving state (contiguous or paged int8 caches; under a mesh a
  rank's shards) <-> the reference's stacked state as numpy, a cache's
  fields as a dict (a paged cache's pool under ``pool``); an
  encoder-decoder's ``{"self", "cross"}``, each a stack of its layers'
  caches, as the reference keeps them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.models import encdec
from repro_torch.models.transformer import (pattern_layout, stack_layers,
                                            unstack_layers)
from repro_torch.parallel.shard import take_shard


def _stacked_ref(tree, cfg) -> dict:
    """The reference tree, checked for cfg's layout (`pattern_layout`:
    blocks p0 .. p{period-1} of n_groups layers each, and the tail)."""
    period, n_groups, tail = pattern_layout(cfg)
    blocks, got_tail = tree["blocks"], list(tree.get("tail") or [])
    got = {k: np.asarray(v["norm1"]["scale"]).shape[0]
           for k, v in blocks.items()}
    if got != {f"p{i}": n_groups for i in range(period)} \
            or len(got_tail) != tail:
        raise ValueError(f"expected blocks p0..p{period - 1} of {n_groups} "
                         f"stacked layers and a tail of {tail}, got "
                         f"{got} and a tail of {len(got_tail)}")
    return {**tree, "tail": got_tail}


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device=device,
                                                        dtype=dtype)


# the leaves the reference keeps in float32 whatever the model's dtype: the
# norms (scales, and LayerNorm biases), an MoE's router and shared-expert
# gate, the RG-LRU's gate vectors, the mLSTM's gate projection and bias and
# the sLSTM's bias
_F32 = {"final_norm", "norm1", "norm2", "norm_x", "enc_norm", "bias",
        "router", "shared_gate", "lam", "w_a", "b_a", "w_x", "b_x", "w_if",
        "b_if", "b"}


def _conv(node, dtype_of, device, f32=False, spec=None, mesh=None):
    """Numpy leaves -> tensors of ``dtype_of(is_float32_leaf)``; under a
    mesh, this rank's shard of each (``spec`` the tree's specs)."""
    if isinstance(node, dict):
        return {k: _conv(v, dtype_of, device, f32 or k in _F32,
                         None if spec is None else spec[k], mesh)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_conv(v, dtype_of, device, f32,
                      None if spec is None else spec[i], mesh)
                for i, v in enumerate(node)]
    if spec is not None:
        node = take_shard(np.asarray(node), spec, mesh)
    return _tensor(node, dtype_of(f32), device)


def _encdec_layout(tree, cfg, device, dtype_of, mesh=None,
                   specs=None) -> dict:
    """The reference's encoder-decoder tree -> the port's, the stacks as
    per-layer lists; under ``mesh`` this rank's shards of ``specs``."""
    got = {k: int(np.asarray(tree[k]["norm1"]["scale"]).shape[0])
           for k, _ in encdec.STACKS}
    want = {"enc_blocks": cfg.n_encoder_layers, "dec_blocks": cfg.n_layers}
    if got != want:
        raise ValueError(f"expected {want} stacked layers, got {got}")
    port = dict(tree)
    for ref_key, port_key in encdec.STACKS:
        stack = tree_map(np.asarray, port.pop(ref_key))
        port[port_key] = [tree_map(lambda a, i=i: a[i], stack)
                          for i in range(want[ref_key])]
    return _conv(port, dtype_of, device, spec=specs, mesh=mesh)


def _port_layout(tree, cfg, device, dtype_of, mesh=None,
                 specs=None) -> dict:
    """Reference layout -> port layout; each leaf a tensor of
    ``dtype_of(is_float32_leaf)``, layers as copies (not views of a
    stack); under ``mesh`` this rank's shards of ``specs``."""
    if cfg.family == "encdec":
        return _encdec_layout(tree, cfg, device, dtype_of, mesh, specs)
    ref = _stacked_ref(tree, cfg)
    if mesh is None:
        port = unstack_layers(_conv(ref, dtype_of, device))
        port["layers"] = tree_map(lambda x: x.clone(), port["layers"])
        return port
    port = unstack_layers(tree_map(np.asarray, ref))
    return _conv(port, dtype_of, device, spec=specs, mesh=mesh)


def params_from_numpy(tree, cfg, device, mesh=None, specs=None) -> dict:
    dt = cfg.activation_dtype
    return _port_layout(tree, cfg, device,
                        lambda f32: torch.float32 if f32 else dt, mesh, specs)


def reference_layout(tree, cfg, stack=torch.stack) -> dict:
    """The port's layout -> the reference's, by ``cfg``: a decoder's
    layers as ``blocks.p{i}`` by its pattern's period and its ``tail``
    (`transformer.stack_layers`), an encoder-decoder's as ``enc_blocks`` /
    ``dec_blocks`` (`encdec.stack_layers`); each stacked leaf is ``stack``
    of the list of its layers' leaves."""
    if cfg.family == "encdec":
        return encdec.stack_layers(tree, stack)
    return stack_layers(tree, pattern_layout(cfg)[0], stack)


def opt_state_from_numpy(tree, cfg, device, mesh=None, specs=None) -> dict:
    """{"adam": {m, v, master, step}, "grad_err"?} -> the port's optimizer
    state: m, v and master float32 in the port's layout, step an int32
    tensor, grad_err float32 in the reference's layout, which it keeps
    (`optim.compression`); under ``mesh`` this rank's shards of ``specs``
    (the same tree of specs)."""
    f32 = lambda norm: torch.float32
    adam = tree["adam"]
    out = {"adam": {k: _port_layout(adam[k], cfg, device, f32, mesh,
                                    None if mesh is None
                                    else specs["adam"][k])
                    for k in ("m", "v", "master")}}
    out["adam"]["step"] = torch.tensor(int(np.asarray(adam["step"])),
                                       dtype=torch.int32, device=device)
    if "grad_err" in tree:
        err = tree["grad_err"]
        if cfg.family != "encdec":
            err = _stacked_ref(err, cfg)
            if not err["tail"]:
                del err["tail"]
        if mesh is None:
            out["grad_err"] = tree_map(
                lambda a: _tensor(a, torch.float32, device), err)
        else:
            out["grad_err"] = _conv(err, f32, device,
                                    spec=specs["grad_err"], mesh=mesh)
    return out


def tree_to_numpy(tree, cfg=None) -> dict:
    """The port's layout (or the reference's) -> the reference's layout
    as float32 numpy (`reference_layout`; without a config, a decoder's
    layers as one pattern position). A decoder's tree gets an empty
    ``tail`` where it has none, as the reference's."""
    if "dec_layers" in tree:
        tree = encdec.stack_layers(tree)
    elif "layers" in tree:
        tree = stack_layers(tree, pattern_layout(cfg)[0] if cfg else 1)
    out = tree_map(lambda x: x.detach().float().cpu().numpy(), tree)
    if "blocks" in out:
        out.setdefault("tail", [])
    return out


# -- serving states -----------------------------------------------------------

_CACHE_FIELDS = ("k_q", "v_q", "k_s", "v_s", "resid_k", "resid_v", "length")
_POOL_FIELDS = ("k_q", "v_q", "k_s", "v_s")
_VIEW_FIELDS = ("page_table", "resid_k", "resid_v", "length")


def _state_fields(c) -> tuple[str, ...]:
    """A layer's serving-state fields: a contiguous cache's, or a
    recurrent state's (its dataclass fields)."""
    if hasattr(c, "k_q"):
        return _CACHE_FIELDS
    return tuple(f.name for f in dataclasses.fields(c))


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.float8_e4m3fn:       # fp8 pages as their bytes
            return x.view(torch.int8).numpy()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def serve_state_to_numpy(state, cfg) -> dict:
    """A serving state (one entry a layer, `transformer.init_decode_state`;
    under a mesh a rank's shards) -> the reference's stacked layout
    (``p{i}`` with a leading layer-group axis, ``tail``): a contiguous
    cache's fields k_q, v_q, k_s, v_s, resid_k, resid_v and length, a
    paged one's ``pool`` {k_q, v_q, k_s, v_s}, page_table, resid_k,
    resid_v and length, a recurrent state's fields (RG-LRU h, conv;
    mLSTM C, n, m, C_s; sLSTM c, n, h, m), as numpy (bfloat16 as
    float32, fp8 pages as their bytes). Under a mixed per-layer page plan
    each ``p{i}`` is a list of its layers, as the reference keeps it (its
    pools differ in dtype and shape). An encoder-decoder's state (a dict
    of two lists) -> ``{"self", "cross"}``, each field stacked over the
    layers."""
    if isinstance(state, dict):
        return {k: {f: np.stack([_numpy(getattr(c, f)) for c in v])
                    for f in _CACHE_FIELDS} for k, v in state.items()}

    def fields(c):
        if hasattr(c, "pool"):
            return {"pool": {f: _numpy(getattr(c.pool, f))
                             for f in _POOL_FIELDS},
                    **{f: _numpy(getattr(c, f)) for f in _VIEW_FIELDS}}
        return {f: _numpy(getattr(c, f)) for f in _state_fields(c)}
    layers = [fields(c) for c in state]
    if len({getattr(getattr(c, "pool", None), "kv_dtype", None)
            for c in state}) > 1:
        period, n_groups, _ = pattern_layout(cfg)
        return {**{f"p{i}": layers[i:n_groups * period:period]
                   for i in range(period)},
                "tail": layers[n_groups * period:]}
    out = stack_layers({"layers": layers}, pattern_layout(cfg)[0], np.stack)
    blocks = out.pop("blocks")
    return {**blocks, "tail": out.get("tail", [])}


def serve_state_from_numpy(tree, state, cfg, mesh=None, specs=None):
    """Write the reference's serving state (numpy, the layout
    `serve_state_to_numpy` gives, whole) into ``state`` in place: one
    process's state of its shapes, or under ``mesh`` this rank's shards
    laid out by ``specs`` (`launch.specs.serve_state_specs`' first
    part), each cut from the numpy arrays. Returns ``state``."""
    if isinstance(state, dict):           # an encoder-decoder's two stacks
        for k, caches in state.items():
            layers = [{f: a[i] for f, a in tree[k].items()}
                      for i in range(len(caches))]
            _put_layers(layers, caches, mesh,
                        None if specs is None else specs[k])
        return state
    layers = unstack_layers({
        "blocks": {k: v for k, v in tree.items() if k != "tail"},
        "tail": list(tree.get("tail") or [])})["layers"]
    if len(layers) != len(state):
        raise ValueError(f"{len(layers)} layers for a state of {len(state)}")
    _put_layers(layers, state, mesh, specs)
    return state


def _put_layers(layers, state, mesh, specs) -> None:
    """Each layer's numpy fields (whole) into ``state``'s layer of the
    same index, in place; under ``mesh`` this rank's shard of each by
    ``specs``."""
    for i, (c, f) in enumerate(zip(state, layers)):
        sp = None if specs is None else specs[i]

        def put(dst, a, spec):
            a = np.asarray(a)
            if spec is not None:
                a = take_shard(a, spec, mesh)
            dst.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(
                dst.dtype))
        if hasattr(c, "pool"):
            for n in _POOL_FIELDS:
                put(getattr(c.pool, n), f["pool"][n],
                    None if sp is None else sp["pool"][n])
            for n in _VIEW_FIELDS:
                put(getattr(c, n), f[n], None if sp is None else sp[n])
            continue
        if not hasattr(c, "k_q"):
            for n in _state_fields(c):
                put(getattr(c, n), f[n], None if sp is None else sp[n])
            continue
        for n in _CACHE_FIELDS[:-1]:
            put(getattr(c, n), f[n], None if sp is None else sp[n])
        c.length = int(f["length"])
