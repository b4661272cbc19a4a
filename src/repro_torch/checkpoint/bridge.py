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
  "params" and "opt"): each rank then takes its shards straight from the
  numpy arrays, with no whole copy on the device.
- `reference_layout`: the port's layout -> the reference's, by the
  config (what `optim.compression` keeps its error state in).
- `tree_to_numpy`: the port's parameters (or moments, master weights,
  error state) -> the reference's stacked layout (with the config, its
  pattern's period and tail; an encoder-decoder's two stacks), float32
  numpy, for leaf-by-leaf comparison.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import leaves, tree_map
from repro_torch.models import encdec
from repro_torch.models.transformer import (check_distributable,
                                            pattern_layout, stack_layers,
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


def _unstack(stack) -> list:
    """A stacked tree (leading layer axis) -> one copy a layer."""
    n = leaves(stack)[0].shape[0]
    return [tree_map(lambda x, i=i: x[i].clone(), stack) for i in range(n)]


def _encdec_layout(tree, cfg, device, dtype_of) -> dict:
    """The reference's encoder-decoder tree -> the port's, the stacks as
    per-layer lists."""
    got = {k: int(np.asarray(tree[k]["norm1"]["scale"]).shape[0])
           for k, _ in encdec.STACKS}
    want = {"enc_blocks": cfg.n_encoder_layers, "dec_blocks": cfg.n_layers}
    if got != want:
        raise ValueError(f"expected {want} stacked layers, got {got}")
    port = _conv(tree, dtype_of, device)
    for ref_key, port_key in encdec.STACKS:
        port[port_key] = _unstack(port.pop(ref_key))
    return port


def _port_layout(tree, cfg, device, dtype_of, mesh=None,
                 specs=None) -> dict:
    """Reference layout -> port layout; each leaf a tensor of
    ``dtype_of(is_float32_leaf)``, layers as copies (not views of a
    stack); under ``mesh`` this rank's shards of ``specs``."""
    if cfg.family == "encdec":
        if mesh is not None:
            check_distributable(cfg, mesh)
        return _encdec_layout(tree, cfg, device, dtype_of)
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
