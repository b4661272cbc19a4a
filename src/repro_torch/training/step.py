"""The training step (port of ``repro.training.step``).

`make_train_step(cfg, opt_cfg, ...)` returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
with optional microbatch gradient accumulation (in float32, as the
reference's scan) and optional INT8 gradient compression with error
feedback (`optim.compression`). The parameters and optimizer state are
updated in place (`optim.adamw.apply_updates`) and returned. Under
`parallel.shard.mesh_context` they are this rank's shards, laid out by
the ``specs`` given to `make_train_step` (`launch.specs.train_specs`),
and every layer below takes its specs from there.

batch = {"tokens": (B, S) int, "labels": (B, S) int} tensors on the
parameters' device; an encoder-decoder adds "frames" (B, T_enc, d), and a
config with ``embedding_inputs`` may give "embeds" (B, S, d) in place of
the tokens as the model's input.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.costing import host_loop
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import encdec, transformer
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.parallel.shard import (Layout, current_mesh, spec_leaves,
                                        unused_axes)
from repro_torch.training.loss import next_token_loss, next_token_loss_sharded

AUX_WEIGHT = 0.01   # load-balancing loss weight (Switch default scale)


def _forward(params, batch, cfg, specs=None):
    """The model's (logits, aux) on ``batch``: an encoder-decoder's on its
    frames and tokens, a decoder's on its tokens or embeddings (under a
    mesh this rank's block, ``specs`` the parameters')."""
    if cfg.family == "encdec":
        return encdec.forward_train(params, batch["frames"], batch["tokens"],
                                    cfg, specs=specs)
    return transformer.forward_train(
        params, batch.get("embeds", batch["tokens"]), cfg, specs=specs)


def loss_fn(params, batch, cfg):
    """-> (loss + AUX_WEIGHT * aux, {"loss", "aux_loss"})."""
    logits, aux = _forward(params, batch, cfg)
    loss = next_token_loss(logits, batch["labels"], cfg.vocab)
    return loss + AUX_WEIGHT * aux, {"loss": loss, "aux_loss": aux}


def loss_fn_sharded(params, batch, cfg, mesh, specs):
    """This rank's share of `loss_fn` on the global ``batch`` under
    ``mesh`` (``specs`` the parameters') -> (share, {"loss", "aux_loss"}
    shares)."""
    labels = batch["labels"]
    B, S = labels.shape
    logits, aux = _forward(params, batch, cfg, specs)
    lay = Layout.of(mesh, B, S, cfg.d_model)
    vax = transformer.logits_spec(cfg, B, S, mesh)[2]
    loss = next_token_loss_sharded(logits, labels[lay.rows()], cfg.vocab,
                                   lay, vax, (labels >= 0).sum())
    return loss + AUX_WEIGHT * aux, {"loss": loss, "aux_loss": aux}


def _grads(params, batch, cfg, mesh=None, specs=None):
    """Gradients of `loss_fn` in the parameters' layout and dtypes, and
    its metrics (detached); under ``mesh`` this rank's shares of both,
    the metrics summed over every rank."""
    if mesh is None:
        total, metrics = loss_fn(params, batch, cfg)
    else:
        total, metrics = loss_fn_sharded(params, batch, cfg, mesh, specs)
    g = torch.autograd.grad(total, leaves(params))
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mesh is not None:
        metrics = {k: mesh.all_reduce(v, mesh.axis_names)
                   for k, v in metrics.items()}
    return unflatten(params, g), metrics


@torch.no_grad()
def _sum_replicated(grads, specs, mesh):
    """Each gradient leaf all-reduced over the axes its parameter is
    replicated on (every rank there holds a share), in place."""
    for g, spec in zip(leaves(grads), spec_leaves(specs)):
        axes = unused_axes(spec, mesh)
        if axes:
            g.copy_(mesh.all_reduce(g, axes))


def make_train_step(cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    grad_compression: bool = False, specs=None):
    """``specs``: where the step runs under a mesh of several ranks, the
    `launch.specs.train_specs` of ``cfg`` on it ({"params", "opt"})."""
    def train_step(params, opt_state, batch):
        mesh = current_mesh()
        if mesh is not None and specs is None:
            raise ValueError("a step under a mesh needs specs= "
                             "(launch.specs.train_specs)")
        psp = None if mesh is None else specs["params"]
        for p in leaves(params):
            p.requires_grad_(True)
        if microbatches == 1:
            grads, metrics = _grads(params, batch, cfg, mesh, psp)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            mb = B // microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in host_loop(microbatches, closed=True):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, metrics = _grads(params, part, cfg, mesh, psp)
                for a, x in zip(leaves(grads), leaves(g)):
                    a.add_(x)
                del g
            for a in leaves(grads):
                a.div_(microbatches)
        if mesh is not None:
            _sum_replicated(grads, psp, mesh)
        if grad_compression:
            grads, err = C.compress_with_feedback(
                grads, opt_state["grad_err"], cfg, mesh,
                None if mesh is None else specs["opt"]["grad_err"])
        params, inner, om = apply_updates(params, grads, opt_state["adam"],
                                          opt_cfg, specs=psp, mesh=mesh)
        new_opt: dict[str, Any] = {"adam": inner}
        if grad_compression:
            new_opt["grad_err"] = err
        metrics.update(om)
        return params, new_opt, metrics

    return train_step


def init_opt_state(params, cfg, *, grad_compression: bool = False) -> dict:
    """AdamW's state, and with ``grad_compression`` the error state in the
    reference's layout of ``cfg``."""
    st: dict[str, Any] = {"adam": init_state(params)}
    if grad_compression:
        st["grad_err"] = C.init_error_state(params, cfg)
    return st
