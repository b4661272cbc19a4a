"""The training step (port of ``repro.training.step``).

`make_train_step(cfg, opt_cfg, ...)` returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
with optional microbatch gradient accumulation (in float32, as the
reference's scan) and optional INT8 gradient compression with error
feedback (`optim.compression`). The parameters and optimizer state are
updated in place (`optim.adamw.apply_updates`) and returned.

batch = {"tokens": (B, S) int, "labels": (B, S) int} tensors on the
parameters' device; an encoder-decoder adds "frames" (B, T_enc, d), and a
config with ``embedding_inputs`` may give "embeds" (B, S, d) in place of
the tokens as the model's input.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import encdec, transformer
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state
from repro_torch.training.loss import next_token_loss

AUX_WEIGHT = 0.01   # load-balancing loss weight (Switch default scale)


def loss_fn(params, batch, cfg):
    """-> (loss + AUX_WEIGHT * aux, {"loss", "aux_loss"})."""
    if cfg.family == "encdec":
        logits, aux = encdec.forward_train(params, batch["frames"],
                                           batch["tokens"], cfg)
    else:
        inp = batch.get("embeds", batch["tokens"])
        logits, aux = transformer.forward_train(params, inp, cfg)
    loss = next_token_loss(logits, batch["labels"], cfg.vocab)
    return loss + AUX_WEIGHT * aux, {"loss": loss, "aux_loss": aux}


def _grads(params, batch, cfg):
    """Gradients of `loss_fn` in the parameters' layout and dtypes, and
    its metrics (detached)."""
    total, metrics = loss_fn(params, batch, cfg)
    g = torch.autograd.grad(total, leaves(params))
    return unflatten(params, g), {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    grad_compression: bool = False):
    def train_step(params, opt_state, batch):
        for p in leaves(params):
            p.requires_grad_(True)
        if microbatches == 1:
            grads, metrics = _grads(params, batch, cfg)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            mb = B // microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                g, metrics = _grads(params, part, cfg)
                for a, x in zip(leaves(grads), leaves(g)):
                    a.add_(x)
                del g
            for a in leaves(grads):
                a.div_(microbatches)
        if grad_compression:
            grads, err = C.compress_with_feedback(grads, opt_state["grad_err"],
                                                  cfg)
        params, inner, om = apply_updates(params, grads, opt_state["adam"],
                                          opt_cfg)
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
