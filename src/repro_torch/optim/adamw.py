"""AdamW and its learning-rate schedule (port of ``repro.optim.adamw``).

State mirrors the parameters: {m, v, master} in float32 whatever the
parameters' dtype (bf16 parameters, float32 moments and master weights)
and a step counter (int32). Unlike the reference's pure functions,
`apply_updates` updates the parameters, moments and master weights IN
PLACE (the port's own tensors), so a step at full width holds one copy of
each; it returns them too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """step (int tensor) -> lr (float32): linear warmup, then a cosine
    decay to ``min_lr_ratio * lr`` at ``total_steps``."""
    def lr(step):
        step = step.float()
        warm = cfg.lr * step / max(cfg.warmup_steps, 1)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        cos = cfg.min_lr_ratio * cfg.lr + (1 - cfg.min_lr_ratio) * cfg.lr * \
            0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def init_state(params) -> dict:
    """Zero moments and float32 master copies (never aliasing a float32
    parameter) of every leaf; step 0 on the parameters' device."""
    device = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
            "master": tree_map(lambda p: p.detach().float().clone(), params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(x.float() ** 2) for x in leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step with global-norm clipping, in place (see the module
    docstring). Returns (params, state, {"grad_norm", "lr"}). Each leaf
    goes through two float32 buffers of its size, whatever its dtype:
    the reference's expression evaluated operation by operation, in its
    order, into them (the same roundings as the expression's temporaries,
    without their memory: the largest leaf of a model with a 256000-token
    vocabulary is 4.2 GB in float32)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    lr = cosine_schedule(cfg)(step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v, master in zip(leaves(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"]),
                                  leaves(state["master"])):
        g = g.to(torch.float32, copy=True).mul_(scale)  # g * scale
        t = torch.mul(g, 1 - b1)
        m.mul_(b1).add_(t)                              # b1 m + (1 - b1) g
        torch.mul(g, 1 - b2, out=t).mul_(g)
        v.mul_(b2).add_(t)                              # b2 v + (1 - b2) g g
        torch.div(v, bc2, out=t).sqrt_().add_(cfg.eps)  # sqrt(v / bc2) + eps
        torch.div(m, bc1, out=g).div_(t)                # m / bc1 / that
        g.add_(torch.mul(master, cfg.weight_decay, out=t)).mul_(lr)
        master.sub_(g)                                  # - lr (.. + wd master)
        p.copy_(master)
        del g, t
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
