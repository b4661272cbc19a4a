"""Token-choice top-k Mixture-of-Experts (port of ``repro.models.moe``:
without a mesh the reference's ``_apply_local``, under one its
``_apply_shard_map``; qwen2-moe's shared experts included).

Under a mesh each rank routes the rows of its data shard over the WHOLE
sequence (gathered over "model"; the capacity comes from the full S), with
the experts' d-axis shards gathered over the FSDP axes and their hidden
dim left sharded over "model": the down-projection's partial sums are
summed over "model" in the storage dtype (a reduce-scatter back to the
sequence shards, or an all-reduce where the sequence is whole), and the
aux loss is this rank's share of the mean over every row (the
reference's ``pmean``). Tokens never leave their data shard.

Dispatch is the reference's capacity-bounded scatter/gather, per batch
row: each row's S * k assignments (row-major over (S, k)) take slots by a
cumsum of their one-hot experts; an assignment past its expert's capacity
C is dropped (its input and weight zero, its slot (0, C - 1), as the
reference's). Every expert runs a dense SwiGLU over its C slots of every
row, one batched matmul over all rows at once, and the outputs are
combined with the renormalized top-k probabilities in the storage dtype
with float32 accumulation.

It runs inside a captured CUDA graph: static shapes only (C comes from
S), no host sync (no ``nonzero``, boolean-mask indexing or ``.item()``),
and the scatter writes each kept slot once, so a replay gives the eager
result bit for bit. The expert products are plain matmuls, as the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import mlp
from repro_torch.models.common import dense_init
from repro_torch.parallel.shard import gather_param


def init(cfg, gen: torch.Generator, device) -> dict:
    d, E, dt = cfg.d_model, cfg.n_experts, cfg.activation_dtype
    eff = cfg.moe_d_ff or cfg.d_ff
    p = {"router": dense_init(gen, d, E, torch.float32, device),
         "w_gate": _stack_init(gen, E, d, eff, dt, device),
         "w_up": _stack_init(gen, E, d, eff, dt, device),
         "w_down": _stack_init(gen, E, eff, d, dt, device)}
    if cfg.n_shared_experts:
        p["shared"] = mlp.init(cfg, gen, device,
                               d_ff=eff * cfg.n_shared_experts)
        p["shared_gate"] = dense_init(gen, d, 1, torch.float32, device)
    return p


def _stack_init(gen, E, din, dout, dt, device) -> torch.Tensor:
    w = torch.randn((E, din, dout), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / math.sqrt(din))).to(dt)


def capacity(cfg, S: int) -> int:
    """Slots an expert has in a row of S tokens (the reference's rule,
    Python's round: half to even)."""
    return int(max(8, round(cfg.top_k * S / cfg.n_experts
                            * cfg.capacity_factor)))


def route(p, x, cfg, C: int) -> dict:
    """The routing of x (B, S, d) at capacity C, per row: ``top_p`` /
    ``top_e`` (B, S, k) (probabilities renormalized over the top k),
    ``slot`` (B, S * k) each assignment's slot, ``keep`` (B, S * k) bool,
    and ``aux`` (B,) the Switch load-balancing loss."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(x.float() @ p["router"], dim=-1)     # (B, S, E)
    top_p, top_e = torch.topk(probs, k, dim=-1)                # descending
    top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e = top_e.reshape(B, S * k)
    # a one-hot by comparison: F.one_hot checks its input's range on the
    # host, a sync
    onehot = (flat_e[..., None] == torch.arange(
        E, device=x.device)).to(torch.int32)                   # (B, S*k, E)
    me = probs.mean(1)
    ce = onehot.sum(1).float() / (S * k)
    aux = E * (me * ce).sum(-1)
    # slot of an assignment: the earlier assignments to its expert
    slot = torch.gather(torch.cumsum(onehot, 1) - onehot, 2,
                        flat_e[..., None])[..., 0]
    return {"top_p": top_p, "top_e": top_e, "slot": slot,
            "keep": slot < C, "aux": aux}


def _apply_routed(p, x, cfg):
    """x (B, S, d) -> (out (B, S, d) float32, aux ())."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    r = route(p, x, cfg, C)
    keep = r["keep"]
    e_idx = torch.where(keep, r["top_e"].reshape(B, S * k), 0)
    s_idx = torch.where(keep, r["slot"], C - 1)
    # kept assignments own distinct slots; the dropped ones all write
    # zeros into one extra slot, E * C, so every value written is the
    # reference's and no slot sums anything
    dest = torch.where(keep, e_idx * C + s_idx, E * C)
    src = torch.where(keep[..., None], x.repeat_interleave(k, dim=1),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(B, S * k, d), src)
    # every expert over its slots of every row: (E, B * C, d) batched
    xe = buf[:, :E * C].reshape(B, E, C, d).transpose(0, 1).reshape(
        E, B * C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    y = torch.bmm(h, p["w_down"]).reshape(E, B, C, d).transpose(0, 1)
    out_flat = torch.gather(y.reshape(B, E * C, d), 1,
                            (e_idx * C + s_idx)[..., None].expand(
                                B, S * k, d))             # (B, S*k, d)
    # combine in the storage dtype, float32 sums: a product of two bf16
    # values is exact in float32
    w = (r["top_p"].reshape(B, S * k) * keep).to(x.dtype)
    out = (out_flat.float() * w.float()[..., None]).reshape(
        B, S, k, d).sum(2)
    return out, r["aux"].mean()


def _apply_sharded(p, x, cfg, lay, sp):
    """`_apply_routed` under a mesh -> (out in x's dtype and ``lay``,
    this rank's share of aux)."""
    mesh = lay.mesh
    tp = sp["w_gate"][2]                      # the expert hidden axes
    routed = {k: gather_param(p[k], sp[k], mesh,
                              keep=() if k == "router" else tp)
              for k in ("router", "w_gate", "w_up", "w_down")}
    out, aux = _apply_routed(routed, lay.whole_seq(x), cfg)
    return lay.to_layout(out.to(x.dtype), tp), aux / mesh.size


def apply(p, x: torch.Tensor, cfg, lay=None, sp=None):
    """x (B, S, d) -> (out (B, S, d) in x's dtype, aux_loss ()). Under a
    mesh (``lay``, ``sp`` the specs of p's leaves) x and out are this
    rank's part of ``lay`` and aux is this rank's share (the shares of all
    ranks sum to the mean over every row)."""
    if lay is None:
        out, aux = _apply_routed(p, x, cfg)
    else:
        out, aux = _apply_sharded(p, x, cfg, lay, sp)
    if cfg.n_shared_experts:
        gate = p["shared_gate"] if lay is None else gather_param(
            p["shared_gate"], sp["shared_gate"], lay.mesh)
        g = torch.sigmoid(x.float() @ gate)
        out = out + g * mlp.apply(p["shared"], x, lay,
                                  None if sp is None else sp["shared"]).float()
    return out.to(x.dtype), aux
