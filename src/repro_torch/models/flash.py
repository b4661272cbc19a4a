"""Blocked (flash-style) attention with its backward (port of
``repro.models.flash.flash_attention`` and its ``custom_vjp``): the
attention of training and of the contiguous prefill.

Forward: `kernels.ops.flash_prefill` — the CUDA kernel on a CUDA tensor,
the plain blocked walk on a CPU tensor. Queries are scaled by rsqrt(d) in
float32 and rounded to the K/V dtype before the dot products,
probabilities are rounded to the V dtype before the second product, and
both products accumulate in float32. It saves (q, k, v, out, m, l).

Backward: a PyTorch port of the reference's ``_flash_bwd`` — the same walk
over ``kv_block`` slices, recomputing each slice's probabilities from the
saved m and l with the forward's bf16-rounded dot, the ``Drow`` rowsum
term, and dq scaled once more by rsqrt(d). It stays plain PyTorch (its
products go to ``torch.einsum``) because the reference has no backward
kernel either: its backward is a jnp scan left to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

_NEG_INF = -1e30


def _mask_for(lo: int, hi: int, qpos, T: int, causal: bool, window):
    """(S, hi - lo) live mask of kv slots lo..hi-1 (slots >= T are the
    padding of the last slice)."""
    kpos = torch.arange(lo, hi, device=qpos.device)[None]
    mask = kpos < T
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _flash_bwd(q, k, v, out, m, l, dout, causal, window, kv_offset,
               kv_block):
    B, H, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    kv_block = min(kv_block, T)
    nblk = -(-T // kv_block)
    pad = nblk * kv_block - T
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    scale = torch.rsqrt(torch.tensor(float(d), dtype=torch.float32)).to(
        q.device)
    qg = q.reshape(B, Hkv, G, S, d).float() * scale
    qk = qg.to(k.dtype).float()          # the forward's rounded queries
    og = out.reshape(B, Hkv, G, S, d).float()
    dog = dout.reshape(B, Hkv, G, S, d).float()
    qpos = kv_offset + torch.arange(S, device=q.device)[:, None]
    # D_i = sum_d dout_i * out_i (the softmax backward's rowsum term)
    drow = torch.sum(dog * og, dim=-1, keepdim=True)
    dq = torch.zeros((B, Hkv, G, S, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for blk in range(nblk):
        lo, hi = blk * kv_block, (blk + 1) * kv_block
        kb, vb = k[:, :, lo:hi], v[:, :, lo:hi]
        logits = torch.einsum("bhgsd,bhtd->bhgst", qk, kb.float())
        mask = _mask_for(lo, hi, qpos, T, causal, window)
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
        p = torch.exp(logits - m) / l * mask.float()
        dp = torch.einsum("bhgsd,bhtd->bhgst", dog, vb.float())
        ds = p * (dp - drow)
        dq = dq + torch.einsum("bhgst,bhtd->bhgsd", ds, kb.float())
        dks.append(torch.einsum("bhgst,bhgsd->bhtd", ds, qg))
        dvs.append(torch.einsum("bhgst,bhgsd->bhtd", p, dog))
    # qg already carries the rsqrt(d) scale: dk (through qg) needs no
    # rescale, dq one more factor of it
    dq = (dq * scale).reshape(B, H, S, d).to(q.dtype)
    dk = torch.cat(dks, dim=2)[:, :, :T].to(k.dtype)
    dv = torch.cat(dvs, dim=2)[:, :, :T].to(v.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_offset, kv_block):
        out, m, l = ops.flash_prefill(q, k, v, causal=causal, window=window,
                                      kv_offset=kv_offset, kv_block=kv_block)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, window, kv_offset, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, m, l, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    kv_offset: int = 0, kv_block: int = 512) -> torch.Tensor:
    """q (B, H, S, d); k/v (B, H_kv, T, d) -> (B, H, S, d) float32.

    GQA broadcast: H = H_kv * G. Query position i attends to kv position j
    iff j <= i + kv_offset (causal) and j > i + kv_offset - window
    (sliding). Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, window, kv_offset,
                                 kv_block)
