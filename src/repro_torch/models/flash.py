"""Blocked (flash-style) attention forward in plain PyTorch (port of the
forward of ``repro.models.flash.flash_attention``): the prompt attention
of the contiguous prefill.

The kv axis is walked in ``kv_block`` slices carrying the online-softmax
state (m, l, acc), so memory is O(S * kv_block) per head. As in the
reference, queries are scaled by rsqrt(d) in float32 and rounded to the
K/V storage dtype before the dot products, probabilities are rounded to
the V dtype before the second product, and both products accumulate in
float32. No backward: training is not ported.
"""
from __future__ import annotations

import torch

_NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    kv_offset: int = 0, kv_block: int = 512) -> torch.Tensor:
    """q (B, H, S, d); k/v (B, H_kv, T, d) -> (B, H, S, d) float32.

    GQA broadcast: H = H_kv * G. Query position i attends to kv position j
    iff j <= i + kv_offset (causal) and j > i + kv_offset - window
    (sliding)."""
    B, H, S, d = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = H // Hkv
    kv_block = min(kv_block, T)
    nblk = -(-T // kv_block)
    scale = torch.rsqrt(torch.tensor(float(d), dtype=torch.float32))
    qg = (q.reshape(B, Hkv, G, S, d).float() * scale.to(q.device))
    qg = qg.to(k.dtype).float()
    qpos = kv_offset + torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hkv, G, S, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, S, d), dtype=torch.float32, device=q.device)
    for blk in range(nblk):
        lo, hi = blk * kv_block, min(T, (blk + 1) * kv_block)
        kb = k[:, :, lo:hi].float()
        vb = v[:, :, lo:hi]
        logits = torch.einsum("bhgsd,bhtd->bhgst", qg, kb)
        kpos = torch.arange(lo, hi, device=q.device)[None]
        mask = torch.ones((S, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
        m_new = torch.maximum(m, torch.amax(logits, dim=-1, keepdim=True))
        p = torch.exp(logits - m_new) * mask.float()
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgst,bhtd->bhgsd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, H, S, d)
