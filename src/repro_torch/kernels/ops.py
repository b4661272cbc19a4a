"""Kernel entry points with dispatch by the tensor's device (port of
``repro.kernels.ops``, paged subset).

A CUDA tensor launches the hand-written kernel — or raises; there is no
fallback — and a CPU tensor takes the kernel's plain PyTorch version.
The shapes and arguments are the reference's, so the tests call both
packages alike.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import quant_attention as _qa
from repro_torch.kernels import quant_prefill as _qp
from repro_torch.kernels.quant_attention import logit_scale


def _route(t: torch.Tensor, cuda_fn, plain_fn):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no kernel for device {t.device}")


def paged_attention_decode_partials(q, pool_kq, pool_ks, pool_vq, pool_vs,
                                    page_table, lengths, *,
                                    kv_dtype: str = "int8"):
    """Flash partials over a quantized page pool through per-row page
    tables. q (B, H, D); pool_kq/vq (P, ps_packed, H_kv, D) in
    ``kv_dtype`` storage; pool_ks/vs (P, H_kv, D) float32; page_table
    (B, NT) int32; lengths (B,) int32 — per-row tokens to attend (the
    flushed prefix; the residual tail merges separately). Returns
    (o_unnormalized (B, H, D), m (B, H, 1), l (B, H, 1)) float32."""
    fn = _route(q, _qa.paged_decode_partials_cuda,
                _qa.paged_decode_partials_plain)
    return fn(q.float().contiguous(), pool_kq, pool_ks, pool_vq, pool_vs,
              page_table.to(torch.int32).contiguous(),
              lengths.to(torch.int32).contiguous(), kv_dtype)


def paged_attention_prefill(q, k, v, pool_kq, pool_ks, pool_vq, pool_vs,
                            page_table, hist_len, valid=None, *,
                            hist_blocks: int, kv_dtype: str = "int8"):
    """Varlen chunk-prefill attention over the quantized page pool.

    q (B, H, C, D) chunk queries; k/v (B, H_kv, C, D) the chunk's own K/V;
    pool_* as in `paged_attention_decode_partials`; page_table (B, NT)
    int32; hist_len (B,) int32 resident history per row; valid (B,) int32
    true chunk tokens per row (None = C); ``hist_blocks`` bounds the
    history walk. Returns normalized (B, H, C, D) float32; outputs past
    ``valid`` are garbage the caller discards."""
    B, H, C, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = (q.reshape(B, Hkv, G * C, D).float() * logit_scale(D)).contiguous()
    i32 = lambda a: a.to(device=q.device, dtype=torch.int32).contiguous()
    if valid is None:
        valid = torch.full((B,), C, dtype=torch.int32, device=q.device)
    fn = _route(q, _qp.paged_prefill_cuda, _qp.paged_prefill_plain)
    out = fn(qg, k.float().contiguous(), v.float().contiguous(), pool_kq,
             pool_ks, pool_vq, pool_vs, i32(page_table), i32(hist_len),
             i32(valid), hist_blocks, kv_dtype)
    return out.reshape(B, H, C, D)
