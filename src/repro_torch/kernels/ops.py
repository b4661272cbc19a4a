"""Kernel entry points with dispatch by the tensor's device (port of
``repro.kernels.ops``).

A CUDA tensor launches the hand-written kernel — or raises; there is no
fallback — and a CPU tensor takes the kernel's plain PyTorch version.
The shapes and arguments are the reference's, so the tests call both
packages alike.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_fwd as _ff
from repro_torch.kernels import quant_attention as _qa
from repro_torch.kernels import quant_prefill as _qp
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels.quant_attention import logit_scale


def _route(t: torch.Tensor, cuda_fn, plain_fn):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no kernel for device {t.device}")


# -- quantization ------------------------------------------------------------

def quantize_per_channel(x):
    """(..., T, D) -> (int8 (..., T, D), float32 scales (..., D)); paper
    Eq. 5-7 in two passes (column absmax, then quantize)."""
    fn = _route(x, _quant.quantize_per_channel_cuda,
                _quant.quantize_per_channel_plain)
    return fn(x.float().contiguous())


def quantize_blocked(x, block_size: int = 256):
    """(..., T, D) -> (int8 (..., T, D), float32 (..., T // block_size,
    D)); absmax and quantize per (token block, channel) in one kernel."""
    fn = _route(x, _quant.quantize_blocked_cuda,
                _quant.quantize_blocked_plain)
    return fn(x.float().contiguous(), block_size)


def dequantize(x_q, scales, *, out_dtype=torch.float32):
    """int8 (..., T, D) x float32 scales (..., nb, D) or (..., D) ->
    (..., T, D) ``out_dtype``."""
    fn = _route(x_q, _quant.dequantize_cuda, _quant.dequantize_plain)
    return fn(x_q.contiguous(), scales.float().contiguous(), out_dtype)


# -- flash attention forward -------------------------------------------------

def flash_prefill(q, k, v, *, causal: bool = True, window: int | None = None,
                  kv_offset: int = 0, kv_block: int = 512):
    """Flash forward of `models.flash.flash_attention`: q (B, H, S, D);
    k/v (B, H_kv, T, D), one dtype (float32 or bfloat16; a CPU tensor
    takes any). Returns (out (B, H, S, D), m, l (B, H_kv, G, S, 1))
    float32; ``kv_block`` is the plain version's kv slice."""
    fn = _route(q, _ff.flash_fwd_cuda, _ff.flash_fwd_plain)
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
              kv_offset, kv_block)


# -- decode attention over the contiguous cache ------------------------------

def _per_row(v, B: int, device) -> torch.Tensor:
    """An int or a (B,)-broadcastable tensor as (B,) int32 on ``device``."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(device=device, dtype=torch.int32),
                                  (B,)).contiguous()
    return torch.full((B,), int(v), dtype=torch.int32, device=device)


def quant_attention_decode_partials(q, k_q, k_s, v_q, v_s, length, *,
                                    window=None):
    """Flash partials (o_unnormalized, m, l) of one query token per row
    over the int8 cache. q (B, H, D); k_q/v_q (B, H_kv, T, D) int8;
    k_s/v_s (B, H_kv, nb, D) float32 (nb = 1: per channel); ``length`` an
    int or (B,) tensor of absolute tokens written (a ring cache may exceed
    T); ``window`` masks ring slots by token age (None: no window).
    Returns (o (B, H, D), m (B, H, 1), l (B, H, 1)) float32."""
    B = q.shape[0]
    T = k_q.shape[2]
    fn = _route(q, _qa.flat_decode_partials_cuda,
                _qa.flat_decode_partials_plain)
    return fn(q.float().contiguous(), k_q.contiguous(),
              k_s.float().contiguous(), v_q.contiguous(),
              v_s.float().contiguous(), _per_row(length, B, q.device),
              _per_row(T if window is None else window, B, q.device))


def quant_attention_decode_partials_vmap(q, k_q, k_s, v_q, v_s, length, *,
                                         window=None,
                                         block_t: int | None = None):
    """The seed baseline: the partials of `quant_attention_decode_partials`
    from a kernel that reads and folds every slot of T (dead ones masked,
    not skipped). ``block_t`` is the reference's tile: it defaults as the
    reference's (T / nb per block; 256 per channel where it divides T)
    and must divide T into 1 or nb scale rows' worth of tiles; the CUDA
    kernel walks flat decode's splits instead, over the same slots."""
    B = q.shape[0]
    T, nb = k_q.shape[2], k_s.shape[2]
    if block_t is None:
        block_t = T // nb if nb > 1 else (256 if T % 256 == 0 else T)
    if T % block_t:
        raise ValueError(f"block_t={block_t} must divide T={T}")
    if nb not in (1, T // block_t):
        raise ValueError(f"scale rows {nb} incompatible with "
                         f"{T // block_t} token blocks")
    fn = _route(q, _qa.seed_decode_partials_cuda,
                _qa.flat_decode_partials_plain)
    return fn(q.float().contiguous(), k_q.contiguous(),
              k_s.float().contiguous(), v_q.contiguous(),
              v_s.float().contiguous(), _per_row(length, B, q.device),
              _per_row(T if window is None else window, B, q.device))


def quant_attention_decode(q, k_q, k_s, v_q, v_s, length, *, window=None):
    """Normalized decode attention over the int8 cache: (B, H, D) float32."""
    o, m, l = quant_attention_decode_partials(q, k_q, k_s, v_q, v_s, length,
                                              window=window)
    return o / torch.clamp_min(l, 1e-30)


# -- paged attention ---------------------------------------------------------


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
