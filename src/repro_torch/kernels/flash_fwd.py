"""Flash-attention forward: the CUDA kernel's launcher and its plain
PyTorch version (port of ``repro.kernels.flash_fwd._fwd_kernel``).

q (B, H, S, D); k/v (B, H_kv, T, D), all float32 or all bfloat16 ->
(out (B, H, S, D), m (B, H_kv, G, S, 1), l (B, H_kv, G, S, 1)) float32,
G = H / H_kv. Query i (absolute position kv_offset + i) attends to key j
iff j <= kv_offset + i (causal) and j > kv_offset + i - window (sliding).
m is each row's running max and l its softmax denominator (at least
1e-30, as the reference clamps it): what the backward of
`models.flash.flash_attention` recomputes probabilities from.

The numerics are those of the path the kernel serves on the card,
``repro.models.flash.flash_attention`` (not the Pallas kernel's
scale-after-dot): queries scaled by rsqrt(D) in float32 and rounded to
the K dtype, products of K-typed values summed in float32, probabilities
rounded to the V dtype before P.V. In float32 the two orders agree to
about an ulp.

The CUDA kernels (``csrc/flash_fwd.cu``) run on CUDA tensors: bfloat16
inputs on the tensor cores (bf16 products, float32 sums), float32 inputs
as float32 FMAs on the CUDA cores; both walk 64-key tiles. The plain
version is what a CPU tensor gets, and what the kernels are held against
(walked in the kernels' tiles: each probability is rounded to bf16 at the
running max of its own tile).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_attention import (HEAD_DIMS, _check,
                                                   _check_aligned, logit_scale)

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 64                     # query rows per kernel block


def flash_fwd_plain(q, k, v, causal: bool = True, window: int | None = None,
                    kv_offset: int = 0, kv_block: int = 512):
    """The blocked online-softmax forward walk of the reference, in
    ``kv_block`` slices of the kv axis (O(S * kv_block) memory per head).
    Returns (out, m, l) as the module docstring says."""
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
    l = torch.clamp_min(l, 1e-30)
    return (acc / l).reshape(B, H, S, d), m, l


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + \
    [ctypes.c_float, ctypes.c_void_p]


def flash_fwd_cuda(q, k, v, causal: bool = True, window: int | None = None,
                   kv_offset: int = 0, kv_block: int = 512):
    """Launch the CUDA kernel of q's dtype (same contract as the plain
    version; q, k, v contiguous, all float32 or all bfloat16; ``kv_block``
    is the plain version's and is not used: the kernels walk 64-key
    tiles). Counts each launch in ``flash_fwd_cuda.launches``."""
    B, H, S, D = q.shape
    _, Hkv, T, _ = k.shape
    G = H // Hkv if Hkv else 0
    if D not in HEAD_DIMS or not Hkv or H % Hkv or not 0 < G <= _ROWS:
        raise ValueError(f"flash forward kernel takes head_dim in {HEAD_DIMS} "
                         f"and H % H_kv == 0 with a group of at most {_ROWS} "
                         f"(got D={D}, H={H}, H_kv={Hkv})")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash forward kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    _check(q, "q", q.dtype)
    _check(k, "k", q.dtype, (B, Hkv, T, D))
    _check(v, "v", q.dtype, (B, Hkv, T, D))
    _check_aligned(q=q, k=k, v=v)
    fn = _build.load("flash_fwd", "flash_fwd", _ARGTYPES)
    out = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, Hkv, G, S, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hkv, G, S, 1), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, Hkv, G, S, T, D, _DTYPES[q.dtype],
            int(causal), int(window or 0), int(kv_offset), logit_scale(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash forward kernel launch failed: CUDA error "
                           f"{rc}")
    flash_fwd_cuda.launches += 1
    return out, m, l


flash_fwd_cuda.launches = 0
