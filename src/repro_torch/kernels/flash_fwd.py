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
running max of its own tile). On fake tensors (a cost trace,
`core.costing`) `flash_fwd_fake` gives the outputs' shapes and reports
the kernel's work (`flash_cost`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import costing
from repro_torch.kernels import _build, counted
from repro_torch.kernels.quant_attention import (FLAT_HEAD_DIMS, _check,
                                                   _check_aligned, logit_scale)

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 64                     # query rows per kernel block


def live_pairs(S: int, T: int, causal: bool = True,
               window: int | None = None, kv_offset: int = 0) -> int:
    """The (query, key) pairs a head attends: query i at kv_offset + i
    sees the keys j < T with j <= kv_offset + i (causal) and j >
    kv_offset + i - window."""
    pos = kv_offset + np.arange(S, dtype=np.int64)
    hi = np.minimum(pos + 1, T) if causal else np.full(S, T)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_cost(B: int, H: int, Hkv: int, S: int, T: int, D: int,
               itemsize: int, causal: bool = True, window: int | None = None,
               kv_offset: int = 0) -> tuple[int, int]:
    """(bytes, operations) of the flash forward kernel: q, k, v read once
    (``itemsize`` bytes an element), out, m and l written (float32); 4 D
    operations a live (query, key) pair a head (Q.K and P.V)."""
    nbytes = ((B * H * S + 2 * B * Hkv * T) * D * itemsize
              + B * H * S * D * 4 + 2 * B * H * S * 4)
    return nbytes, 4 * D * B * H * live_pairs(S, T, causal, window,
                                              kv_offset)


def flash_fwd_fake(q, k, v, causal: bool = True, window: int | None = None,
                   kv_offset: int = 0, kv_block: int = 512):
    """The kernel on fake tensors: its outputs' shapes, its work reported
    (bf16 inputs on the tensor cores, float32 on the CUDA cores)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    costing.kernel("flash_fwd", *flash_cost(
        B, H, Hkv, S, T, D, q.element_size(), causal, window, kv_offset),
        f32=q.dtype == torch.float32)
    f = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                   device=q.device)
    return f(B, H, S, D), f(B, Hkv, H // Hkv, S, 1), f(B, Hkv, H // Hkv, S, 1)


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
    if D not in FLAT_HEAD_DIMS or not Hkv or H % Hkv or not 0 < G <= _ROWS:
        raise ValueError(f"flash forward kernel takes head_dim in "
                         f"{FLAT_HEAD_DIMS} "
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


counted(flash_fwd_cuda)
