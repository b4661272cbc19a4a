"""Paged chunk-prefill attention over the quantized page pool: the CUDA
kernel's launcher and its plain PyTorch version.

Port of ``repro.kernels.quant_prefill._prefill_kernel``: a chunk of C
queries per row, the GQA group stacked as G*C rows (row r is chunk
position r % C of head-group lane r // C) and pre-scaled by rsqrt(D),
attends over the row's ``hist_len`` history tokens (walking at most
``hist_blocks`` pages of its page table, dequantized to float32) and then
over the chunk's own float32 K/V under causal and ``kpos < valid``
masking. Outputs are NORMALIZED (divided by max(l, 1e-30)); rows past
``valid`` are garbage the caller discards.

The CUDA kernel (``csrc/paged_prefill.cu``) runs on CUDA tensors; the plain
version is what a CPU tensor gets, and what the kernel is held against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import _build
from repro_torch.kernels.quant_attention import (HEAD_DIMS, KV_CODES,
                                                 _check, page_dequant)

_NEG_INF = -1e30


def paged_prefill_plain(qg, kc, vc, pool_kq, pool_ks, pool_vq, pool_vs,
                        page_table, hist_len, valid, hist_blocks: int,
                        kv_dtype="int8"):
    """qg (B, H_kv, G*C, D) float32 pre-scaled queries; kc/vc (B, H_kv, C,
    D) float32; pool_* (P, ps_packed, H_kv, D) / (P, H_kv, D); page_table
    (B, >= hist_blocks) int32; hist_len/valid (B,) int32. Returns the
    normalized (B, H_kv, G*C, D) float32."""
    B, Hkv, GC, D = qg.shape
    C = kc.shape[2]
    dev = qg.device
    qpos = torch.arange(GC, device=dev) % C
    kpos = torch.arange(C, device=dev)
    logits = torch.einsum("bhrd,bhtd->bhrt", qg, kc)
    mask = ((kpos[None, :] <= qpos[:, None])[None, None]
            & (kpos < valid.to(dev)[:, None])[:, None, None, :])
    vals = vc
    if hist_blocks:
        tbl = page_table[:, :hist_blocks].long()
        kh = page_dequant(pool_kq[tbl], pool_ks[tbl], kv_dtype)
        vh = page_dequant(pool_vq[tbl], pool_vs[tbl], kv_dtype)
        T = kh.shape[1] * kh.shape[2]
        kh = kh.reshape(B, T, Hkv, D)
        vh = vh.reshape(B, T, Hkv, D).permute(0, 2, 1, 3)
        lh = torch.einsum("bhrd,bthd->bhrt", qg, kh)
        mh = (torch.arange(T, device=dev)[None]
              < hist_len.to(dev)[:, None])[:, None, None, :]
        logits = torch.cat([lh, logits], dim=-1)
        mask = torch.cat([mh.expand(B, Hkv, GC, T),
                          mask.expand(B, Hkv, GC, C)], dim=-1)
        vals = torch.cat([vh, vc], dim=2)
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask.float()
    l = p.sum(-1, keepdim=True)
    return torch.einsum("bhrt,bhtd->bhrd", p, vals) / torch.clamp_min(
        l, 1e-30)


_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def paged_prefill_cuda(qg, kc, vc, pool_kq, pool_ks, pool_vq, pool_vs,
                       page_table, hist_len, valid, hist_blocks: int,
                       kv_dtype="int8"):
    """Launch the CUDA kernel (same contract as the plain version). Counts
    each launch in ``paged_prefill_cuda.launches``."""
    B, Hkv, GC, D = qg.shape
    C = kc.shape[2]
    P, ps_packed, _, _ = pool_kq.shape
    ps = 2 * ps_packed if kv_dtype == "int4" else ps_packed
    NT = page_table.shape[1]
    if D not in HEAD_DIMS or GC % C:
        raise ValueError(f"paged prefill kernel takes head_dim in "
                         f"{HEAD_DIMS} and G*C rows (got D={D}, rows={GC}, "
                         f"C={C})")
    if not 0 <= hist_blocks <= NT:
        raise ValueError(f"hist_blocks={hist_blocks} outside the page "
                         f"table's {NT} entries")
    store = Q.kv_storage_dtype(kv_dtype)
    _check(qg, "qg", torch.float32)
    _check(kc, "k", torch.float32, (B, Hkv, C, D))
    _check(vc, "v", torch.float32, (B, Hkv, C, D))
    _check(pool_kq, "pool_kq", store, (P, ps_packed, Hkv, D))
    _check(pool_vq, "pool_vq", store, (P, ps_packed, Hkv, D))
    _check(pool_ks, "pool_ks", torch.float32, (P, Hkv, D))
    _check(pool_vs, "pool_vs", torch.float32, (P, Hkv, D))
    _check(page_table, "page_table", torch.int32, (B, NT))
    _check(hist_len, "hist_len", torch.int32, (B,))
    _check(valid, "valid", torch.int32, (B,))
    fn = _build.load("paged_prefill", "paged_prefill", _ARGTYPES)
    out = torch.empty_like(qg)
    rc = fn(qg.data_ptr(), kc.data_ptr(), vc.data_ptr(), pool_kq.data_ptr(),
            pool_ks.data_ptr(), pool_vq.data_ptr(), pool_vs.data_ptr(),
            page_table.data_ptr(), hist_len.data_ptr(), valid.data_ptr(),
            out.data_ptr(), B, Hkv, GC, C, D, ps, ps_packed, NT, hist_blocks,
            KV_CODES[kv_dtype],
            torch.cuda.current_stream(qg.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged prefill kernel launch failed: CUDA error "
                           f"{rc}")
    paged_prefill_cuda.launches += 1
    return out


paged_prefill_cuda.launches = 0
