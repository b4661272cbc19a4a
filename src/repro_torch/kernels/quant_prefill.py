"""Paged chunk-prefill attention over the quantized page pool: the CUDA
kernel's launcher and its plain PyTorch version.

Port of ``repro.kernels.quant_prefill._prefill_kernel``: a chunk of C
queries per row, the GQA group stacked as G*C rows (row r is chunk
position r % C of head-group lane r // C) and pre-scaled by rsqrt(D),
attends over the row's ``hist_len`` history tokens (walking at most
``hist_blocks`` pages of its page table, dequantized to float32) and then
over the chunk's own float32 K/V under causal and ``kpos < valid``
masking. Outputs are NORMALIZED (divided by max(l, 1e-30)); the caller
discards rows past ``valid``.

The CUDA kernel (``csrc/paged_prefill.cu``) runs on CUDA tensors; the plain
version is what a CPU tensor gets, and what the kernel is held against. The
kernel runs its products on the tensor cores with every float operand split
into three bf16 terms; `paged_prefill_split_plain` is that arithmetic in
plain PyTorch, walked in the kernel's tiles, for the tests.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import _build
from repro_torch.kernels.quant_attention import (HEAD_DIMS, KV_CODES,
                                                 _check, _check_aligned,
                                                 page_dequant)

_NEG_INF = -1e30
# the kernel's tiles: query rows, history keys (at most a page), chunk keys
ROW_TILE, HIST_TILE, CHUNK_TILE = 64, 64, 32


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


def split3(x: torch.Tensor):
    """float32 x -> (hi, mid, lo), float32 tensors of bf16 values: each
    term the top 8 significant bits of what remains (the kernel's split, by
    masking the low 16 bits), so hi + mid + lo == x exactly unless lo falls
    below float32's normal range (|x| < 2^-110)."""
    def top(t):
        return (t.view(torch.int32) & -65536).view(torch.float32)
    hi = top(x)
    mid = top(x - hi)
    return hi, mid, top(x - hi - mid)


def _split_products(a, b, spec, n_b: int):
    """sum of einsum(spec) over the split terms of a (three) and b (n_b:
    1 when b is exact in bf16), the pairs whose orders sum to at most 2,
    smallest first, in float32."""
    ta = split3(a)
    tb = split3(b) if n_b == 3 else (b,)
    pairs = [(i, j) for s in (2, 1, 0) for i in range(3) for j in range(n_b)
             if i + j == s]
    out = None
    for i, j in pairs:
        t = torch.einsum(spec, ta[i], tb[j])
        out = t if out is None else out + t
    return out


def paged_prefill_split_plain(qg, kc, vc, pool_kq, pool_ks, pool_vq, pool_vs,
                              page_table, hist_len, valid, hist_blocks: int,
                              kv_dtype="int8"):
    """The kernel's arithmetic in plain PyTorch, for the tests: the contract
    of `paged_prefill_plain`, walked in the kernel's tiles with an online
    softmax. History tiles of min(64, ps) keys inside a page: the page's K
    scale row folded onto the queries (q * ks, float32), q * ks and p split
    into three bf16 terms against the exact codes (3 products each), the
    tile's P.V times the page's V scale row. Chunk tiles of 32 keys: both
    float sides split, 6 products. A 64-row tile whose positions are all at
    or past ``valid`` comes out as 0.0."""
    B, Hkv, GC, D = qg.shape
    C = kc.shape[2]
    dev = qg.device
    qpos = torch.arange(GC, device=dev) % C
    m = torch.full((B, Hkv, GC, 1), _NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, GC, 1), device=dev)
    o = torch.zeros((B, Hkv, GC, D), device=dev)

    def fold(logits, live, pv):
        """online softmax over a key tile; pv(p) -> the tile's P.V"""
        nonlocal m, l, o
        logits = torch.where(live, logits, torch.full_like(logits,
                                                           float("-inf")))
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + pv(p)
        m = m_new

    ps = pool_kq.shape[1] * (2 if kv_dtype == "int4" else 1)
    kt = min(HIST_TILE, ps)
    hl = hist_len.to(dev).long()[:, None, None, None]
    for t in range(hist_blocks):
        pid = page_table[:, t].long()
        kcode = page_dequant(pool_kq[pid], torch.ones_like(pool_ks[pid]),
                             kv_dtype).permute(0, 2, 1, 3)   # (B, Hkv, ps, D)
        vcode = page_dequant(pool_vq[pid], torch.ones_like(pool_vs[pid]),
                             kv_dtype).permute(0, 2, 1, 3)
        ks, vs = pool_ks[pid][:, :, None], pool_vs[pid][:, :, None]
        for j0 in range(0, ps, kt):
            keys = t * ps + j0 + torch.arange(min(kt, ps - j0), device=dev)
            logits = _split_products(qg * ks, kcode[:, :, j0:j0 + kt],
                                     "bhrd,bhtd->bhrt", 1)
            fold(logits, keys < hl, lambda p: _split_products(
                p, vcode[:, :, j0:j0 + kt], "bhrt,bhtd->bhrd", 1) * vs)
    vd = valid.to(dev).long()[:, None, None, None]
    for j0 in range(0, C, CHUNK_TILE):
        kpos = torch.arange(j0, min(C, j0 + CHUNK_TILE), device=dev)
        live = (kpos <= qpos[:, None]) & (kpos < vd)
        logits = _split_products(qg, kc[:, :, j0:j0 + CHUNK_TILE],
                                 "bhrd,bhtd->bhrt", 3)
        fold(logits, live, lambda p: _split_products(
            p, vc[:, :, j0:j0 + CHUNK_TILE], "bhrt,bhtd->bhrd", 3))
    out = o / torch.clamp_min(l, 1e-30)
    # dead row tiles: every position at or past `valid`
    r0 = torch.arange(0, GC, ROW_TILE, device=dev)
    r1 = torch.clamp_max(r0 + ROW_TILE, GC) - 1
    first = torch.where(r0 // C == r1 // C, r0 % C, 0)
    dead = (first[None] >= valid.to(dev)[:, None]).repeat_interleave(
        ROW_TILE, dim=1)[:, :GC]
    return torch.where(dead[:, None, :, None], torch.zeros_like(out), out)


_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def paged_prefill_cuda(qg, kc, vc, pool_kq, pool_ks, pool_vq, pool_vs,
                       page_table, hist_len, valid, hist_blocks: int,
                       kv_dtype="int8"):
    """Launch the CUDA kernel (same contract as the plain version; rows of
    a 64-row tile whose positions are all at or past ``valid`` come out as
    0.0). Counts each launch in ``paged_prefill_cuda.launches``."""
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
    _check_aligned(qg=qg, k=kc, v=vc, pool_kq=pool_kq, pool_vq=pool_vq,
                   pool_ks=pool_ks, pool_vs=pool_vs)
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
