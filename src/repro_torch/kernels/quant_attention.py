"""Decode attention over the quantized KV cache: the CUDA kernels'
launchers and their plain PyTorch versions.

Paged (port of ``repro.kernels.quant_attention._paged_decode_kernel``):
one query token per row attends over the row's pages through its page
table. Pages are int8, fp8_e4m3 or int4-packed (two tokens per byte) and
are dequantized to float32 (value * scale row).

Flat (port of ``_flat_decode_kernel``): one query token per row attends
over the contiguous int8 cache (B, H_kv, T, D) with one scale row per
token block or per channel; slots past ``min(length, T)`` and ring slots
older than the row's window are masked.

Both return UNNORMALIZED flash partials ``(o, m, l)`` so the caller can
merge them with the fp residual tail; a row with nothing to attend yields
o = 0, m = -1e30, l = 0.

The CUDA kernels (``csrc/paged_decode.cu``, ``csrc/flat_decode.cu``) run
on CUDA tensors; the plain versions are what a CPU tensor gets, and what
the kernels are held against.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import _build

_NEG_INF = -1e30
KV_CODES = {"int8": 0, "fp8_e4m3": 1, "int4": 2}
HEAD_DIMS = (16, 32, 64, 128)      # head widths the kernels are built for


def logit_scale(D: int) -> float:
    """rsqrt(D) in float32, the value both versions multiply logits by."""
    return float(torch.rsqrt(torch.tensor(float(D), dtype=torch.float32)))


def page_dequant(pages: torch.Tensor, scales: torch.Tensor,
                 kv_dtype: str) -> torch.Tensor:
    """Dequantize gathered pages (..., ps_packed, H_kv, D) with their
    scale rows (..., H_kv, D) to float32 (..., ps, H_kv, D); int4 unpacks
    the token axis first (even tokens in the low nibble)."""
    if kv_dtype == "int4":
        pages = Q.unpack_int4(pages.movedim(-3, -2)).movedim(-2, -3)
    return pages.float() * scales[..., None, :, :].float()


def paged_decode_partials_plain(q, pool_kq, pool_ks, pool_vq, pool_vs,
                                page_table, lengths, kv_dtype="int8"):
    """q (B, H, D); pool_* (P, ps_packed, H_kv, D) / (P, H_kv, D);
    page_table (B, NT) int32; lengths (B,) int32 tokens to attend per row.
    Returns (o (B, H, D), m (B, H, 1), l (B, H, 1)) float32."""
    B, H, D = q.shape
    Hkv = pool_kq.shape[2]
    G = H // Hkv
    tbl = page_table.long()
    k = page_dequant(pool_kq[tbl], pool_ks[tbl], kv_dtype)
    v = page_dequant(pool_vq[tbl], pool_vs[tbl], kv_dtype)
    T = k.shape[1] * k.shape[2]
    k = k.reshape(B, T, Hkv, D)
    v = v.reshape(B, T, Hkv, D)
    qg = q.float().reshape(B, Hkv, G, D)
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k) * logit_scale(D)
    mask = (torch.arange(T, device=q.device)[None]
            < lengths.to(q.device)[:, None])[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask.float()
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgt,bthd->bhgd", p, v)
    return o.reshape(B, H, D), m.reshape(B, H, 1), l.reshape(B, H, 1)


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_void_p]


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_decode_partials_cuda(q, pool_kq, pool_ks, pool_vq, pool_vs,
                               page_table, lengths, kv_dtype="int8"):
    """Launch the CUDA kernel (same contract as the plain version; q must
    be float32). Counts each launch in ``paged_decode_partials_cuda.
    launches``."""
    B, H, D = q.shape
    P, ps_packed, Hkv, _ = pool_kq.shape
    NT = page_table.shape[1]
    ps = 2 * ps_packed if kv_dtype == "int4" else ps_packed
    if D not in HEAD_DIMS or H % Hkv:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{HEAD_DIMS} and H % H_kv == 0 (got D={D}, "
                         f"H={H}, H_kv={Hkv})")
    store = Q.kv_storage_dtype(kv_dtype)
    _check(q, "q", torch.float32)
    _check(pool_kq, "pool_kq", store, (P, ps_packed, Hkv, D))
    _check(pool_vq, "pool_vq", store, (P, ps_packed, Hkv, D))
    _check(pool_ks, "pool_ks", torch.float32, (P, Hkv, D))
    _check(pool_vs, "pool_vs", torch.float32, (P, Hkv, D))
    _check(page_table, "page_table", torch.int32, (B, NT))
    _check(lengths, "lengths", torch.int32, (B,))
    fn = _build.load("paged_decode", "paged_decode_partials", _ARGTYPES)
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), pool_kq.data_ptr(), pool_ks.data_ptr(),
            pool_vq.data_ptr(), pool_vs.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            B, H, Hkv, D, ps, ps_packed, NT, KV_CODES[kv_dtype],
            logit_scale(D), torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{rc}")
    paged_decode_partials_cuda.launches += 1
    return o, m, l


paged_decode_partials_cuda.launches = 0


# -- flat decode over the contiguous cache ------------------------------------

def flat_decode_partials_plain(q, k_q, k_s, v_q, v_s, lengths, windows):
    """q (B, H, D) float32; k_q/v_q (B, H_kv, T, D) int8; k_s/v_s
    (B, H_kv, nb, D) float32, nb = 1 (per channel) or T / block; lengths
    (B,) int32 absolute tokens written (a ring may exceed T); windows (B,)
    int32 ring-age budget. Returns (o (B, H, D), m (B, H, 1), l (B, H, 1))
    float32."""
    B, H, D = q.shape
    _, Hkv, T, _ = k_q.shape
    G = H // Hkv
    nb = k_s.shape[2]

    def deq(x_q, s):
        xb = x_q.reshape(B, Hkv, nb, T // nb, D).float()
        return (xb * s.float()[:, :, :, None]).reshape(B, Hkv, T, D)

    k, v = deq(k_q, k_s), deq(v_q, v_s)
    qg = q.float().reshape(B, Hkv, G, D)
    logits = torch.einsum("bhgd,bhtd->bhgt", qg, k) * logit_scale(D)
    slots = torch.arange(T, device=q.device)[None]
    ln = lengths.to(device=q.device, dtype=torch.int64)[:, None]
    age = torch.remainder(ln - 1 - slots, T)
    mask = ((slots < torch.clamp_max(ln, T))
            & (age < windows.to(q.device)[:, None]))[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask.float()
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgt,bhtd->bhgd", p, v)
    return o.reshape(B, H, D), m.reshape(B, H, 1), l.reshape(B, H, 1)


_FLAT_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_void_p]


def flat_decode_partials_cuda(q, k_q, k_s, v_q, v_s, lengths, windows):
    """Launch the CUDA kernel (same contract as the plain version; q must
    be float32). Counts each launch in ``flat_decode_partials_cuda.
    launches``."""
    B, H, D = q.shape
    _, Hkv, T, _ = k_q.shape
    nb = k_s.shape[2]
    if D not in HEAD_DIMS or H % Hkv or T % nb:
        raise ValueError(f"flat decode kernel takes head_dim in {HEAD_DIMS}, "
                         f"H % H_kv == 0 and T % nb == 0 (got D={D}, H={H}, "
                         f"H_kv={Hkv}, T={T}, nb={nb})")
    _check(q, "q", torch.float32)
    _check(k_q, "k_q", torch.int8, (B, Hkv, T, D))
    _check(v_q, "v_q", torch.int8, (B, Hkv, T, D))
    _check(k_s, "k_s", torch.float32, (B, Hkv, nb, D))
    _check(v_s, "v_s", torch.float32, (B, Hkv, nb, D))
    _check(lengths, "lengths", torch.int32, (B,))
    _check(windows, "windows", torch.int32, (B,))
    fn = _build.load("flat_decode", "flat_decode_partials", _FLAT_ARGTYPES)
    o = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    rc = fn(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), lengths.data_ptr(), windows.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, Hkv, D, T, nb,
            logit_scale(D), torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flat decode kernel launch failed: CUDA error "
                           f"{rc}")
    flat_decode_partials_cuda.launches += 1
    return o, m, l


flat_decode_partials_cuda.launches = 0
