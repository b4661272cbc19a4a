"""Decode attention over the quantized KV cache: the CUDA kernels'
launchers and their plain PyTorch versions.

Paged (port of ``repro.kernels.quant_attention._paged_decode_kernel``):
one query token per row attends over the row's pages through its page
table. Pages are int8, fp8_e4m3 or int4-packed (two tokens per byte) and
are dequantized to float32 (value * scale row). The kernel splits each
row's page walk across blocks and merges the splits' partials
(`merge_split_partials` is that merge in plain PyTorch, for the tests).

Flat (port of ``_flat_decode_kernel``): one query token per row attends
over the contiguous int8 cache (B, H_kv, T, D) with one scale row per
token block or per channel; slots past ``min(length, T)`` and ring slots
older than the row's window are masked. Its kernel splits each row's slots
into runs of ``flat_decode_splits`` and merges them as the paged one does.

Seed (port of ``_decode_kernel``, the reference's baseline under vmap):
the flat kernel's result with the baseline's cost, every slot of T copied
and folded and the dead ones masked. Its kernel is flat decode's split
walk with the dead-slot skip left out; its plain version is the flat one.

All return UNNORMALIZED flash partials ``(o, m, l)`` so the caller can
merge them with the fp residual tail; a row with nothing to attend yields
o = 0, m = -1e30, l = 0.

The CUDA kernels (``csrc/paged_decode.cu``, ``csrc/flat_decode.cu``,
``csrc/seed_decode.cu``) run on CUDA tensors; the plain versions are what
a CPU tensor gets, and what the kernels are held against.
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


def merge_split_partials(o_s, m_s, l_s):
    """Merge flash partials of splits of the key axis, the plain version of
    the paged kernel's merge: o_s (B, H, n, D), m_s / l_s (B, H, n, 1)
    float32, each split's unnormalized (o, m, l) -> (o (B, H, D),
    m (B, H, 1), l (B, H, 1)) with m = max m_s, l = sum l_s e^(m_s - m),
    o = sum o_s e^(m_s - m). A split with nothing live (m_s = -1e30,
    l_s = 0, o_s = 0) adds nothing; a row with no live split keeps
    m = -1e30, l = 0, o = 0."""
    m = torch.amax(m_s, dim=2)
    w = torch.exp(m_s - m[:, :, None])
    return (o_s * w).sum(2), m, (l_s * w).sum(2)


def decode_splits(B: int, Hkv: int, G: int, NT: int, sms: int):
    """(splits, pages per split) of the paged decode kernel's page walk:
    enough blocks for two per SM over B * H_kv * ceil(G / 2) (kv head,
    query pair) blocks, a split never less than one page-table entry.
    From host-known shapes only: reading the lengths would sync."""
    blocks = B * Hkv * (1 if G == 1 else -(-G // 2))
    want = -(-2 * sms // blocks)
    pps = max(1, -(-NT // want))
    return -(-NT // pps), pps


FLAT_TILE = 64     # slots a split of the flat walk is a multiple of


def flat_decode_splits(B: int, Hkv: int, G: int, T: int, sms: int):
    """(splits, slots per split) of the flat decode and seed kernels' walk
    over T slots: about two blocks per SM over B * H_kv * ceil(G / 2)
    (kv head, query pair) blocks where T allows, a split a whole number of
    FLAT_TILE-slot tiles, rounded up (on an H100, 8 splits of 256 slots at
    4 rows x 2048 ran faster than 11 of 192). From host-known shapes only:
    reading the lengths or windows would sync."""
    blocks = B * Hkv * (1 if G == 1 else -(-G // 2))
    want = -(-2 * sms // blocks)
    tiles = -(-T // FLAT_TILE)
    per = -(-tiles // want)
    return -(-tiles // per), per * FLAT_TILE


_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + \
    [ctypes.c_float, ctypes.c_void_p]


_SMS: dict = {}


def _sm_count(dev: torch.device) -> int:
    """The card's SM count (read once per device: a host query)."""
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


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


def _check_aligned(**tensors):
    """The kernels that copy 16 bytes a thread need 16-byte aligned data."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def paged_decode_partials_cuda(q, pool_kq, pool_ks, pool_vq, pool_vs,
                               page_table, lengths, kv_dtype="int8"):
    """Launch the CUDA kernels (same contract as the plain version; q must
    be float32): the split page walk, then the merge of its float32
    partials (scratch from `torch.empty`; `decode_splits` sizes it). Counts
    each call in ``paged_decode_partials_cuda.launches`` and, by page
    dtype, in ``paged_decode_partials_cuda.launches_by_dtype``."""
    B, H, D = q.shape
    P, ps_packed, Hkv, _ = pool_kq.shape
    NT = page_table.shape[1]
    ps = 2 * ps_packed if kv_dtype == "int4" else ps_packed
    if D not in HEAD_DIMS or H % Hkv or not NT:
        raise ValueError(f"paged decode kernel takes head_dim in "
                         f"{HEAD_DIMS}, H % H_kv == 0 and a page table "
                         f"(got D={D}, H={H}, H_kv={Hkv}, NT={NT})")
    store = Q.kv_storage_dtype(kv_dtype)
    _check(q, "q", torch.float32)
    _check(pool_kq, "pool_kq", store, (P, ps_packed, Hkv, D))
    _check(pool_vq, "pool_vq", store, (P, ps_packed, Hkv, D))
    _check(pool_ks, "pool_ks", torch.float32, (P, Hkv, D))
    _check(pool_vs, "pool_vs", torch.float32, (P, Hkv, D))
    _check(page_table, "page_table", torch.int32, (B, NT))
    _check(lengths, "lengths", torch.int32, (B,))
    _check_aligned(q=q, pool_kq=pool_kq, pool_vq=pool_vq, pool_ks=pool_ks,
                   pool_vs=pool_vs)
    fn = _build.load("paged_decode", "paged_decode_partials", _ARGTYPES)
    dev = q.device
    nsplit, pps = decode_splits(B, Hkv, H // Hkv, NT, _sm_count(dev))
    o = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, H, 1), dtype=torch.float32, device=dev)
    l = torch.empty((B, H, 1), dtype=torch.float32, device=dev)
    # scratch: o_s (B, H, nsplit, D), then m_s and l_s (B, H, nsplit)
    n = B * H * nsplit
    scratch = torch.empty((n * (D + 2),), dtype=torch.float32, device=dev)
    base = scratch.data_ptr()
    rc = fn(q.data_ptr(), pool_kq.data_ptr(), pool_ks.data_ptr(),
            pool_vq.data_ptr(), pool_vs.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), o.data_ptr(), m.data_ptr(), l.data_ptr(),
            base, base + 4 * n * D, base + 4 * n * (D + 1),
            B, H, Hkv, D, ps, ps_packed, NT, KV_CODES[kv_dtype], pps, nsplit,
            logit_scale(D), torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA error "
                           f"{rc}")
    paged_decode_partials_cuda.launches += 1
    paged_decode_partials_cuda.launches_by_dtype[kv_dtype] += 1
    return o, m, l


paged_decode_partials_cuda.launches = 0
paged_decode_partials_cuda.launches_by_dtype = dict.fromkeys(KV_CODES, 0)


# -- flat decode over the contiguous cache ------------------------------------

def flat_decode_partials_plain(q, k_q, k_s, v_q, v_s, lengths, windows,
                               slots: tuple[int, int] | None = None):
    """q (B, H, D) float32; k_q/v_q (B, H_kv, T, D) int8; k_s/v_s
    (B, H_kv, nb, D) float32, nb = 1 (per channel) or T / block; lengths
    (B,) int32 absolute tokens written (a ring may exceed T); windows (B,)
    int32 ring-age budget; ``slots`` (t0, t1): only slots in [t0, t1) take
    part (one split of the kernel's walk). Returns (o (B, H, D), m (B, H,
    1), l (B, H, 1)) float32."""
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
    t = torch.arange(T, device=q.device)[None]
    ln = lengths.to(device=q.device, dtype=torch.int64)[:, None]
    age = torch.remainder(ln - 1 - t, T)
    mask = ((t < torch.clamp_max(ln, T))
            & (age < windows.to(q.device)[:, None]))
    if slots is not None:
        mask &= (t >= slots[0]) & (t < slots[1])
    mask = mask[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m) * mask.float()
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgt,bhtd->bhgd", p, v)
    return o.reshape(B, H, D), m.reshape(B, H, 1), l.reshape(B, H, 1)


_FLAT_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_void_p]


def _flat_split_launch(lib, q, k_q, k_s, v_q, v_s, lengths, windows):
    """Check the arguments of one of the contiguous cache's split walks
    (library ``lib``, csrc/flat_split.cuh), launch it and, with more than
    one split, the merge of its float32 partials (scratch from
    `torch.empty`; `flat_decode_splits` sizes it). Returns (o, m, l)."""
    label = lib.replace("_", " ")
    B, H, D = q.shape
    _, Hkv, T, _ = k_q.shape
    nb = k_s.shape[2]
    if D not in HEAD_DIMS or H % Hkv or T % nb:
        raise ValueError(f"{label} kernel takes head_dim in {HEAD_DIMS}, "
                         f"H % H_kv == 0 and T % nb == 0 (got D={D}, H={H}, "
                         f"H_kv={Hkv}, T={T}, nb={nb})")
    _check(q, "q", torch.float32)
    _check(k_q, "k_q", torch.int8, (B, Hkv, T, D))
    _check(v_q, "v_q", torch.int8, (B, Hkv, T, D))
    _check(k_s, "k_s", torch.float32, (B, Hkv, nb, D))
    _check(v_s, "v_s", torch.float32, (B, Hkv, nb, D))
    _check(lengths, "lengths", torch.int32, (B,))
    _check(windows, "windows", torch.int32, (B,))
    _check_aligned(q=q, k_q=k_q, v_q=v_q, k_s=k_s, v_s=v_s)
    o, m, l = (torch.empty(shape, dtype=torch.float32, device=q.device)
               for shape in ((B, H, D), (B, H, 1), (B, H, 1)))
    fn = _build.load(lib, f"{lib}_partials", _FLAT_ARGTYPES)
    nsplit, tps = flat_decode_splits(B, Hkv, H // Hkv, T,
                                     _sm_count(q.device))
    # scratch: o_s (B, H, nsplit, D), then m_s and l_s (B, H, nsplit)
    n = B * H * nsplit if nsplit > 1 else 0
    scratch = torch.empty((n * (D + 2),), dtype=torch.float32,
                          device=q.device)
    base = scratch.data_ptr()
    rc = fn(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(), v_q.data_ptr(),
            v_s.data_ptr(), lengths.data_ptr(), windows.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(),
            base, base + 4 * n * D, base + 4 * n * (D + 1),
            B, H, Hkv, D, T, nb, tps, nsplit, logit_scale(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"{label} kernel launch failed: CUDA error {rc}")
    return o, m, l


def flat_decode_partials_cuda(q, k_q, k_s, v_q, v_s, lengths, windows):
    """Launch the CUDA kernels (same contract as the plain version; q must
    be float32): the split walk over the live slots, then the merge.
    Counts each call in ``flat_decode_partials_cuda.launches``."""
    out = _flat_split_launch("flat_decode", q, k_q, k_s, v_q, v_s, lengths,
                             windows)
    flat_decode_partials_cuda.launches += 1
    return out


def seed_decode_partials_cuda(q, k_q, k_s, v_q, v_s, lengths, windows):
    """Launch the seed-baseline kernels: the contract of
    `flat_decode_partials_plain`, flat decode's split walk with every slot
    of T copied and folded (dead ones masked, not skipped), then the
    merge. Counts each call in ``seed_decode_partials_cuda.launches``."""
    out = _flat_split_launch("seed_decode", q, k_q, k_s, v_q, v_s, lengths,
                             windows)
    seed_decode_partials_cuda.launches += 1
    return out


flat_decode_partials_cuda.launches = 0
seed_decode_partials_cuda.launches = 0
