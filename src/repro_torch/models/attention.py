"""GQA attention: training, and serving over the quantized KV cache (port
of ``repro.models.attention`` for dense stacks).

Training:
    train(...)          full causal (optionally sliding-window) attention,
                        no cache: blocked flash attention (`models.flash`)
Contiguous cache (`core.kvcache.QuantizedKVCache`):
    prefill(...)        causal attention over the prompt (blocked flash
                        attention, `models.flash`), then quantizes its K/V
                        into the cache
    decode(...)         one token: appends K/V, then attends over the int8
                        cache (the flat decode kernel); per-block caches
                        merge it with the fp residual tail (`_decode_blocked`)
Paged cache (`core.paging.PagedQuantizedKVCache`):
    prefill_chunk(...)  one varlen prompt chunk: attends over the row's
                        resident pages + causally within the chunk (the
                        paged prefill kernel), then writes the chunk's K/V
                        into pages (`PagedQuantizedKVCache.prefill_at`)
    decode(...)         one token: appends K/V to the cache, then attends
                        over the flushed pages (the paged decode kernel)
                        merged with the fp residual tail

The caches are updated in place: attention reads the pool BEFORE a chunk's
pages are written, and decode appends BEFORE it reads, exactly the order
of the reference's functional updates.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvcache import QuantizedKVCache
from repro_torch.core.paging import PagedQuantizedKVCache
from repro_torch.kernels import ops
from repro_torch.models import flash
from repro_torch.models.common import apply_rope, dense_init


def init(cfg, gen: torch.Generator, device) -> dict:
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.activation_dtype
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return {"wq": dense_init(gen, d, nq, dt, device),
            "wk": dense_init(gen, d, nkv, dt, device),
            "wv": dense_init(gen, d, nkv, dt, device),
            "wo": dense_init(gen, nq, d, dt, device)}


def _project_qkv(p, x, cfg, positions):
    """x (B, S, d) -> q (B, H, S, hd), k/v (B, Hkv, S, hd), RoPE applied."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, hd).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, hd).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, *, causal: bool, window: int | None):
    """Blocked flash-style attention (see models/flash.py)."""
    return flash.flash_attention(q, k, v, causal, window)


def _merge_heads(p, out, dtype):
    B, H, S, hd = out.shape
    out = out.transpose(1, 2).reshape(B, S, H * hd).to(dtype)
    return out @ p["wo"]


# -- training -----------------------------------------------------------------

def train(p, x, cfg, positions, *, local: bool = False, causal: bool = True):
    """x (B, S, d) -> (B, S, d): attention over the sequence itself."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    window = cfg.sliding_window if (cfg.sliding_window or local) else None
    out = _sdpa(q, k, v, causal=causal, window=window)
    return _merge_heads(p, out, x.dtype)


# -- serving ------------------------------------------------------------------

def prefill(p, x, cfg, positions, cache: QuantizedKVCache, *,
            row_mask=None):
    """Prompt pass over the contiguous cache: causal attention, then the
    prompt's K/V quantized into the cache. ``row_mask`` is a paged-cache
    feature: the contiguous cache has one length for every row."""
    if row_mask is not None:
        raise ValueError("row-masked prefill requires the paged cache (the "
                         "contiguous cache has one shared length)")
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _sdpa(q, k, v, causal=True, window=cfg.sliding_window)
    cache.prefill(k.float(), v.float())
    return _merge_heads(p, out, x.dtype), cache


def prefill_chunk(p, x, cfg, positions, cache: PagedQuantizedKVCache, *,
                  row_mask=None, hist_blocks: int | None = None, valid=None):
    """One prompt chunk under varlen chunked prefill. ``x`` (B, C, d), C a
    page multiple (the dispatch width); ``positions`` (B, C) absolute, with
    positions[:, 0] each row's page-aligned resident history; ``valid``
    (B,) true tokens per row (None = C); ``hist_blocks`` bounds the
    history walk (None = the whole table, 0 = no history)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    hist_len = positions[:, 0].to(torch.int32)
    nb = cache.max_blocks if hist_blocks is None else \
        min(hist_blocks, cache.max_blocks)
    pool = cache.pool
    out = ops.paged_attention_prefill(
        q, k, v, pool.k_q, pool.k_s, pool.v_q, pool.v_s, cache.page_table,
        hist_len, valid, hist_blocks=nb, kv_dtype=pool.kv_dtype)
    cache.prefill_at(k.float(), v.float(),
                     torch.div(hist_len, cache.page_size,
                               rounding_mode="floor"),
                     row_mask=row_mask, valid=valid)
    return _merge_heads(p, out.to(x.dtype), x.dtype), cache


def decode(p, x, cfg, positions, cache, *, row_mask=None):
    """One-token step: append K/V, then attention over the int8 cache
    (merged with the exact fp residual tail where there is one).
    ``row_mask`` (B,) bool freezes unmasked rows' caches (paged only)."""
    q, k, v = _project_qkv(p, x, cfg, positions)          # S == 1
    if isinstance(cache, PagedQuantizedKVCache):
        cache.append(k.float(), v.float(), row_mask=row_mask)
        out = _decode_paged(q[:, :, 0], cache)
    else:
        if row_mask is not None:
            raise ValueError("row-masked decode requires the paged cache")
        cache.append(k.float(), v.float())
        window = cfg.sliding_window if cache.ring else None
        if cache.per_channel:
            out = ops.quant_attention_decode(
                q[:, :, 0], cache.k_q, cache.k_s, cache.v_q, cache.v_s,
                cache.length, window=window)
        else:
            out = _decode_blocked(q[:, :, 0], cache, window=window)
    out = out[:, :, None]                                  # (B, H, 1, hd)
    return _merge_heads(p, out.to(x.dtype), x.dtype), cache


def _decode_blocked(q, cache: QuantizedKVCache, *, window=None):
    """The flat decode kernel over the flushed blocks merged with exact
    attention over the residual tail. Ring ages in the quantized part count
    from the flushed prefix, and its window budget leaves out the n_tail
    newest (residual) tokens."""
    bs = cache.block_size
    flushed = (cache.length // bs) * bs
    n_tail = cache.length % bs
    win_q = None if window is None else max(window - n_tail, 0)
    o1, m1, l1 = ops.quant_attention_decode_partials(
        q, cache.k_q, cache.k_s, cache.v_q, cache.v_s, flushed, window=win_q)
    m2, l2, o2 = _decode_partials_fp(q, cache.resid_k, cache.resid_v, n_tail)
    return _merge_partials(o1, m1, l1, o2, m2, l2)


def _decode_paged(q, cache: PagedQuantizedKVCache):
    """Paged decode kernel over each row's flushed pages + exact fp
    residual tail, merged per row."""
    ps = cache.page_size
    flushed = torch.div(cache.length, ps, rounding_mode="floor") * ps
    n_tail = cache.length % ps
    pool = cache.pool
    o1, m1, l1 = ops.paged_attention_decode_partials(
        q, pool.k_q, pool.k_s, pool.v_q, pool.v_s, cache.page_table, flushed,
        kv_dtype=pool.kv_dtype)
    m2, l2, o2 = _decode_partials_fp(q, cache.resid_k, cache.resid_v, n_tail)
    return _merge_partials(o1, m1, l1, o2, m2, l2)


def _merge_partials(o1, m1, l1, o2, m2, l2):
    """Softmax-merge two sets of flash partials into normalized outputs."""
    m = torch.maximum(m1, m2)
    c1, c2 = torch.exp(m1 - m), torch.exp(m2 - m)
    l = l1 * c1 + l2 * c2
    return (o1 * c1 + o2 * c2) / torch.clamp_min(l, 1e-30)


def _decode_partials_fp(q, rk, rv, n_tail):
    B, H, hd = q.shape
    Hkv, bs = rk.shape[1], rk.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, Hkv, G, hd)
    logits = torch.einsum("bhgd,bhtd->bhgt", qg, rk.float())
    logits = logits / torch.sqrt(torch.tensor(float(hd)))
    if isinstance(n_tail, torch.Tensor):       # per row (paged)
        n_tail = n_tail.to(torch.int32)[:, None, None, None]
    mask = torch.arange(bs, device=q.device)[None, None, None, :] < n_tail
    neg = torch.full_like(logits, -1e30)
    logits = torch.where(mask, logits, neg)
    m = torch.clamp_min(torch.amax(logits, dim=-1, keepdim=True), -1e30 / 2)
    pexp = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    l = pexp.sum(-1, keepdim=True)
    o = torch.einsum("bhgt,bhtd->bhgd", pexp, rv.float())
    return m.reshape(B, H, 1), l.reshape(B, H, 1), o.reshape(B, H, hd)
