"""GQA attention: training, and serving over the quantized KV cache (port
of ``repro.models.attention``, with or without QKV bias, RoPE or M-RoPE;
``local`` marks a "local_attn" block, whose window is the config's
sliding window).

Training:
    train(...)          full causal (optionally sliding-window) attention,
                        no cache: blocked flash attention (`models.flash`);
                        under a mesh context parallel, as the reference's
                        (DESIGN.md §4: heads need not divide the model
                        axis): the weights gathered over every axis,
                        queries left sequence-sharded over "model" with
                        RoPE at this rank's absolute positions, K and V
                        gathered over "model" along the sequence in their
                        storage dtype (``_gather_seq``; the backward
                        reduce-scatters dK, dV), and the flash walk at
                        ``kv_offset`` = this rank's first position
Encoder-decoder cross attention (`models.encdec`):
    cross_train(...)    queries from the decoder, keys / values from the
                        encoder output, no RoPE, no mask (flash forward,
                        non-causal); under a mesh K and V projected on
                        this rank's encoder positions and gathered along
                        the encoder sequence (as ``_gather_seq``; the
                        backward reduce-scatters dK, dV)
    cross_tp(...)       a prompt's cross attention on this rank's shards;
                        returns the K/V for the cross cache
    cross_decode(...)   one query over the per-channel int8 cross cache
                        (the flat decode kernel) at its valid length;
                        over a `ShardedKVCache` this rank's slots, the
                        ranks' partials merged in rank order
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
                        paged prefill kernel; ``use_fused=False``: the
                        parity oracle, the history dequantized and one
                        softmax, `_chunk_attention`), then writes the
                        chunk's K/V into pages
                        (`PagedQuantizedKVCache.prefill_at`)
    decode(...)         one token: appends K/V to the cache, then attends
                        over the flushed pages (the paged decode kernel)
                        merged with the fp residual tail

The caches are updated in place: attention reads the pool BEFORE a chunk's
pages are written, and decode appends BEFORE it reads, exactly the order
of the reference's functional updates.

Serving under a mesh (`models.transformer`, `models.encdec`; this rank's
rows, every position): every stack calls `serve_tp` on the rank's shards
of the weights (`launch.specs.serve_param_specs`: query and kv heads,
and ``wo``'s output columns, over "model"). Q, K and V come from the
rank's head columns; over a paged pool of the rank's kv heads every
function above runs on those heads, and over a cache holding every
head (a contiguous cache, sharded along its slots as
`core.kvcache.ShardedKVCache`, or a paged pool whose kv heads do not
divide over "model") the heads are gathered first: a prompt's flash
still runs on the rank's query heads (whisper's encoder too, non-causal
and without a cache), a decode step on every head (the flat decode
kernel over this rank's slots, every rank's partials merged in rank
order, then the replicated fp residual tail; over a sharded ring each
rank's live slots are those the window leaves live there,
`core.kvcache.ring_slot_args`). Whisper's cross attention: `cross_tp`
projects the encoder's K/V on the rank's kv heads and gathers them for
the cross cache, `cross_decode` gathers q's heads over the rank's cross
slots. The heads' outputs, gathered, times the rank's ``wo`` columns,
gathered (`_out_tp`), are what one process computes.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvcache import QuantizedKVCache, ShardedKVCache
from repro_torch.core.paging import PagedQuantizedKVCache
from repro_torch.kernels import ops
from repro_torch.models import flash
from repro_torch.models.common import apply_mrope, apply_rope, dense_init
from repro_torch.parallel.shard import (all_gather, gather_cols,
                                        gather_heads, gather_param)


def init(cfg, gen: torch.Generator, device) -> dict:
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.activation_dtype
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p = {"wq": dense_init(gen, d, nq, dt, device),
         "wk": dense_init(gen, d, nkv, dt, device),
         "wv": dense_init(gen, d, nkv, dt, device),
         "wo": dense_init(gen, nq, d, dt, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    return p


def _project_qkv(p, x, cfg, positions):
    """x (B, S, d) -> q (B, H, S, hd), k/v (B, Hkv, S, hd), RoPE applied
    (M-RoPE where the config has sections: (B, S) positions broadcast to
    (B, 3, S), text mode). A bias joins the product after it is rounded
    to the activation dtype, as in the reference (a fused ``addmm`` would
    add it before). The head counts are the projections' widths over
    hd: a rank's shards of the heads (`head_slice`) project its heads."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, -1, hd).transpose(1, 2)
    k = k.reshape(B, S, -1, hd).transpose(1, 2)
    v = v.reshape(B, S, -1, hd).transpose(1, 2)
    if cfg.mrope_sections is not None:
        pos3 = positions if positions.dim() == 3 else \
            positions[:, None].expand(B, 3, S)
        q = apply_mrope(q, pos3, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def head_slice(cfg, sp, mesh) -> dict:
    """The heads this rank's attention shards hold at rest (``sp`` their
    specs, `launch.specs.serve_param_specs`; ``mesh`` None: one process,
    every head): ``q`` its query heads' [h0, h1) (the ``wq`` / ``bq``
    columns [h0 * hd, h1 * hd)), ``kv`` its kv heads' (``wk``, ``wv``,
    ``bk``, ``bv``), ``reads`` the kv heads its query heads read (query
    head h reads kv head h // G)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads

    def cut(axes, n):
        if mesh is None or not axes:
            return 0, n
        i, k = mesh.index(axes)
        return i * n // k, (i + 1) * n // k
    q, kv = cut(sp["wq"][-1], H), cut(sp["wk"][-1], Hkv)
    G = H // Hkv
    return {"q": q, "kv": kv, "reads": (q[0] // G, (q[1] - 1) // G + 1)}


def _sdpa(q, k, v, *, causal: bool, window: int | None,
          kv_offset: int = 0):
    """Blocked flash-style attention (see models/flash.py)."""
    return flash.flash_attention(q, k, v, causal, window, kv_offset)


def _merge_heads(p, out, dtype):
    """(B, H, S, hd) -> (B, S, d): the heads rounded to ``dtype``, then
    their product with wo; without wo the heads alone, (B, S, H * hd)."""
    B, H, S, hd = out.shape
    out = out.transpose(1, 2).reshape(B, S, H * hd).to(dtype)
    return out @ p["wo"] if "wo" in p else out


def _window(cfg, local: bool):
    """The reference's window expression: the config's sliding window, for
    every attention block of a config that has one."""
    return cfg.sliding_window if (cfg.sliding_window or local) else None


# -- training -----------------------------------------------------------------

def train(p, x, cfg, positions, *, local: bool = False, causal: bool = True,
          lay=None, sp=None):
    """x (B, S, d) -> (B, S, d): attention over the sequence itself. Under
    a mesh (``lay``, ``sp`` the specs of p's leaves; None: whole weights,
    as serving holds them) x, positions and the result are this rank's
    part of ``lay``."""
    offset = 0
    if sp is not None:
        p = _gathered(p, sp, lay)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if lay is not None and lay.seq:           # _gather_seq
        k = all_gather(k, lay.seq, 2, lay.mesh)
        v = all_gather(v, lay.seq, 2, lay.mesh)
        offset = lay.positions().start
    out = _sdpa(q, k, v, causal=causal, window=_window(cfg, local),
                kv_offset=offset)
    return _merge_heads(p, out, x.dtype)


def _gathered(p, sp, lay) -> dict:
    """The weights a block computes with: each leaf gathered from this
    rank's shards by its spec."""
    return {k: gather_param(v, sp[k], lay.mesh) for k, v in p.items()}


def cross_train(p, x, kv_src, cfg, *, lay=None, sp=None):
    """Encoder-decoder cross attention in training: queries from x (B, S,
    d), keys / values from kv_src (B, T, d), the encoder output. No
    RoPE, no mask. Returns out (B, S, d). Under a mesh x is this rank's
    part of the decoder's layout and kv_src of the encoder's, ``lay``
    (the same rows); K and V are projected on this rank's encoder
    positions and gathered along the sequence in the activation dtype.
    ``sp``: the specs of p's leaves (None: whole weights)."""
    if sp is not None:
        p = _gathered(p, sp, lay)
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, hd).transpose(1, 2)
    k = (kv_src @ p["wk"]).reshape(B, -1, cfg.n_kv_heads, hd).transpose(1, 2)
    v = (kv_src @ p["wv"]).reshape(B, -1, cfg.n_kv_heads, hd).transpose(1, 2)
    if lay is not None and lay.seq:           # _gather_seq
        k = all_gather(k, lay.seq, 2, lay.mesh)
        v = all_gather(v, lay.seq, 2, lay.mesh)
    out = _sdpa(q, k, v, causal=False, window=None)
    return _merge_heads(p, out, x.dtype)


def cross_tp(p, sp, x, kv_src, cfg, mesh):
    """Cross attention of a prompt on this rank's shards (``sp`` their
    serving specs): queries from x (B_l, S, d) on the rank's query
    heads, keys / values from kv_src (B_l, T, d), the whole encoder
    output of its rows, projected on its kv heads and gathered over them
    (the cross cache holds every head); the flash over the rank's query
    heads and the kv heads they read. Returns (out (B_l, S, d), (k, v)
    (B_l, Hkv, T, hd) every head): the K/V the cross cache quantizes.
    On one device (every spec whole) the plain cross attention."""
    qa, kva = sp["wq"][-1], sp["wk"][-1]
    B, S, _ = x.shape
    T, hd = kv_src.shape[1], cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, -1, hd).transpose(1, 2)
    k = (kv_src @ p["wk"]).reshape(B, T, -1, hd).transpose(1, 2)
    v = (kv_src @ p["wv"]).reshape(B, T, -1, hd).transpose(1, 2)
    kw, vw = gather_heads(mesh, (k, kva), (v, kva))
    if not kva:                            # the kv heads the rank's read
        r0, r1 = head_slice(cfg, sp, mesh)["reads"]
        k, v = kw[:, r0:r1], vw[:, r0:r1]
    out = _sdpa(q, k, v, causal=False, window=None)
    return _out_tp(p, out, qa, sp["wo"][-1], mesh, x.dtype), (kw, vw)


def cross_decode(p, sp, x, cfg, cache: QuantizedKVCache, mesh=None):
    """Decode-time cross attention on this rank's shards ``p`` (``sp``
    their serving specs; every leaf whole on one device): one query a
    row over the per-channel int8 encoder K/V (scales computed once at
    prefill, paper Eq. 5, never updated), at the cache's valid length.
    q's heads are gathered first; over a `ShardedKVCache` the flat
    decode kernel runs over this rank's slots, every rank's partials
    merged in rank order; the heads' outputs times the rank's ``wo``
    columns, gathered (`_out_tp`)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = gather_cols(x @ p["wq"], sp["wq"][-1], mesh)
    q = q.reshape(B, S, cfg.n_heads, hd).transpose(1, 2)
    if isinstance(cache, ShardedKVCache):
        o, _, l = cache.decode_partials(q[:, :, 0], cache.valid_len)
        out = o / torch.clamp_min(l, 1e-30)
    else:
        out = ops.quant_attention_decode(
            q[:, :, 0], cache.k_q, cache.k_s, cache.v_q, cache.v_s,
            cache.valid_len)
    return _out_tp(p, out[:, :, None], (), sp["wo"][-1], mesh, x.dtype)


# -- serving ------------------------------------------------------------------

def prefill(p, x, cfg, positions, cache, *, local: bool = False,
            row_mask=None):
    """Prompt pass: causal (sliding-window) attention, then the prompt's
    K/V quantized into the cache: the contiguous one (a ring keeps the
    last window's tokens) or, T a page multiple, the paged one's mapped
    pages (`PagedQuantizedKVCache.prefill`). ``row_mask`` is a
    paged-cache feature: the contiguous cache has one length for every
    row."""
    _check_row_mask(cache, row_mask, "prefill")
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _sdpa(q, k, v, causal=True, window=_window(cfg, local))
    _write_prompt(cache, k, v, row_mask)
    return _merge_heads(p, out, x.dtype), cache


def _check_row_mask(cache, row_mask, what: str):
    if row_mask is not None and not isinstance(cache, PagedQuantizedKVCache):
        raise ValueError(f"row-masked {what} requires the paged cache (the "
                         f"contiguous cache has one shared length)")


def _write_prompt(cache, k, v, row_mask):
    if isinstance(cache, PagedQuantizedKVCache):
        cache.prefill(k.float(), v.float(), row_mask=row_mask)
    else:
        cache.prefill(k.float(), v.float())


def _chunk_core(q, k, v, positions, cache: PagedQuantizedKVCache, row_mask,
                hist_blocks, valid, use_fused: bool = True,
                oracle_hist_dtype=torch.float32):
    """The paged prefill kernel over a chunk's q, k, v (B, H, C, D) and
    the rows' resident pages (``use_fused`` False: the parity oracle,
    the history dequantized into ``oracle_hist_dtype`` and one softmax,
    `_chunk_attention`), then the chunk's K/V written into pages:
    (B, H, C, D) float32."""
    hist_len = positions[:, 0].to(torch.int32)
    nb = cache.max_blocks if hist_blocks is None else \
        min(hist_blocks, cache.max_blocks)
    pool = cache.pool
    if use_fused:
        out = ops.paged_attention_prefill(
            q, k, v, pool.k_q, pool.k_s, pool.v_q, pool.v_s,
            cache.page_table, hist_len, valid, hist_blocks=nb,
            kv_dtype=pool.kv_dtype)
    else:
        hk = hv = None
        if nb:
            hk, hv = cache.dequantized_prefix(nb, oracle_hist_dtype)
        out = _chunk_attention(q, k, v, hk, hv, hist_len)
    cache.prefill_at(k.float(), v.float(),
                     torch.div(hist_len, cache.page_size,
                               rounding_mode="floor"),
                     row_mask=row_mask, valid=valid)
    return out


def prefill_chunk(p, x, cfg, positions, cache: PagedQuantizedKVCache, *,
                  row_mask=None, hist_blocks: int | None = None, valid=None,
                  use_fused: bool = True, oracle_hist_dtype=torch.float32):
    """One prompt chunk under varlen chunked prefill. ``x`` (B, C, d), C a
    page multiple (the dispatch width); ``positions`` (B, C) absolute, with
    positions[:, 0] each row's page-aligned resident history; ``valid``
    (B,) true tokens per row (None = C); ``hist_blocks`` bounds the
    history walk (None = the whole table, 0 = no history).
    ``use_fused=True`` (the default) attends through the paged prefill
    kernel, which reads the int8 pages in place; ``use_fused=False`` is
    the parity oracle: `PagedQuantizedKVCache.dequantized_prefix` in
    ``oracle_hist_dtype`` (bf16 halves the gathered copy) and
    `_chunk_attention`'s one softmax over history and chunk."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = _chunk_core(q, k, v, positions, cache, row_mask, hist_blocks,
                      valid, use_fused, oracle_hist_dtype)
    return _merge_heads(p, out.to(x.dtype), x.dtype), cache


def _chunk_attention(q, k, v, hk, hv, hist_len):
    """Exact attention of chunk queries over (resident history ‖ chunk):
    the parity oracle of the paged prefill kernel, one float32 softmax
    over the gathered, dequantized history and the chunk, as naive as
    the reference's.

    q (B, H, C, hd); k/v (B, Hkv, C, hd) the chunk's own keys; hk/hv
    (B, Hkv, HT, hd) the dequantized history (None when the dispatch has
    none; any float dtype, the logits in float32); hist_len (B,) tokens
    of real history a row, <= HT. History masked by hist_len, the chunk
    causally, each masked logit -1e30 and its probability zeroed."""
    B, H, C, hd = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    dev = q.device
    # 1 / sqrt(hd) in float32, a host number (no copy to the device: the
    # chunk step may be captured as a CUDA graph)
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd),
                                                dtype=torch.float32)))
    qg = q.reshape(B, Hkv, G, C, hd).float() * scale
    neg = -1e30
    lc = torch.einsum("bhgcd,bhtd->bhgct", qg, k.float())
    ar = torch.arange(C, device=dev)
    mc = ar[None, :] <= ar[:, None]                        # (C, C) causal
    lc = torch.where(mc[None, None, None], lc, neg)
    if hk is None:
        logits, vs = lc, v.float()
    else:
        HT = hk.shape[2]
        lh = torch.einsum("bhgcd,bhtd->bhgct", qg, hk.float())
        mh = (torch.arange(HT, device=dev)[None, :]
              < hist_len.to(dev)[:, None])                 # (B, HT)
        lh = torch.where(mh[:, None, None, None, :], lh, neg)
        logits = torch.cat([lh, lc], dim=-1)               # (..., HT + C)
        vs = torch.cat([hv.float(), v.float()], dim=2)
    m = torch.amax(logits, dim=-1, keepdim=True)
    pexp = torch.exp(logits - m)
    pexp = torch.where(logits <= -1e30 / 2, torch.zeros_like(pexp), pexp)
    l = torch.sum(pexp, dim=-1, keepdim=True)
    out = torch.einsum("bhgct,bhtd->bhgcd",
                       pexp / torch.clamp_min(l, 1e-30), vs)
    return out.reshape(B, H, C, hd)


def _decode_core(q, k, v, cfg, cache, local: bool, row_mask):
    """Append one token's K/V (B, Hkv, 1, D) to the cache, then attention
    of q (B, H, 1, D) over it: (B, H, 1, D) float32."""
    if isinstance(cache, PagedQuantizedKVCache):
        cache.append(k.float(), v.float(), row_mask=row_mask)
        out = _decode_paged(q[:, :, 0], cache)
    else:
        _check_row_mask(cache, row_mask, "decode")
        cache.append(k.float(), v.float())
        window = _window(cfg, local) if cache.ring else None
        if isinstance(cache, ShardedKVCache) and cache.per_channel:
            o, _, l = cache.decode_partials(q[:, :, 0], cache.length,
                                            window=window)
            out = o / torch.clamp_min(l, 1e-30)
        elif cache.per_channel:
            out = ops.quant_attention_decode(
                q[:, :, 0], cache.k_q, cache.k_s, cache.v_q, cache.v_s,
                cache.length, window=window)
        else:
            out = _decode_blocked(q[:, :, 0], cache, window=window)
    return out[:, :, None]


def decode(p, x, cfg, positions, cache, *, local: bool = False,
           row_mask=None):
    """One-token step: append K/V, then attention over the int8 cache
    (merged with the exact fp residual tail where there is one; a ring's
    slots masked by the window). ``row_mask`` (B,) bool freezes unmasked
    rows' caches (paged only)."""
    q, k, v = _project_qkv(p, x, cfg, positions)          # S == 1
    out = _decode_core(q, k, v, cfg, cache, local, row_mask)
    return _merge_heads(p, out.to(x.dtype), x.dtype), cache


def serve_tp(p, sp, x, cfg, positions, cache, mode: str, *,
             local: bool = False, causal: bool = True, row_mask=None,
             hist_blocks=None, valid=None, mesh=None,
             use_fused: bool = True):
    """One serving step's attention on this rank's shards of the
    weights (``sp`` their specs, `launch.specs.serve_param_specs`): x
    (B_l, S, d) this rank's rows, whole on the ranks of "model". Q, K and
    V are projected on the rank's head columns. Over a paged pool of the
    rank's kv heads (``cache.kv_axes``) the step runs on them alone and
    the heads' outputs are gathered; in a prompt over any other cache
    (every kv head on every rank) the flash runs on the rank's query
    heads and the kv heads they read, and the cache takes every head's
    K/V (gathered); a prompt without a cache (``cache`` None: whisper's
    encoder, ``causal`` False) gathers none; a decode step or a chunk
    over such a cache gathers the heads of Q, K and V and runs every
    head on every rank (a sequence-sharded cache's partials merged in
    rank order: the same bits on every rank). The heads' outputs times
    the rank's output columns of ``wo``, gathered over theirs, give
    (B_l, S, d): each element one whole dot product, as one process
    computes it (`_out_tp`)."""
    qa, kva = sp["wq"][-1], sp["wk"][-1]
    q, k, v = _project_qkv(p, x, cfg, positions)
    paged = isinstance(cache, PagedQuantizedKVCache)
    heads = qa
    if paged and tuple(getattr(cache, "kv_axes", ())) != tuple(kva):
        raise ValueError(f"the pool's kv heads over {cache.kv_axes}, the "
                         f"kv projections' over {kva}")
    if mode == "prefill":
        _check_row_mask(cache, row_mask, "prefill")
        kw, vw = (k, v) if paged or cache is None else gather_heads(
            mesh, (k, kva), (v, kva))
        if not kva:                        # the kv heads the rank's read
            r0, r1 = head_slice(cfg, sp, mesh)["reads"]
            k, v = kw[:, r0:r1], vw[:, r0:r1]
        out = _sdpa(q, k, v, causal=causal, window=_window(cfg, local))
        if cache is not None:
            _write_prompt(cache, kw, vw, row_mask)
    else:
        if not (paged and kva):            # every head on every rank
            q, k, v = gather_heads(mesh, (q, qa), (k, kva), (v, kva))
            heads = ()
        if mode == "chunk":
            out = _chunk_core(q, k, v, positions, cache, row_mask,
                              hist_blocks, valid, use_fused)
        elif mode == "decode":
            out = _decode_core(q, k, v, cfg, cache, local, row_mask)
        else:
            raise ValueError(f"unknown serving mode {mode!r}")
    return _out_tp(p, out, heads, sp["wo"][-1], mesh, x.dtype)


def _out_tp(p, out, heads, oa, mesh, dtype):
    """The heads' outputs (B, h, S, hd), this rank's heads over ``heads``
    (``()``: every head) -> rounded to ``dtype``, gathered, times the
    rank's ``wo`` columns (over ``oa``), gathered: (B, S, d)."""
    o = gather_cols(_merge_heads({}, out.to(dtype), dtype), heads, mesh)
    return gather_cols(o @ p["wo"], oa, mesh)


def _decode_blocked(q, cache: QuantizedKVCache, *, window=None):
    """The flat decode kernel over the flushed blocks (over a sharded
    cache: every rank's slots, merged) merged with exact attention over
    the residual tail. Ring ages in the quantized part count
    from the flushed prefix, and its window budget leaves out the n_tail
    newest (residual) tokens."""
    bs = cache.block_size
    flushed = (cache.length // bs) * bs
    n_tail = cache.length % bs
    win_q = None if window is None else max(window - n_tail, 0)
    if isinstance(cache, ShardedKVCache):
        o1, m1, l1 = cache.decode_partials(q, flushed, window=win_q)
    else:
        o1, m1, l1 = ops.quant_attention_decode_partials(
            q, cache.k_q, cache.k_s, cache.v_q, cache.v_s, flushed,
            window=win_q)
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
