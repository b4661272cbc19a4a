"""Serving step functions over the quantized KV cache (port of
``repro.serving.engine``).

Two cache backends, as in the reference: contiguous (the default; one
max_len slab per row and one length for all rows, so the scheduler
rebuilds the batch on admission) and paged (``paged=True``; page pools with
per-row page tables, admission by varlen chunked prefill).

`make_serve_fns` returns the state initializer, the prefill and the decode
step (for an encoder-decoder, `models.encdec`'s: its prefill takes the
reference's ``{"frames", "tokens"}`` batch; contiguous and int8 only);
`make_chunk_prefill_fn` the paged chunk-prefill step (decoder-only);
`generate` / `greedy_generate` the reference generation path (contiguous:
a block-multiple prefill, the prompt's remainder fed through decode, then
greedy or seeded sampled decode). These are plain closures and loops;
where the reference jits them, the paged scheduler captures its steps as
CUDA graphs on the card (`serving.dispatch`), and `generate` runs
eagerly (ROADMAP queue 1, item 16's remainder).

Under `parallel.shard.mesh_context` (a mesh of ranks, each calling the
same functions in step), `make_serve_fns` and `make_chunk_prefill_fn`
serve sharded as the reference's functions do under its mesh (every
decoder stack, and the encoder-decoder through `models.encdec`'s mesh
paths; a mesh of one rank too). ``init_state``
builds this rank's shards of the state (`launch.specs.init_serve_state`);
the steps take this rank's shards of the parameters, laid out by
`launch.specs.serve_param_specs`, take the global batch and return
every row's logits. Every stack serves tensor parallel (the attention
and MoE stacks, the recurrent ones and the encoder-decoder alike): each
rank holds and computes with its shards alone, from load to the end
(heads, kv heads, d_ff, the RG-LRU's channels, the mLSTM's heads, the
vocabulary and the output columns over "model"; the sLSTM whole by
layout), and no weight byte crosses between ranks. The functions run
under the mesh and rules they were built under (None included; an
override of the logical rules, `parallel.shard.SSM_RULES`, included),
whatever is active when they are called. `generate`, the batchers and
the serve CLI run on one device and refuse a mesh (`check_one_device`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import leaves
from repro_torch.models import encdec
from repro_torch.models import sampling as SMP
from repro_torch.models import transformer
from repro_torch.parallel.shard import (current_mesh, mesh_context,
                                        rules_override)
from repro_torch.serving.params import SamplingParams, sampling_arrays


def check_encdec(paged: bool, kv_cache_dtype) -> None:
    """The reference's refusals for an encoder-decoder's serving."""
    if paged:
        raise ValueError("paged serving is decoder-only (whisper's "
                         "cross-attention cache is write-once)")
    if kv_cache_dtype != "int8":
        raise ValueError("kv_cache_dtype is a paged-backend feature")


def check_one_device(what: str) -> None:
    """``what`` runs on one device: under a mesh it raises `ValueError`
    rather than run each rank's one-device path."""
    mesh = current_mesh()
    if mesh is not None:
        raise ValueError(
            f"{what} under a mesh of {mesh.size} ranks waits for ROADMAP "
            f"item 15; serve sharded through make_serve_fns and "
            f"make_chunk_prefill_fn")


def _on_mesh(mesh, cfg, fn, rules=None):
    """``fn(params, ...)`` run under ``mesh`` and ``rules``; under a mesh
    on this rank's shards as they are, ``fn`` given their specs
    (``specs=``; the shards' shapes checked against
    `launch.specs.serve_param_specs`, so a tree in another layout
    raises)."""
    if mesh is not None:
        from repro_torch.launch.specs import serve_param_specs, shard_shapes
        with mesh_context(mesh, rules):
            specs = serve_param_specs(cfg, mesh)
            want = shard_shapes(cfg, specs, mesh)

    def run(params, *args, **kw):
        with mesh_context(mesh, rules):
            if mesh is None:
                return fn(params, *args, **kw)
            got = [tuple(t.shape) for t in leaves(params)]
            if got != want:
                raise ValueError(
                    f"{cfg.name} serves tensor parallel: pass this rank's "
                    f"shards laid out by launch.specs.serve_param_specs "
                    f"(init_shards, or refit_tree from training's "
                    f"param_specs)")
            return fn(params, *args, specs=specs, **kw)
    return run


def make_serve_fns(cfg, *, max_len: int, paged: bool = False,
                   n_pages: int | None = None, kv_cache_dtype="int8",
                   device="cuda"):
    """Returns (init_state(batch), prefill(params, tokens, state,
    row_mask=None), decode(params, token, state, pos, row_mask=None))
    closed over cfg. ``paged=True`` backs the state with page pools of
    ``n_pages`` pages per layer; ``kv_cache_dtype`` (a dtype or a
    per-layer plan, `transformer.init_decode_state`) other than int8
    requires it. An encoder-decoder config (``cfg.family == "encdec"``)
    gets `models.encdec`'s functions: prefill(params, batch_inputs,
    state, row_mask=None) with ``batch_inputs`` the reference's dict of
    ``"frames"`` (B, T_enc, d) and ``"tokens"`` (B, S), and decode(params,
    token, state, pos); paged or a dtype other than int8 raise the
    reference's `ValueError`.

    Under a mesh (module docstring) ``init_state(batch)`` gives this
    rank's shards of the state (an encoder-decoder's ``self`` and
    ``cross`` caches alike), prefill and decode take this rank's
    parameter shards (`launch.specs.serve_param_specs`' layout) and the
    global batch (``frames`` and ``tokens`` alike) and return (logits
    (B, Vp), state)."""
    mesh, rules = current_mesh(), rules_override()
    if cfg.family == "encdec":
        check_encdec(paged, kv_cache_dtype)

    def init_state(batch):
        if mesh is not None:
            from repro_torch.launch.specs import init_serve_state
            with mesh_context(mesh, rules):
                return init_serve_state(cfg, batch, max_len, mesh,
                                        paged=paged, n_pages=n_pages,
                                        kv_cache_dtype=kv_cache_dtype,
                                        device=device)
        if cfg.family == "encdec":
            return encdec.init_decode_state(cfg, batch, max_len,
                                            device=device)
        return transformer.init_decode_state(
            cfg, batch, max_len, paged=paged, n_pages=n_pages,
            kv_cache_dtype=kv_cache_dtype, device=device)

    if cfg.family == "encdec":
        def prefill_fn(params, batch_inputs, state, row_mask=None,
                       specs=None):
            return encdec.prefill(params, batch_inputs["frames"],
                                  batch_inputs["tokens"], cfg, state,
                                  specs=specs)

        def decode_fn(params, token, state, pos, specs=None):
            return encdec.decode_step(params, token, cfg, state, pos,
                                      specs=specs)

        return (init_state, _on_mesh(mesh, cfg, prefill_fn, rules),
                _on_mesh(mesh, cfg, decode_fn, rules))

    def prefill_fn(params, tokens, state, row_mask=None, specs=None):
        return transformer.prefill(params, tokens, cfg, state,
                                   row_mask=row_mask, specs=specs)

    def decode_fn(params, token, state, pos, row_mask=None, specs=None):
        return transformer.decode_step(params, token, cfg, state, pos,
                                       row_mask=row_mask, specs=specs)

    return (init_state, _on_mesh(mesh, cfg, prefill_fn, rules),
            _on_mesh(mesh, cfg, decode_fn, rules))


def make_chunk_prefill_fn(cfg, *, hist_blocks: int | None = None,
                          use_fused: bool = True):
    """``chunk_prefill(params, tokens, state, start, valid, row_mask)`` with
    tokens (B, C) (C a page multiple), start (B,) resident token counts,
    valid (B,) true tokens per row, row_mask (B,) bool -> (last-valid-
    position logits (B, Vp), state). ``hist_blocks`` bounds each layer's
    history walk. ``use_fused`` picks the paged prefill kernel (True) or
    the dequantize-gather parity oracle (`attention.prefill_chunk`); it
    is part of the closure's identity, so the scheduler keys its chunk
    steps on it. Decoder-only, as the reference's. Under a mesh, as
    `make_serve_fns`' steps: this rank's parameter shards and the global
    batch in, every row's logits out."""
    if cfg.family == "encdec":
        raise ValueError("chunked prefill is decoder-only")
    mesh, rules = current_mesh(), rules_override()

    def chunk_prefill(params, tokens, state, start, valid, row_mask,
                      specs=None):
        return transformer.prefill_chunk(params, tokens, cfg, state,
                                         start=start, valid=valid,
                                         row_mask=row_mask,
                                         hist_blocks=hist_blocks,
                                         specs=specs, use_fused=use_fused)

    return _on_mesh(mesh, cfg, chunk_prefill, rules)


def generate(params, cfg, prompts, *, steps: int, sampling=None,
             max_len: int | None = None, device="cuda") -> torch.Tensor:
    """Reference end-to-end generation over the contiguous cache: decode
    ``steps`` tokens after a batched prefill of ``prompts`` (B, S) int.
    Returns (B, steps) int32 on ``device``.

    The prompt splits into a block-multiple prefix ``S0`` (none when S is
    shorter than a block), prefilled at once, and a remainder fed token by
    token through decode (teacher-forced); then decode. ``max_len``
    defaults to S + steps rounded up to the block (8 in per_channel mode).
    ``sampling`` is None (exact greedy argmax), one `SamplingParams` for
    every row or a sequence of one per row; row i's seed defaults to i.
    Token 0 is drawn from the prefill's logits, the rest in the scan. Stop
    conditions are the scheduler's, not handled here. Decoder-only: an
    encoder-decoder config raises `ValueError` (its prefill needs frames,
    which the reference's ``generate`` does not feed either). One device
    only: under a mesh it raises `ValueError`."""
    check_one_device("generate")
    transformer.check_servable(cfg)
    device = transformer.check_device(device)
    if params["embed"].device != device:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"generate runs on {device}")
    prompts = torch.as_tensor(prompts).to(device=device, dtype=torch.int32)
    B, S = prompts.shape
    bs = (cfg.quant.block_size if cfg.quant.granularity == "per_block"
          else 8)
    max_len = max_len or -(-(S + steps) // bs) * bs
    init_state, prefill_fn, decode_fn = make_serve_fns(
        cfg, max_len=max_len, device=device)
    S0 = max(bs, (S // bs) * bs) if S >= bs else 0
    samp = None
    if sampling is not None:
        sps = ([sampling] * B if isinstance(sampling, SamplingParams)
               else list(sampling))
        if len(sps) != B:
            raise ValueError(f"got {len(sps)} SamplingParams for {B} rows")
        samp = SMP.device_arrays(sampling_arrays(sps), device)
    state = init_state(B)
    if S0:
        logits, state = prefill_fn(params, prompts[:, :S0], state)
    pos = torch.full((B,), S0, dtype=torch.int32, device=device)
    for j in range(S0, S):                  # teacher-forced remainder
        logits, state = decode_fn(params, prompts[:, j:j + 1], state, pos)
        pos = pos + 1
    if samp is None:
        tok0 = SMP.greedy(logits, cfg.vocab)[:, None]
    else:
        tok0 = SMP.sample_at_step(
            logits, samp["temperature"], samp["top_k"], samp["top_p"],
            samp["key"], samp["step"], vocab=cfg.vocab)[:, None]
        samp = dict(samp, step=samp["step"] + 1)
    _, _, toks = transformer.decode_scan(params, tok0, cfg, state, pos,
                                         steps=steps, sampling=samp)
    return toks.T


def greedy_generate(params, cfg, prompts, *, steps: int,
                    max_len: int | None = None, device="cuda"):
    """`generate` with ``sampling=None``: exact greedy argmax, the named
    special case the reference's accuracy benchmarks and tests pin."""
    return generate(params, cfg, prompts, steps=steps, sampling=None,
                    max_len=max_len, device=device)


def kv_cache_memory_report(cfg, batch: int, seq: int, paged_cache=None,
                           scheduler=None) -> dict:
    """Paper Table 1 for this arch: cache bytes at fp32 / bf16 / int8.

    ``paged_cache`` (a `PagedQuantizedKVCache`, or the batcher's list of
    them, one a layer, whose allocator moves every layer alike) adds the
    pool's occupancy as the reference reports it: ``pool_pages_allocated``
    every page off the free list (cached pages included),
    ``pool_pages_live`` the distinct pages holding tokens, one layer's
    ``pool_page_bytes``, their ratio and bytes. A list whose layers differ
    in dtype (a mixed plan) reports ``kv_cache_dtype`` "mixed", the
    per-layer ``kv_cache_layer_dtypes`` and the page bytes averaged over
    the layers (rounded down). ``scheduler`` adds its TTFT
    percentiles and abort count and, with a host tier, the tier's pages,
    bytes and utilization against its own capacity (``host_tier_*``): a
    demoted page counts on exactly one tier."""
    rep = {
        "fp32_bytes": cfg.kv_cache_bytes(batch, seq, 4),
        "bf16_bytes": cfg.kv_cache_bytes(batch, seq, 2),
        "int8_bytes": cfg.kv_cache_bytes(batch, seq, 1),
        "compression_vs_fp32": 4.0,
        "compression_vs_bf16": 2.0,
    }
    layer_dtypes = None
    if isinstance(paged_cache, list):
        dts = [c.pool.kv_dtype for c in paged_cache]
        if len(set(dts)) > 1:
            layer_dtypes = dts
            mixed_bytes = [_page_bytes(c.pool) for c in paged_cache]
        paged_cache = paged_cache[0]
    if paged_cache is not None:
        from repro_torch.core.paging import live_page_count
        pool = paged_cache.pool
        n_pages = pool.k_q.shape[0]
        capacity = n_pages - 1                   # page 0 is the sentinel
        tables = paged_cache.page_table.cpu().numpy()
        lengths = np.minimum(paged_cache.length.cpu().numpy(),
                             paged_cache.max_blocks * pool.page_size)
        live = live_page_count(tables, lengths, pool.page_size)
        page_bytes = _page_bytes(pool)
        allocated = capacity - pool.n_free
        if layer_dtypes is not None:
            page_bytes = sum(mixed_bytes) // len(mixed_bytes)
            rep["kv_cache_layer_dtypes"] = layer_dtypes
        rep.update({
            "kv_cache_dtype": ("mixed" if layer_dtypes is not None
                               else pool.kv_dtype),
            "pool_pages_total": capacity,
            "pool_pages_allocated": allocated,
            "pool_pages_live": live,
            "pool_page_bytes": page_bytes,
            "pool_utilization": live / max(allocated, 1),
            "pool_bytes_allocated": allocated * page_bytes,
        })
    if scheduler is not None:
        rep.update(scheduler.lifecycle_report())
        tier = getattr(scheduler, "_tiering", None)
        if tier is not None:
            rep.update({
                "host_tier_pages_capacity": tier.capacity,
                "host_tier_pages_used": len(tier),
                "host_tier_bytes": tier.nbytes,
                "host_tier_utilization": len(tier) / max(tier.capacity, 1),
                "host_tier_dtype": tier.dtype,
            })
    return rep


def _page_bytes(pool) -> int:
    """One page of one layer's pool: values and scale rows, K and V."""
    return sum(t.numel() * t.element_size() for t in
               (pool.k_q, pool.v_q, pool.k_s, pool.v_s)) // pool.k_q.shape[0]
