"""Serving step functions over the paged quantized KV cache (port of the
paged half of ``repro.serving.engine``).

`make_serve_fns` returns the state initializer and the decode step;
`make_chunk_prefill_fn` the varlen chunk-prefill step the scheduler's
admission rides on. PyTorch runs eagerly, so these are plain closures (the
reference wraps them in ``jax.jit``).
"""
from __future__ import annotations

from repro_torch.models import transformer


def make_serve_fns(cfg, *, max_len: int, n_pages: int | None = None,
                   kv_cache_dtype: str = "int8", device="cuda"):
    """Returns (init_state(batch), decode(params, token, state, pos,
    row_mask)) closed over cfg, paged."""
    def init_state(batch):
        return transformer.init_decode_state(
            cfg, batch, max_len, n_pages=n_pages,
            kv_cache_dtype=kv_cache_dtype, device=device)

    def decode_fn(params, token, state, pos, row_mask=None):
        return transformer.decode_step(params, token, cfg, state, pos,
                                       row_mask=row_mask)

    return init_state, decode_fn


def make_chunk_prefill_fn(cfg, *, hist_blocks: int | None = None):
    """``chunk_prefill(params, tokens, state, start, valid, row_mask)`` with
    tokens (B, C) (C a page multiple), start (B,) resident token counts,
    valid (B,) true tokens per row, row_mask (B,) bool -> (last-valid-
    position logits (B, Vp), state). ``hist_blocks`` bounds each layer's
    history walk."""
    transformer.check_servable(cfg)

    def chunk_prefill(params, tokens, state, start, valid, row_mask):
        return transformer.prefill_chunk(params, tokens, cfg, state,
                                         start=start, valid=valid,
                                         row_mask=row_mask,
                                         hist_blocks=hist_blocks)

    return chunk_prefill


def kv_cache_memory_report(cfg, batch: int, seq: int, scheduler=None) -> dict:
    """Paper Table 1 for this arch: cache bytes at fp32 / bf16 / int8; with
    the scheduler, its TTFT percentiles (pool occupancy is in
    `ContinuousBatcher.pool_report`)."""
    rep = {
        "fp32_bytes": cfg.kv_cache_bytes(batch, seq, 4),
        "bf16_bytes": cfg.kv_cache_bytes(batch, seq, 2),
        "int8_bytes": cfg.kv_cache_bytes(batch, seq, 1),
        "compression_vs_fp32": 4.0,
        "compression_vs_bf16": 2.0,
    }
    if scheduler is not None:
        rep.update(scheduler.lifecycle_report())
    return rep
