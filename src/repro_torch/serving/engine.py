"""Serving step functions over the quantized KV cache (port of
``repro.serving.engine``).

Two cache backends, as in the reference: contiguous (the default; one
max_len slab per row and one length for all rows, so the scheduler
rebuilds the batch on admission) and paged (``paged=True``; page pools with
per-row page tables, admission by varlen chunked prefill).

`make_serve_fns` returns the state initializer, the prefill and the decode
step; `make_chunk_prefill_fn` the paged chunk-prefill step;
`generate` / `greedy_generate` the reference generation path (contiguous:
a block-multiple prefill, the prompt's remainder fed through decode, then
greedy decode). PyTorch runs eagerly, so these are plain closures and
loops (the reference jits them).
"""
from __future__ import annotations

import torch

from repro_torch.models import sampling as SMP
from repro_torch.models import transformer


def make_serve_fns(cfg, *, max_len: int, paged: bool = False,
                   n_pages: int | None = None, kv_cache_dtype: str = "int8",
                   device="cuda"):
    """Returns (init_state(batch), prefill(params, tokens, state,
    row_mask=None), decode(params, token, state, pos, row_mask=None))
    closed over cfg. ``paged=True`` backs the state with page pools of
    ``n_pages`` pages per layer; ``kv_cache_dtype`` other than int8
    requires it."""
    def init_state(batch):
        return transformer.init_decode_state(
            cfg, batch, max_len, paged=paged, n_pages=n_pages,
            kv_cache_dtype=kv_cache_dtype, device=device)

    def prefill_fn(params, tokens, state, row_mask=None):
        return transformer.prefill(params, tokens, cfg, state,
                                   row_mask=row_mask)

    def decode_fn(params, token, state, pos, row_mask=None):
        return transformer.decode_step(params, token, cfg, state, pos,
                                       row_mask=row_mask)

    return init_state, prefill_fn, decode_fn


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


def generate(params, cfg, prompts, *, steps: int, sampling=None,
             max_len: int | None = None, device="cuda") -> torch.Tensor:
    """Reference end-to-end generation over the contiguous cache: decode
    ``steps`` tokens after a batched prefill of ``prompts`` (B, S) int.
    Returns (B, steps) int32 on ``device``.

    The prompt splits into a block-multiple prefix ``S0`` (none when S is
    shorter than a block), prefilled at once, and a remainder fed token by
    token through decode (teacher-forced); then greedy decode. ``max_len``
    defaults to S + steps rounded up to the block (8 in per_channel mode).
    ``sampling=None`` is exact greedy argmax, the only arm ported."""
    if sampling is not None:
        raise NotImplementedError("sampled generate needs the threefry "
                                  "sampler port (ROADMAP queue 1, item 6)")
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
    state = init_state(B)
    if S0:
        logits, state = prefill_fn(params, prompts[:, :S0], state)
    pos = torch.full((B,), S0, dtype=torch.int32, device=device)
    for j in range(S0, S):                  # teacher-forced remainder
        logits, state = decode_fn(params, prompts[:, j:j + 1], state, pos)
        pos = pos + 1
    tok0 = SMP.greedy(logits, cfg.vocab)[:, None]
    _, _, toks = transformer.decode_scan(params, tok0, cfg, state, pos,
                                         steps=steps)
    return toks.T


def greedy_generate(params, cfg, prompts, *, steps: int,
                    max_len: int | None = None, device="cuda"):
    """`generate` with ``sampling=None``: exact greedy argmax, the named
    special case the reference's accuracy benchmarks and tests pin."""
    return generate(params, cfg, prompts, steps=steps, sampling=None,
                    max_len=max_len, device=device)


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
