"""Decoder-only transformer for training and serving (port of
``repro.models.transformer``, dense full-attention stacks).

Parameters are a dict: ``embed`` (Vp, d), ``lm_head`` (d, Vp),
``final_norm``, and ``layers`` — one dict per layer (norm1, attn, norm2,
mlp). The reference stacks layers on a leading axis for ``lax.scan``; the
port keeps a list and loops, and `decode_scan` is a Python loop. The
serving state is a list of per-layer caches: contiguous
`QuantizedKVCache`s (the default) or paged `PagedQuantizedKVCache`s.
`forward_train` recomputes each block in the backward
(`torch.utils.checkpoint`), as the reference's per-block
``jax.checkpoint(nothing_saveable)``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quantization as Q
from repro_torch.core.kvcache import QuantizedKVCache
from repro_torch.core.paging import PagedQuantizedKVCache
from repro_torch.core.tree import leaves, tree_map
from repro_torch.models import attention, mlp
from repro_torch.models import sampling as SMP
from repro_torch.models.common import (dense_init, embed_init, rmsnorm,
                                       rmsnorm_init)


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab // 128) * 128


def check_device(device) -> torch.device:
    """The entry points' device rule: the device asked for, or an error —
    never a silent move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is "
                               "available; pass device='cpu' to run the "
                               "kernels' plain PyTorch versions")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_servable(cfg) -> None:
    """The port serves dense full-attention stacks only (the ring cache of
    sliding windows is ported, but no servable config reaches it yet)."""
    bad = [k for k in cfg.block_pattern if k != "attn"]
    if bad or cfg.sliding_window or cfg.tie_embeddings or cfg.qkv_bias \
            or cfg.mrope_sections or cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense full-attention RMSNorm "
            f"stacks only; other architectures are ROADMAP queue 1, item 15")


def init_params(cfg, generator: torch.Generator | None = None, *,
                device="cuda") -> dict:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (a `torch.Generator` on ``device``; None = seed 0)."""
    device = check_device(device)
    check_servable(cfg)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    Vp, dt = padded_vocab(cfg), cfg.activation_dtype
    params = {
        "embed": embed_init(generator, Vp, cfg.d_model, dt, device),
        "final_norm": rmsnorm_init(cfg.d_model, device),
        "lm_head": dense_init(generator, cfg.d_model, Vp, dt, device),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "norm1": rmsnorm_init(cfg.d_model, device),
            "attn": attention.init(cfg, generator, device),
            "norm2": rmsnorm_init(cfg.d_model, device),
            "mlp": mlp.init(cfg, generator, device),
        })
    return params


def init_decode_state(cfg, batch: int, max_len: int, *, paged: bool = False,
                      n_pages: int | None = None, kv_cache_dtype="int8",
                      device="cuda") -> list:
    """One cache per layer: a contiguous `QuantizedKVCache` (int8 only; a
    ring of the window's block-rounded length under a sliding window), or
    with ``paged=True`` a paged cache over its own pool of ``n_pages``
    pages (default: dense capacity, batch * max_len / page + sentinel)."""
    device = check_device(device)
    check_servable(cfg)
    if kv_cache_dtype not in Q.KV_DTYPES:
        raise NotImplementedError(
            f"kv_cache_dtype={kv_cache_dtype!r}: the port takes one uniform "
            f"dtype of {Q.KV_DTYPES}; mixed per-layer plans are ROADMAP "
            f"queue 1, item 11")
    if not paged:
        if kv_cache_dtype != "int8":
            raise ValueError(f"kv_cache_dtype={kv_cache_dtype!r} requires the "
                             f"paged cache (the contiguous backends are "
                             f"int8-only)")
        eff = max_len
        if cfg.sliding_window:
            eff = min(max_len, _round_block(cfg.sliding_window, cfg))
        return [QuantizedKVCache.init(batch, cfg.n_kv_heads, eff,
                                      cfg.head_dim, cfg.quant,
                                      ring=eff < max_len, device=device)
                for _ in range(cfg.n_layers)]
    if n_pages is None:
        n_pages = batch * (max_len // cfg.quant.block_size) + 1
    return [PagedQuantizedKVCache.init(
        batch, cfg.n_kv_heads, max_len, cfg.head_dim, cfg.quant,
        n_pages=n_pages, kv_dtype=kv_cache_dtype, device=device)
        for _ in range(cfg.n_layers)]


def stack_layers(tree) -> dict:
    """The port's layout (``layers``: one dict per layer) -> the
    reference's (``blocks.p0``: each leaf stacked over layers on axis 0);
    the other top-level entries unchanged."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    out["blocks"] = {"p0": tree_map(lambda *xs: torch.stack(xs),
                                    layers[0], *layers[1:])}
    return out


def unstack_layers(tree) -> dict:
    """Inverse of `stack_layers` (the layers are views of the stack)."""
    out = {k: v for k, v in tree.items() if k != "blocks"}
    stacked = tree["blocks"]["p0"]
    n = leaves(stacked)[0].shape[0]
    out["layers"] = [tree_map(lambda x, i=i: x[i], stacked) for i in range(n)]
    return out


def check_trainable(cfg) -> None:
    """The port trains the dense family only (and, through `init_params`,
    the dense stacks it serves)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the port trains the dense family only; "
            f"{cfg.family!r} models are ROADMAP queue 1, item 15")


# -- training -----------------------------------------------------------------

def _embed(params, tok, positions):
    """tokens (B, S) -> (embeddings (B, S, d), positions (B, S) int32;
    0..S-1 when None)."""
    B, S = tok.shape
    x = params["embed"][tok]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tok.device)[None].expand(B, S)
    return x, positions


def _block_train(p, x, cfg, positions):
    x = x + attention.train(p["attn"], rmsnorm(p["norm1"], x), cfg, positions)
    return x + mlp.apply(p["mlp"], rmsnorm(p["norm2"], x))


def forward_train(params, tokens, cfg, *, positions=None,
                  remat: bool = True):
    """-> (logits (B, S, Vp), aux_loss ()). tokens (B, S) int. With
    ``remat`` each block keeps only its input for the backward and runs
    its forward again there (flash attention's kernel included)."""
    check_trainable(cfg)
    x, positions = _embed(params, tokens, positions)
    for p in params["layers"]:
        if remat:
            x = checkpoint(_block_train, p, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _block_train(p, x, cfg, positions)
    return _head(params, x), torch.zeros((), dtype=torch.float32,
                                         device=x.device)


# -- serving ------------------------------------------------------------------

def _round_block(n: int, cfg) -> int:
    """``n`` rounded up to the cache block (8 in per_channel mode)."""
    b = cfg.quant.block_size if cfg.quant.granularity == "per_block" else 8
    return -(-n // b) * b


def _block_serve(p, x, cfg, positions, cache, mode: str, row_mask=None,
                 hist_blocks=None, valid=None):
    h = rmsnorm(p["norm1"], x)
    if mode == "prefill":
        h, cache = attention.prefill(p["attn"], h, cfg, positions, cache,
                                     row_mask=row_mask)
    elif mode == "chunk":
        h, cache = attention.prefill_chunk(p["attn"], h, cfg, positions,
                                           cache, row_mask=row_mask,
                                           hist_blocks=hist_blocks,
                                           valid=valid)
    elif mode == "decode":
        h, cache = attention.decode(p["attn"], h, cfg, positions, cache,
                                    row_mask=row_mask)
    else:
        raise ValueError(f"unknown serving mode {mode!r}")
    x = x + h.to(x.dtype)
    return x + mlp.apply(p["mlp"], rmsnorm(p["norm2"], x))


def _serve(params, tok, cfg, state, positions, mode: str, row_mask=None,
           hist_blocks=None, valid=None):
    """Run every layer over tokens (B, S); returns the final hidden states
    (B, S, d) — the head is applied by the caller, only where it reads
    logits (the same numbers as the reference's all-position head)."""
    x = params["embed"][tok]
    for p, cache in zip(params["layers"], state):
        x = _block_serve(p, x, cfg, positions, cache, mode, row_mask,
                         hist_blocks, valid)
    return x


def _head(params, x):
    return rmsnorm(params["final_norm"], x) @ params["lm_head"]


def prefill(params, tokens, cfg, state, *, positions=None, row_mask=None):
    """Prompt pass over the contiguous caches: tokens (B, S) at positions
    0..S-1 (default). Returns (logits of the last position (B, Vp),
    state)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    x = _serve(params, tokens, cfg, state, positions, "prefill", row_mask)
    return _head(params, x[:, -1]), state


def prefill_chunk(params, tokens, cfg, state, *, start, row_mask=None,
                  hist_blocks=None, valid=None):
    """One varlen chunked-prefill step: ``tokens`` (B, C) int (C a page
    multiple), ``start`` (B,) each row's page-aligned resident token count,
    ``valid`` (B,) true tokens per row (None = C). Returns (logits (B, Vp)
    at each row's last valid position, state)."""
    C = tokens.shape[1]
    positions = start[:, None].to(torch.int32) + torch.arange(
        C, dtype=torch.int32, device=tokens.device)[None]
    x = _serve(params, tokens, cfg, state, positions, "chunk", row_mask,
               hist_blocks, valid)
    if valid is None:
        last = x[:, -1]
    else:
        idx = torch.clamp_min(valid.to(torch.int64) - 1, 0)
        last = x[torch.arange(x.shape[0], device=x.device), idx]
    return _head(params, last), state


def decode_step(params, token, cfg, state, pos, *, row_mask=None):
    """One decode step: token (B, 1), pos (B,) current positions. Returns
    (logits (B, Vp), state)."""
    positions = pos[:, None].to(torch.int32)
    x = _serve(params, token, cfg, state, positions, "decode", row_mask)
    return _head(params, x[:, -1]), state


def decode_scan(params, token, cfg, state, pos, *, steps: int,
                row_mask=None):
    """Greedy decode of ``steps`` tokens. ``token`` (B, 1) is the pending
    token (sampled, not yet fed), ``pos`` (B,) its position. Returns
    (pending (B, 1), state, emitted (steps, B)): emitted[j] is the token
    fed at step j. Argmax takes the first index on ties."""
    toks = []
    for _ in range(steps):
        logits, state = decode_step(params, token, cfg, state, pos,
                                    row_mask=row_mask)
        toks.append(token[:, 0])
        token = SMP.greedy(logits, cfg.vocab)[:, None]
        pos = pos + 1
    return token, state, torch.stack(toks)
