"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``;
arXiv:2212.04356).

The conv frontend is a stub, as in the reference: the encoder takes
precomputed (B, T_frames, d_model) frame embeddings (`data.make_frames`).
The transformer backbone is whole: an encoder self-attention stack
(non-causal), and a decoder with causal self-attention and
cross-attention over the encoder output. Norms are LayerNorm, the head
is the tied embedding (``x @ embed.T``). Positions are sinusoidal and
added to the inputs; the shared attention code gets zero positions, so
its RoPE is the identity.

KV-cache quantization sites (the paper's technique):
  * decoder self-attention: the config's contiguous cache (per block),
    one token appended a decode step;
  * cross-attention: K/V computed once from the encoder output at
    prefill and quantized per channel (paper Eq. 5) over the encoder
    length rounded up to 8, zero-padded, with ``length`` set to the true
    encoder length so decode masks the padding.

Parameters: ``embed`` (Vp, d), ``enc_layers`` (norm1, attn, norm2, mlp a
layer), ``dec_layers`` (norm1, self_attn, norm_x, cross_attn, norm2,
mlp), ``enc_norm`` and ``final_norm``. The serving state is a dict of
two lists, one cache a decoder layer: ``self`` and ``cross``, updated in
place.

As in the reference, a decode step adds the float32 sinusoid row to the
embedded token, so the decoder runs that step in float32: the weights
take part promoted to float32 (JAX promotes a bf16 x f32 product; torch
does not, so the port converts each layer's weights as it reaches it).
The prefill stays in the activation dtype.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.kvcache import QuantizedKVCache
from repro_torch.core.tree import tree_map
from repro_torch.models import attention, mlp
from repro_torch.models.common import embed_init, layernorm, layernorm_init
from repro_torch.models.transformer import (check_device,
                                            check_distributable,
                                            padded_vocab)
from repro_torch.parallel.shard import current_mesh


def _angles(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(..., 1) float32 positions -> the sinusoid (..., d): the
    reference's float32 expression, row by row."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos / torch.pow(torch.tensor(10000.0, device=pos.device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid(S: int, d: int, device) -> torch.Tensor:
    """(1, S, d) float32: positions 0..S-1."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    return _angles(pos, d)[None]


def sinusoid_rows(pos_b: torch.Tensor, d: int) -> torch.Tensor:
    """(B,) int positions -> (B, d) float32: the rows at ``pos_b`` of the
    table the reference builds at every decode step (``_sinusoid(1 << 17,
    d)``), computed alone by the same expression."""
    return _angles(pos_b.float()[:, None], d)


# the reference's stacks of the port's per-layer lists
STACKS = (("enc_blocks", "enc_layers"), ("dec_blocks", "dec_layers"))


def stack_layers(tree, stack=torch.stack) -> dict:
    """The port's layout -> the reference's: ``enc_layers`` and
    ``dec_layers`` as ``enc_blocks`` and ``dec_blocks``, each leaf the
    ``stack`` (default `torch.stack`: on axis 0) of the list of its
    layers' leaves; the other entries unchanged."""
    out = {k: v for k, v in tree.items() if k not in dict(STACKS).values()}
    for ref_key, port_key in STACKS:
        layers = tree[port_key]
        out[ref_key] = tree_map(lambda *xs: stack(list(xs)), layers[0],
                                *layers[1:])
    return out


def _zero_pos(B: int, S: int, device) -> torch.Tensor:
    return torch.zeros((B, S), dtype=torch.int32, device=device)


def _f32(tree):
    return tree_map(lambda t: t.float(), tree)


# -- init ---------------------------------------------------------------------

def _enc_block_init(cfg, gen, device) -> dict:
    return {"norm1": layernorm_init(cfg.d_model, device),
            "attn": attention.init(cfg, gen, device),
            "norm2": layernorm_init(cfg.d_model, device),
            "mlp": mlp.init(cfg, gen, device)}


def _dec_block_init(cfg, gen, device) -> dict:
    return {"norm1": layernorm_init(cfg.d_model, device),
            "self_attn": attention.init(cfg, gen, device),
            "norm_x": layernorm_init(cfg.d_model, device),
            "cross_attn": attention.init(cfg, gen, device),
            "norm2": layernorm_init(cfg.d_model, device),
            "mlp": mlp.init(cfg, gen, device)}


def init_params(cfg, generator: torch.Generator | None = None, *,
                device="cuda") -> dict:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (a `torch.Generator` on ``device``; None = seed 0)."""
    device = check_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    enc = [_enc_block_init(cfg, generator, device)
           for _ in range(cfg.n_encoder_layers)]
    dec = [_dec_block_init(cfg, generator, device)
           for _ in range(cfg.n_layers)]
    return {"embed": embed_init(generator, padded_vocab(cfg), cfg.d_model,
                                cfg.activation_dtype, device),
            "enc_layers": enc, "dec_layers": dec,
            "enc_norm": layernorm_init(cfg.d_model, device),
            "final_norm": layernorm_init(cfg.d_model, device)}


# -- encoder ------------------------------------------------------------------

def _enc_block(bp, x, cfg, pos):
    x = x + attention.train(bp["attn"], layernorm(bp["norm1"], x), cfg, pos,
                            causal=False)
    return x + mlp.apply(bp["mlp"], layernorm(bp["norm2"], x))


def encode(params, frames: torch.Tensor, cfg, remat: bool = False):
    """frames (B, T_enc, d) stub embeddings -> encoder output (B, T_enc,
    d) in the activation dtype. With ``remat`` each block keeps only its
    input for the backward."""
    B, S, d = frames.shape
    dt = cfg.activation_dtype
    x = frames.to(dt) + _sinusoid(S, d, frames.device).to(dt)
    pos = _zero_pos(B, S, frames.device)
    for bp in params["enc_layers"]:
        x = (checkpoint(_enc_block, bp, x, cfg, pos, use_reentrant=False)
             if remat else _enc_block(bp, x, cfg, pos))
    return layernorm(params["enc_norm"], x)


# -- decoder: training --------------------------------------------------------

def _dec_block_train(bp, x, enc_out, cfg, pos):
    x = x + attention.train(bp["self_attn"], layernorm(bp["norm1"], x), cfg,
                            pos, causal=True)
    h, _ = attention.cross_train(bp["cross_attn"],
                                 layernorm(bp["norm_x"], x), enc_out, cfg)
    x = x + h
    return x + mlp.apply(bp["mlp"], layernorm(bp["norm2"], x))


def forward_train(params, frames, tokens, cfg, *, remat: bool = True):
    """-> (logits (B, S, Vp), aux = 0). frames (B, T_enc, d); tokens (B,
    S) int. A mesh of several ranks raises `ValueError`
    (`transformer.check_distributable`)."""
    check_distributable(cfg, current_mesh())
    enc_out = encode(params, frames, cfg, remat)
    B, S = tokens.shape
    x = params["embed"][tokens]
    x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)
    pos = _zero_pos(B, S, x.device)
    for bp in params["dec_layers"]:
        x = (checkpoint(_dec_block_train, bp, x, enc_out, cfg, pos,
                        use_reentrant=False) if remat
             else _dec_block_train(bp, x, enc_out, cfg, pos))
    x = layernorm(params["final_norm"], x)
    return x @ params["embed"].T, torch.zeros((), dtype=torch.float32,
                                              device=x.device)


# -- decoder: serving ---------------------------------------------------------

def enc_cache_len(cfg) -> int:
    """Cross-cache slots: the encoder length rounded up to 8."""
    return -(-cfg.encoder_seq // 8) * 8


def init_decode_state(cfg, batch: int, max_len: int, *,
                      device="cuda") -> dict:
    """One decoder layer each: a self-attention cache (the config's
    granularity, ``max_len`` slots) and a per-channel cross-attention
    cache of `enc_cache_len` slots."""
    device = check_device(device)
    cross_q = dataclasses.replace(cfg.quant, granularity="per_channel")
    return {"self": [QuantizedKVCache.init(
                batch, cfg.n_kv_heads, max_len, cfg.head_dim, cfg.quant,
                device=device) for _ in range(cfg.n_layers)],
            "cross": [QuantizedKVCache.init(
                batch, cfg.n_kv_heads, enc_cache_len(cfg), cfg.head_dim,
                cross_q, device=device) for _ in range(cfg.n_layers)]}


def _pad_t(x: torch.Tensor, target: int) -> torch.Tensor:
    pad = target - x.shape[2]
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def prefill(params, frames, tokens, cfg, state):
    """Encode the frames, run the prompt through the decoder and fill both
    caches. tokens (B, S) with S a block multiple under per-block caches.
    Returns (logits of the last position (B, Vp), state)."""
    enc_out = encode(params, frames, cfg)
    B, S = tokens.shape
    x = params["embed"][tokens]
    x = x + _sinusoid(S, cfg.d_model, x.device).to(x.dtype)
    pos = _zero_pos(B, S, x.device)
    for bp, self_c, cross_c in zip(params["dec_layers"], state["self"],
                                   state["cross"]):
        h, _ = attention.prefill(bp["self_attn"], layernorm(bp["norm1"], x),
                                 cfg, pos, self_c)
        x = x + h
        h, (ck, cv) = attention.cross_train(
            bp["cross_attn"], layernorm(bp["norm_x"], x), enc_out, cfg)
        cross_c.prefill(_pad_t(ck.float(), cross_c.max_len),
                        _pad_t(cv.float(), cross_c.max_len))
        cross_c.length = ck.shape[2]            # masks the padding
        x = x + h
        x = x + mlp.apply(bp["mlp"], layernorm(bp["norm2"], x))
    x = layernorm(params["final_norm"], x[:, -1])
    return x @ params["embed"].T, state


def decode_step(params, token, cfg, state, pos_b):
    """token (B, 1), pos_b (B,) absolute positions -> (logits (B, Vp)
    float32, state)."""
    B = token.shape[0]
    x = params["embed"][token] + sinusoid_rows(pos_b, cfg.d_model)[:, None]
    pos = _zero_pos(B, 1, x.device)
    for bp, self_c, cross_c in zip(params["dec_layers"], state["self"],
                                   state["cross"]):
        bp = _f32(bp)
        h, _ = attention.decode(bp["self_attn"], layernorm(bp["norm1"], x),
                                cfg, pos, self_c)
        x = x + h
        x = x + attention.cross_decode(bp["cross_attn"],
                                       layernorm(bp["norm_x"], x), cfg,
                                       cross_c)
        x = x + mlp.apply(bp["mlp"], layernorm(bp["norm2"], x))
    x = layernorm(params["final_norm"], x[:, -1])
    return x @ params["embed"].float().T, state
