"""Shared model components: RMSNorm, LayerNorm, RoPE, M-RoPE and init
helpers (port of ``repro.models.common``).

Parameters are nested dicts of tensors and layers are plain functions, as
in the reference; initialization draws from an explicit `torch.Generator`
with the reference's distributions (the numbers differ from JAX's: tests
bridge the reference's weights instead, see `repro_torch.checkpoint`).
"""
from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, 1) / sqrt(in_dim), drawn in float32, stored as ``dtype``."""
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def rmsnorm_init(dim: int, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)


def layernorm_init(dim: int, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """float32 LayerNorm with the population variance, as the reference's
    ``jnp.var``."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """1 / theta^(2i / D) in float32. The power is taken in float64 and
    rounded once: the reference's float32 power is correctly rounded
    (torch's float32 power is an ulp off in a few channels, e.g. at theta
    1e6 and D 128)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (B, H, T, D); positions (B, T) int32."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)
    ang = positions[:, None, :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...],
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the D/2 frequency channels split into
    (temporal, height, width) sections, each rotated by its own row of
    positions. x (B, H, T, D); positions (B, 3, T) int; ``sections`` sum
    to D/2. The angle is the position times the frequency, one float32
    product a channel, as the reference's ``einsum("bft,f->btf")``; with
    the three rows equal (text) it is `apply_rope` bit for bit."""
    B, _, T, D = x.shape
    if sum(sections) != D // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to "
                         f"head_dim / 2 = {D // 2}")
    freqs = rope_freqs(D, theta, x.device)                      # (D/2,)
    # each channel's position row, by its section (views and one cat: no
    # host data, so a captured step replays it)
    p32 = positions.float()
    pos = torch.cat([p32[:, i:i + 1].expand(B, n, T)
                     for i, n in enumerate(sections)], dim=1)   # (B, D/2, T)
    ang = (pos.transpose(1, 2) * freqs)[:, None]                # (B,1,T,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, 3, T): text-only M-RoPE positions (all sections
    equal)."""
    return positions[:, None, :].expand(positions.shape[0], 3,
                                        positions.shape[1])
