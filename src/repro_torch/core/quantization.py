"""Per-channel / per-block symmetric quantization — the page subset of
``repro.core.quantization``, in PyTorch.

The arithmetic repeats the reference step for step so page bytes match
bitwise: scales are ``max(absmax, EPS) / qmax`` in float32, values are
DIVIDED by the scale (never multiplied by a reciprocal), rounded half to
even (``torch.round``), then clipped. The channel axis is always the LAST
axis, the token axis the SECOND-TO-LAST.

Page formats (``KV_DTYPES``): int8 (qmax 127), fp8_e4m3 (qmax 448, stored
as ``torch.float8_e4m3fn``) and int4 (qmax 7, two tokens per byte: token
2i in the low nibble of byte i, token 2i+1 in the high nibble).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

QMAX = 127.0   # symmetric INT8 range [-127, 127]; -128 never emitted
_EPS = 1e-30   # guards all-zero channels against a divide by zero

KV_DTYPES = ("int8", "fp8_e4m3", "int4")
KV_QMAX = {"int8": QMAX, "fp8_e4m3": 448.0, "int4": 7.0}
FP8_MAX = 448.0


class QuantizationError(ValueError):
    """A quantizer was handed a shape/dtype it cannot represent."""


def kv_storage_dtype(kv_dtype: str) -> torch.dtype:
    """The tensor dtype a pool stores pages of ``kv_dtype`` in."""
    if kv_dtype == "fp8_e4m3":
        return torch.float8_e4m3fn
    if kv_dtype in ("int8", "int4"):
        return torch.int8
    raise QuantizationError(f"unknown kv_cache_dtype {kv_dtype!r}; "
                            f"expected one of {KV_DTYPES}")


def packed_tokens(n_tokens: int, kv_dtype: str) -> int:
    """Storage rows along the token axis for ``n_tokens`` logical tokens
    (int4 packs two per byte; everything else is 1:1)."""
    if kv_dtype == "int4":
        if n_tokens % 2 != 0:
            raise QuantizationError(
                f"int4 page layout needs an even token count, got {n_tokens}")
        return n_tokens // 2
    kv_storage_dtype(kv_dtype)
    return n_tokens


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """KV-cache quantization settings (field names as the reference's).
    Dtypes are names: ``cache_dtype`` the stored element, ``scale_dtype``
    the scale rows, ``ref_dtype`` the dtype of the unquantized residual
    page (bf16 even in a float32 model)."""

    granularity: Literal["per_channel", "per_block"] = "per_channel"
    block_size: int = 256
    cache_dtype: str = "int8"
    scale_dtype: str = "float32"
    ref_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.granularity == "per_block" and self.block_size % 8 != 0:
            raise ValueError(f"block_size must be a multiple of 8, "
                             f"got {self.block_size}")


# ---------------------------------------------------------------------------
# Per-channel quantization (paper Eq. 5-8)
# ---------------------------------------------------------------------------

def compute_scales(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """s_d = max_t |x[..., t, d]| / 127 over ``axis``; float32."""
    max_abs = torch.amax(torch.abs(x.float()), dim=axis)
    return torch.clamp_min(max_abs, _EPS) / QMAX


def quantize(x: torch.Tensor, scales: torch.Tensor, *,
             token_axis: int = -2) -> torch.Tensor:
    """Quantize to int8 with per-channel scales (paper Eq. 7)."""
    s = scales.unsqueeze(token_axis).float()
    q = torch.round(x.float() / s)
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def dequantize(x_q: torch.Tensor, scales: torch.Tensor, *,
               token_axis: int = -2,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x_hat = x_q * s (paper Eq. 8)."""
    s = scales.unsqueeze(token_axis).float()
    return (x_q.float() * s).to(dtype)


def quantize_matrix(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot per-channel quantization of a (..., T, D) matrix ->
    (int8 values, float32 scales (..., D))."""
    scales = compute_scales(x)
    return quantize(x, scales), scales


def quantize_blocked(x: torch.Tensor, block_size: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize (..., T, D) with one scale per (token-block, channel) ->
    (int8 (..., T, D), float32 scales (..., T // block_size, D))."""
    *lead, T, D = x.shape
    if T % block_size != 0:
        raise ValueError(f"T={T} not a multiple of block_size={block_size}")
    xb = x.reshape(*lead, T // block_size, block_size, D)
    scales = compute_scales(xb, axis=-2)
    return quantize(xb, scales).reshape(*lead, T, D), scales


def dequantize_blocked(x_q: torch.Tensor, scales: torch.Tensor, *,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    *lead, T, D = x_q.shape
    nb = scales.shape[-2]
    xb = x_q.reshape(*lead, nb, T // nb, D)
    return dequantize(xb, scales, dtype=dtype).reshape(*lead, T, D)


# ---------------------------------------------------------------------------
# FP8 and packed INT4
# ---------------------------------------------------------------------------

def quantize_fp8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel-scaled FP8 (e4m3): s_d = max|x|/448, store x/s."""
    scales = torch.clamp_min(torch.amax(torch.abs(x.float()), dim=-2),
                             _EPS) / FP8_MAX
    q = (x.float() / scales[..., None, :]).to(torch.float8_e4m3fn)
    return q, scales


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued int8 tokens two per byte along the token axis
    (token 2i -> low nibble of byte i, 2i+1 -> high nibble)."""
    T = q.shape[-2]
    if T % 2 != 0:
        raise QuantizationError(f"pack_int4 needs an even token count, "
                                f"got T={T}")
    lo = q[..., 0::2, :].to(torch.int32) & 0x0F
    hi = (q[..., 1::2, :].to(torch.int32) & 0x0F) << 4
    # the byte pattern is the point: 0..255 as uint8, reinterpreted as int8
    return (lo | hi).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_int4`: (..., T//2, D) bytes -> (..., T, D) int8,
    sign-extended by arithmetic shifts on the signed byte."""
    *lead, Th, D = packed.shape
    lo = (packed << 4) >> 4      # int8 `>>` is arithmetic: keeps the sign
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * Th, D)


def quantize_int4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric INT4 packed two per byte. An odd token count
    gets one zero pad token (scales come from the real tokens only)."""
    if x.ndim < 2:
        raise QuantizationError(f"quantize_int4 needs (..., T, D), got "
                                f"shape {tuple(x.shape)}")
    *lead, T, D = x.shape
    if T == 0:
        raise QuantizationError("quantize_int4 needs at least one token")
    scales = torch.clamp_min(torch.amax(torch.abs(x.float()), dim=-2),
                             _EPS) / 7.0
    q = torch.clamp(torch.round(x.float() / scales[..., None, :]),
                    -7, 7).to(torch.int8)
    if T % 2 != 0:
        q = torch.cat([q, q.new_zeros((*lead, 1, D))], dim=-2)
    return pack_int4(q), scales


# ---------------------------------------------------------------------------
# Dtype-generic page quantizers
# ---------------------------------------------------------------------------

def quantize_pages(x: torch.Tensor, block_size: int, kv_dtype: str = "int8"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize (..., T, D) with one scale row per (token-block, channel)
    into ``kv_dtype`` page storage -> (packed values, float32 scales
    (..., T // block_size, D)). The packed token axis is T, or T // 2 for
    int4."""
    if kv_dtype == "int8":
        return quantize_blocked(x, block_size)
    *lead, T, D = x.shape
    if T % block_size != 0:
        raise QuantizationError(
            f"T={T} not a multiple of block_size={block_size}")
    if kv_dtype not in KV_QMAX:
        raise QuantizationError(f"unknown kv_cache_dtype {kv_dtype!r}; "
                                f"expected one of {KV_DTYPES}")
    nb = T // block_size
    xb = x.reshape(*lead, nb, block_size, D).float()
    scales = torch.clamp_min(torch.amax(torch.abs(xb), dim=-2),
                             _EPS) / KV_QMAX[kv_dtype]
    if kv_dtype == "fp8_e4m3":
        q = (xb / scales[..., None, :]).to(torch.float8_e4m3fn)
        return q.reshape(*lead, T, D), scales
    packed_tokens(block_size, "int4")
    q = torch.clamp(torch.round(xb / scales[..., None, :]),
                    -7, 7).to(torch.int8)
    return pack_int4(q).reshape(*lead, T // 2, D), scales


def dequantize_pages(q: torch.Tensor, scales: torch.Tensor,
                     kv_dtype: str = "int8", *,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize_pages` (lossy for the values, exact layout)."""
    if kv_dtype == "int8":
        return dequantize_blocked(q, scales, dtype=dtype)
    kv_storage_dtype(kv_dtype)
    if kv_dtype == "int4":
        q = unpack_int4(q)
    *lead, T, D = q.shape
    nb = scales.shape[-2]
    xb = q.reshape(*lead, nb, T // nb, D).float()
    out = xb * scales[..., None, :].float()
    return out.reshape(*lead, T, D).to(dtype)


def quantize_page_matrix(x: torch.Tensor, kv_dtype: str = "int8"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel quantization of one full page (..., page_size, D) into
    ``kv_dtype`` storage — the `append` flush path; scales (..., D)."""
    if kv_dtype == "int8":
        return quantize_matrix(x)
    if kv_dtype == "fp8_e4m3":
        return quantize_fp8(x)
    if kv_dtype == "int4":
        return quantize_int4(x)
    raise QuantizationError(f"unknown kv_cache_dtype {kv_dtype!r}; "
                            f"expected one of {KV_DTYPES}")
