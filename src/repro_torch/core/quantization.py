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

A per-layer precision plan (`PrecisionPlan`, `resolve_kv_dtype_spec`,
`layer_kv_dtypes`) assigns one of those formats to each layer; a plan
whose layers all agree collapses to that dtype string.
"""
from __future__ import annotations

import dataclasses
import json
import os
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

    @property
    def compression_ratio(self) -> float:
        """Bytes of the unquantized reference over bytes of the stored
        element (scale rows ignored: D floats against T * D elements)."""
        return _itemsize(self.ref_dtype) / _itemsize(self.cache_dtype)


def _itemsize(dtype) -> int:
    """Bytes per element of a dtype given by name ("bfloat16",
    "float8_e4m3fn", ...) or as a `torch.dtype`."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


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
# Error metrics: the paper's evaluation quantities (paper §7.2, §7.3)
# ---------------------------------------------------------------------------

def l2_error(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """||x - x_hat||_2 over every element (grows with the matrix size)."""
    d = x.float() - x_hat.float()
    return torch.sqrt(torch.sum(d * d))


def max_abs_error(x: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """max |x - x_hat|; bounded by s/2 per element (paper Eq. 9)."""
    return torch.amax(torch.abs(x.float() - x_hat.float()))


def attention_score_error(q: torch.Tensor, k: torch.Tensor,
                          k_hat: torch.Tensor) -> torch.Tensor:
    """Mean |q.k - q.k_hat| over all (query, key) pairs, scaled by
    1/sqrt(D) like attention logits."""
    d = q.shape[-1]
    s = torch.einsum("...qd,...kd->...qk", q.float(),
                     (k.float() - k_hat.float())) / d ** 0.5
    return torch.mean(torch.abs(s))


def attention_score_error_raw(q: torch.Tensor, k: torch.Tensor,
                              k_hat: torch.Tensor) -> torch.Tensor:
    """The paper's §7.3 convention: the raw dot-product error, no
    1/sqrt(D)."""
    s = torch.einsum("...qd,...kd->...qk", q.float(),
                     (k.float() - k_hat.float()))
    return torch.mean(torch.abs(s))


def theoretical_max_error(scales: torch.Tensor) -> torch.Tensor:
    """Eq. 9: the max error is at most s/2 (largest scale)."""
    return torch.amax(scales) / 2.0


# ---------------------------------------------------------------------------
# FP8 and packed INT4
# ---------------------------------------------------------------------------

def quantize_fp8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel-scaled FP8 (e4m3): s_d = max|x|/448, store x/s."""
    scales = torch.clamp_min(torch.amax(torch.abs(x.float()), dim=-2),
                             _EPS) / FP8_MAX
    q = (x.float() / scales[..., None, :]).to(torch.float8_e4m3fn)
    return q, scales


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize_fp8`: x_hat = float32(q) * s."""
    return (q.float() * scales[..., None, :].float()).to(dtype)


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


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of `quantize_int4`: 2 * (packed tokens) tokens, an odd
    count's zero pad token included (it dequantizes to 0.0)."""
    q = unpack_int4(packed)
    return (q.float() * scales[..., None, :].float()).to(dtype)


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


# ---------------------------------------------------------------------------
# Per-layer precision plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """One KV storage format (of ``KV_DTYPES``) per transformer layer:
    ``layer_dtypes[l]`` for layer l. ``ppl_budget_pct`` and
    ``measured_delta_pct`` carry the perplexity budget the plan was chosen
    under and the full mixed stack's measured delta, as the profiler that
    wrote it recorded them."""

    layer_dtypes: tuple[str, ...]
    ppl_budget_pct: float | None = None
    measured_delta_pct: float | None = None

    def __post_init__(self):
        dts = tuple(self.layer_dtypes)
        if not dts:
            raise QuantizationError("PrecisionPlan needs at least one layer")
        for i, dt in enumerate(dts):
            if dt not in KV_DTYPES:
                raise QuantizationError(
                    f"PrecisionPlan layer {i}: unknown kv dtype {dt!r}; "
                    f"expected one of {KV_DTYPES}")
        object.__setattr__(self, "layer_dtypes", dts)

    @property
    def n_layers(self) -> int:
        return len(self.layer_dtypes)

    @property
    def is_uniform(self) -> bool:
        """True when every layer has the same dtype (the plan is then that
        dtype string)."""
        return len(set(self.layer_dtypes)) == 1

    @classmethod
    def from_json(cls, obj: dict) -> "PrecisionPlan":
        """A plan from its JSON dict: the profiler's schema
        ``{"layers": [{"layer": 0, "kv_dtype": "int4", ...}, ...]}`` or
        the compact ``{"layer_dtypes": ["int8", "int4", ...]}``."""
        if not isinstance(obj, dict):
            raise QuantizationError(
                f"precision plan must be a dict, got {type(obj).__name__}")
        if "layer_dtypes" in obj:
            dts = tuple(obj["layer_dtypes"])
        elif "layers" in obj:
            rows = sorted(obj["layers"], key=lambda r: int(r["layer"]))
            want = list(range(len(rows)))
            got = [int(r["layer"]) for r in rows]
            if got != want:
                raise QuantizationError(
                    f"precision plan layers must be 0..{len(rows) - 1} "
                    f"exactly once, got {got}")
            dts = tuple(r["kv_dtype"] for r in rows)
        else:
            raise QuantizationError(
                "precision plan dict needs a 'layers' or 'layer_dtypes' key")
        return cls(layer_dtypes=dts,
                   ppl_budget_pct=obj.get("ppl_budget_pct"),
                   measured_delta_pct=obj.get("measured_delta_pct"))

    @classmethod
    def load(cls, path: str) -> "PrecisionPlan":
        """Read a plan JSON file (`from_json`'s schemas)."""
        if not os.path.exists(path):
            raise QuantizationError(f"precision plan file not found: {path!r}")
        with open(path) as f:
            return cls.from_json(json.load(f))

    def to_json(self) -> dict:
        """The canonical plan JSON (round-trips through `from_json`)."""
        out: dict = {
            "version": 1,
            "kind": "kv_precision_plan",
            "layers": [{"layer": i, "kv_dtype": dt}
                       for i, dt in enumerate(self.layer_dtypes)],
        }
        if self.ppl_budget_pct is not None:
            out["ppl_budget_pct"] = self.ppl_budget_pct
        if self.measured_delta_pct is not None:
            out["measured_delta_pct"] = self.measured_delta_pct
        return out


def resolve_kv_dtype_spec(spec, n_layers: int | None = None):
    """Normalize a ``kv_cache_dtype`` spec: a dtype string of
    ``KV_DTYPES``, a `PrecisionPlan`, a plan dict, a path to a plan JSON or
    a per-layer sequence of dtype strings. Returns a dtype string when
    every layer agrees (so an all-int8 plan is the default engine) and
    otherwise the tuple of per-layer dtypes. With ``n_layers`` the plan
    must cover exactly that many layers."""
    if isinstance(spec, str):
        if spec in KV_DTYPES:
            return spec
        if spec.endswith(".json") or os.sep in spec:
            spec = PrecisionPlan.load(spec)
        else:
            raise QuantizationError(
                f"unknown kv_cache_dtype {spec!r}; expected one of "
                f"{KV_DTYPES}, a PrecisionPlan, a plan dict, or a path to a "
                f"plan JSON (benchmarks/sensitivity.py emits one)")
    if isinstance(spec, dict):
        spec = PrecisionPlan.from_json(spec)
    if isinstance(spec, (list, tuple)):
        spec = PrecisionPlan(layer_dtypes=tuple(spec))
    if not isinstance(spec, PrecisionPlan):
        raise QuantizationError(
            f"cannot interpret kv_cache_dtype spec of type "
            f"{type(spec).__name__}; expected one of {KV_DTYPES}, a "
            f"PrecisionPlan, a plan dict, a per-layer sequence, or a plan "
            f"JSON path")
    if n_layers is not None and spec.n_layers != n_layers:
        raise QuantizationError(
            f"precision plan covers {spec.n_layers} layers but the model "
            f"has {n_layers}")
    if spec.is_uniform:
        return spec.layer_dtypes[0]
    return spec.layer_dtypes


def layer_kv_dtypes(spec, n_layers: int) -> tuple[str, ...]:
    """One dtype per layer for any spec `resolve_kv_dtype_spec` takes (a
    bare dtype string repeats over ``n_layers``; a plan must cover them
    exactly)."""
    resolved = resolve_kv_dtype_spec(spec, n_layers=None if isinstance(
        spec, str) and spec in KV_DTYPES else n_layers)
    if isinstance(resolved, str):
        return (resolved,) * n_layers
    return resolved
