"""The paper's quantize/dequantize kernel family: the CUDA kernels'
launchers and their plain PyTorch versions.

Port of ``repro.kernels.quantize`` (paper Alg. 1 and Eq. 5-8), extended
from one (T, D) matrix to leading batch dimensions (..., T, D), so one
launch quantizes every (row, kv head) matrix of a cache at once:

  quantize_per_channel  two passes, as the Pallas pair ``_absmax_kernel``
                        + ``_quantize_with_scales_kernel``: the column
                        absmax over T, then s = max(absmax, 1e-30) / 127
                        and q = clip(round(x / max(s, 1e-30)), +-127)
  quantize_blocked      ``_quantize_blocked_kernel``: per (token block,
                        channel) absmax and quantize in one kernel,
                        s = max(absmax, 1e-30) / 127, q = clip(round(x / s))
  dequantize            ``_dequantize_kernel``: q * s per scale row, to
                        float32 or bfloat16

The per-channel pair clamps ``s`` to 1e-30 before dividing, as the Pallas
kernel does; ``core.quantization.quantize`` does not. The two differ only
for a channel whose absmax lies below 127e-30.

The scale's ``/ 127`` is a multiplication by float32(1/127), as the
reference computes it wherever it is compiled (its Pallas kernels in
interpret mode and every jitted serving path: XLA rewrites a division by
a constant so; the reference's eager `core.quantization` divides, which
differs by one ulp in some channels). Values are then divided by the
scale (IEEE division, never a reciprocal), rounded half to even and
clipped, so the kernels equal the plain versions bit for bit. The plain
versions divide by tensors, never by Python scalars: on a CUDA tensor
PyTorch turns a division by a scalar into a multiplication by its
reciprocal.

The CUDA kernels (``csrc/quantize.cu``) run on CUDA tensors; the plain
versions are what a CPU tensor gets, and what the kernels are held
against.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_attention import _check

QMAX = 127.0
_EPS = 1e-30
# float32(1) / float32(127), exactly representable as a Python float
INV_QMAX = float(torch.tensor(1.0) / torch.tensor(QMAX))


def _scales(absmax: torch.Tensor) -> torch.Tensor:
    """s = max(absmax, 1e-30) * float32(1/127)."""
    return torch.clamp_min(absmax, _EPS) * INV_QMAX


def _scale_rows(x_q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Scales as (..., nb, D): a (..., D) per-channel row gains its axis."""
    return scales.unsqueeze(-2) if scales.ndim == x_q.ndim - 1 else scales


# -- plain versions -----------------------------------------------------------

def absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Column absmax over T: (..., T, D) -> float32 (..., D)."""
    return torch.amax(torch.abs(x.float()), dim=-2)


def quantize_with_scales_plain(x: torch.Tensor, absmax: torch.Tensor):
    """Per-channel pass 2: (..., T, D) and its column absmax (..., D) ->
    (int8 (..., T, D), float32 scales (..., D))."""
    scales = _scales(absmax)
    s = torch.clamp_min(scales, _EPS).unsqueeze(-2)
    q = torch.clamp(torch.round(x.float() / s), -QMAX, QMAX).to(torch.int8)
    return q, scales


def quantize_per_channel_plain(x: torch.Tensor):
    """(..., T, D) -> (int8 (..., T, D), float32 scales (..., D))."""
    return quantize_with_scales_plain(x, absmax_plain(x))


def quantize_blocked_plain(x: torch.Tensor, block_size: int):
    """(..., T, D), T % block_size == 0 -> (int8 (..., T, D), float32
    scales (..., T // block_size, D))."""
    *lead, T, D = x.shape
    if T % block_size:
        raise ValueError(f"T={T} not a multiple of block_size={block_size}")
    xb = x.float().reshape(*lead, T // block_size, block_size, D)
    scales = _scales(torch.amax(torch.abs(xb), dim=-2))
    q = torch.clamp(torch.round(xb / scales.unsqueeze(-2)), -QMAX, QMAX)
    return q.to(torch.int8).reshape(*lead, T, D), scales


def dequantize_plain(x_q: torch.Tensor, scales: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 (..., T, D) x float32 scales (..., nb, D) (or (..., D): one
    row) -> (..., T, D) ``out_dtype``; row t takes scale row t // (T/nb)."""
    *lead, T, D = x_q.shape
    s = _scale_rows(x_q, scales)
    nb = s.shape[-2]
    xb = x_q.reshape(*lead, nb, T // nb, D).float()
    return (xb * s.float().unsqueeze(-2)).reshape(*lead, T, D).to(out_dtype)


# -- CUDA launchers -----------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _matrices(x: torch.Tensor):
    """(N, T, D) of a (..., T, D) tensor, with the shape rules of the
    kernels: D a multiple of 4 (16-byte rows of 4 floats)."""
    *lead, T, D = x.shape
    N = math.prod(lead)
    if D % 4 or not 0 < N <= 65535 or T < 1:
        raise ValueError(f"quantize kernels take (..., T, D) with D % 4 == 0 "
                         f"and 1..65535 matrices (got shape {tuple(x.shape)})")
    return lead, N, T, D


def _raise_on(rc: int, what: str):
    if rc:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Column absmax over T of float32 (..., T, D) -> (..., D). Counts
    each launch in ``absmax_cuda.launches``."""
    lead, N, T, D = _matrices(x)
    _check(x, "x", torch.float32)
    fn = _build.load("quantize", "absmax_cols", [_P, _P, _I, _I, _I, _P])
    out = torch.zeros((*lead, D), dtype=torch.float32, device=x.device)
    _raise_on(fn(x.data_ptr(), out.data_ptr(), N, T, D, _stream(x)),
              "absmax")
    absmax_cuda.launches += 1
    return out


def quantize_with_scales_cuda(x: torch.Tensor, absmax: torch.Tensor):
    """Second pass of the per-channel quantize: float32 (..., T, D) and
    its column absmax (..., D) -> (int8 (..., T, D), float32 scales
    (..., D)). Counts each launch in ``quantize_with_scales_cuda.
    launches``."""
    lead, N, T, D = _matrices(x)
    _check(x, "x", torch.float32)
    _check(absmax, "absmax", torch.float32, (*lead, D))
    fn = _build.load("quantize", "quantize_with_scales",
                     [_P, _P, _P, _P, _I, _I, _I, _P])
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*lead, D), dtype=torch.float32, device=x.device)
    _raise_on(fn(x.data_ptr(), absmax.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), N, T, D, _stream(x)),
              "quantize-with-scales")
    quantize_with_scales_cuda.launches += 1
    return q, scales


def quantize_per_channel_cuda(x: torch.Tensor):
    """Both per-channel passes on the card (same contract as
    `quantize_per_channel_plain`; x must be float32)."""
    return quantize_with_scales_cuda(x, absmax_cuda(x))


def quantize_blocked_cuda(x: torch.Tensor, block_size: int):
    """Same contract as `quantize_blocked_plain`; x must be float32.
    Counts each launch in ``quantize_blocked_cuda.launches``."""
    lead, N, T, D = _matrices(x)
    if T % block_size:
        raise ValueError(f"T={T} not a multiple of block_size={block_size}")
    nb = T // block_size
    if nb > 65535:
        raise ValueError(f"{nb} token blocks: the kernel takes <= 65535")
    _check(x, "x", torch.float32)
    fn = _build.load("quantize", "quantize_blocked",
                     [_P, _P, _P, _I, _I, _I, _I, _P])
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*lead, nb, D), dtype=torch.float32,
                         device=x.device)
    _raise_on(fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), N, T, D,
                 block_size, _stream(x)), "quantize-blocked")
    quantize_blocked_cuda.launches += 1
    return q, scales


def dequantize_cuda(x_q: torch.Tensor, scales: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Same contract as `dequantize_plain`; ``out_dtype`` float32 or
    bfloat16. Counts each launch in ``dequantize_cuda.launches``."""
    lead, N, T, D = _matrices(x_q)
    s = _scale_rows(x_q, scales)
    nb = s.shape[-2]
    if T % nb:
        raise ValueError(f"{nb} scale rows do not divide T={T}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dequantize kernel writes float32 or bfloat16, "
                         f"not {out_dtype}")
    _check(x_q, "x_q", torch.int8)
    _check(s, "scales", torch.float32, (*lead, nb, D))
    fn = _build.load("quantize", "dequantize",
                     [_P, _P, _P, _I, _I, _I, _I, _I, _P])
    out = torch.empty(x_q.shape, dtype=out_dtype, device=x_q.device)
    _raise_on(fn(x_q.data_ptr(), s.data_ptr(), out.data_ptr(), N, T, D, nb,
                 int(out_dtype == torch.bfloat16), _stream(x_q)),
              "dequantize")
    dequantize_cuda.launches += 1
    return out


absmax_cuda.launches = 0
quantize_with_scales_cuda.launches = 0
quantize_blocked_cuda.launches = 0
dequantize_cuda.launches = 0
