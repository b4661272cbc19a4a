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
                        channel) absmax and quantize in one kernel that
                        reads each element once (a block holds a token
                        block's column slab in registers),
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
reciprocal. A channel (per block: a block's channel) that holds a NaN has
a NaN scale, one that holds an inf an inf scale, and every int8 value of
either is 0, as in the reference; the kernels give the same.

The CUDA kernels (``csrc/quantize.cu``) run on CUDA tensors; the plain
versions are what a CPU tensor gets, and what the kernels are held
against.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_attention import (_check, _check_aligned,
                                                 _sm_count)

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


# the per-channel pair's block shape (csrc/quantize.cu: kThreads, kRegRows)
PC_THREADS = 256
PC_BATCH = 8         # rows whose loads a thread issues before it uses one
PC_BLOCKS_PER_SM = 2
# most blocks that split one absmax slab's T: one thread block cluster
# (csrc/quantize.cu: kMaxCluster; past 8, a size Hopper allows on request)
PC_CLUSTER = 16
ABSMAX_BLOCKS_PER_SM = 4   # the absmax grid: about one wave of the card
# quantize pass: rows a thread (most, least), more while the grid fills
# the card
QUANT_ROWS = (2, 1)


def chunk_rows(T: int, splits: int, lanes: int) -> int:
    """Rows a chunk of the per-channel kernels: T over ``splits``, rounded
    up to whole sweeps of PC_THREADS / lanes rows (csrc: chunk_rows)."""
    rs, rows = PC_THREADS // lanes, -(-T // splits)
    return -(-rows // rs) * rs


def _chunks(N: int, T: int, D: int, lanes: int, cols: int, rows: tuple,
            sms: int) -> int:
    """Chunks of T for slabs of ``cols`` columns, PC_THREADS / lanes rows a
    sweep: rows[0] rows a thread, halved (not below rows[1]) while the grid
    gives fewer than PC_BLOCKS_PER_SM blocks an SM."""
    rs, (per, least) = PC_THREADS // lanes, rows
    slabs = -(-D // cols) * N
    while per > least and slabs * -(-T // (rs * per)) < \
            PC_BLOCKS_PER_SM * sms:
        per //= 2
    return -(-T // chunk_rows(T, -(-T // (rs * per)), lanes))


def absmax_plan(N: int, T: int, D: int, sms: int) -> tuple[int, int]:
    """(lanes, chunks) of the absmax: a block owns a slab of 4 x lanes
    columns of one chunk of T (`chunk_rows` rows), and a slab's chunks are
    one thread block cluster (at most PC_CLUSTER). 8 lanes (128-byte rows;
    narrower where D is), 4 where even PC_CLUSTER chunks a slab would give
    under PC_BLOCKS_PER_SM blocks an SM; then as many chunks as make about
    ABSMAX_BLOCKS_PER_SM blocks an SM, a sweep of rows or more each. At
    (32, 1000 or 2048, 128) on 132 SMs: 8 lanes, 4 chunks (512 blocks); at
    131072 x 8192, 2 chunks. From shapes and the SM count only."""
    lanes = 8
    while lanes > 1 and 4 * (lanes // 2) >= D:
        lanes //= 2
    slabs = lambda n: -(-D // (4 * n)) * N
    if lanes == 8 and slabs(8) * PC_CLUSTER < PC_BLOCKS_PER_SM * sms:
        lanes = 4
    chunks = min(PC_CLUSTER,
                 max(1, ABSMAX_BLOCKS_PER_SM * sms // slabs(lanes)),
                 -(-T // (PC_THREADS // lanes)))
    return lanes, -(-T // chunk_rows(T, chunks, lanes))


def quantize_plan(N: int, T: int, D: int, sms: int) -> tuple[int, int, int]:
    """(lanes, vec, chunks) of the quantize pass: a thread owns 4 x vec
    consecutive columns of a row (vec 2 where D allows: one 8-byte store),
    a slab of 4 x vec x lanes columns as wide as D needs (at most 32
    lanes), QUANT_ROWS rows a thread (`_chunks`). At (32, 2048, 128) on
    132 SMs: 16 lanes, vec 2, 64 chunks (2048 blocks)."""
    vec = 2 if D % 8 == 0 else 1
    lanes = 32
    while lanes > 1 and 4 * vec * (lanes // 2) >= D:
        lanes //= 2
    return lanes, vec, _chunks(N, T, D, lanes, 4 * vec * lanes, QUANT_ROWS,
                               sms)


def absmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Column absmax over T of float32 (..., T, D) -> (..., D), one launch
    on the grid of `absmax_plan`: the blocks that split a slab's T are one
    thread block cluster, folded through shared memory. Counts each launch
    in ``absmax_cuda.launches``."""
    lead, N, T, D = _matrices(x)
    _check(x, "x", torch.float32)
    _check_aligned(x=x)
    fn = _build.load("quantize", "absmax_cols",
                     [_P, _P, _I, _I, _I, _I, _I, _P])
    lanes, splits = absmax_plan(N, T, D, _sm_count(x.device))
    out = torch.empty((*lead, D), dtype=torch.float32, device=x.device)
    _raise_on(fn(x.data_ptr(), out.data_ptr(), N, T, D, lanes, splits,
                 _stream(x)), "absmax")
    absmax_cuda.launches += 1
    return out


def quantize_with_scales_cuda(x: torch.Tensor, absmax: torch.Tensor):
    """Second pass of the per-channel quantize: float32 (..., T, D) and
    its column absmax (..., D) -> (int8 (..., T, D), float32 scales
    (..., D)), on the grid of `quantize_plan`. Counts each launch in
    ``quantize_with_scales_cuda.launches``."""
    lead, N, T, D = _matrices(x)
    _check(x, "x", torch.float32)
    _check(absmax, "absmax", torch.float32, (*lead, D))
    _check_aligned(x=x, absmax=absmax)
    fn = _build.load("quantize", "quantize_with_scales",
                     [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
    lanes, vec, splits = quantize_plan(N, T, D, _sm_count(x.device))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*lead, D), dtype=torch.float32, device=x.device)
    _raise_on(fn(x.data_ptr(), absmax.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), N, T, D, lanes, vec, splits, _stream(x)),
              "quantize-with-scales")
    quantize_with_scales_cuda.launches += 1
    return q, scales


def quantize_per_channel_cuda(x: torch.Tensor):
    """Both per-channel passes on the card (same contract as
    `quantize_per_channel_plain`; x must be float32)."""
    return quantize_with_scales_cuda(x, absmax_cuda(x))


# the blocked kernel's kThreads and kRegRows (csrc/quantize.cu)
BLOCKED_THREADS = 256  # threads a block
BLOCKED_SWEEPS = 8     # row sweeps a thread holds in registers


def blocked_lanes(N: int, T: int, D: int, block_size: int, sms: int) -> int:
    """16-byte lanes a row in the blocked kernel: a block owns a slab of
    4 x lanes columns of one token block, BLOCKED_THREADS / lanes rows a
    sweep. As wide as D needs (at most 32: 128 columns), narrowed until
    the block's rows fit in BLOCKED_SWEEPS sweeps, then, while the grid
    gives fewer than two blocks an SM, halved again (not below 4 lanes,
    64-byte rows, nor to a sweep taller than the token block). At block
    256 and D 128: 8 lanes; at a flush (N 32, T 256) on 132 SMs, 4. From
    shapes and the SM count only."""
    lanes = 32
    while lanes > 1 and 4 * (lanes // 2) >= D:
        lanes //= 2
    while lanes > 1 and -(-block_size * lanes // BLOCKED_THREADS) > \
            BLOCKED_SWEEPS:
        lanes //= 2
    blocks = lambda n: -(-D // (4 * n)) * (T // block_size) * N
    while lanes > 4 and BLOCKED_THREADS // (lanes // 2) <= block_size and \
            blocks(lanes) < 2 * sms:
        lanes //= 2
    return lanes


def quantize_blocked_cuda(x: torch.Tensor, block_size: int):
    """Same contract as `quantize_blocked_plain`; x must be float32; the
    kernel's slab width from `blocked_lanes`. Counts each launch in
    ``quantize_blocked_cuda.launches``."""
    lead, N, T, D = _matrices(x)
    if T % block_size:
        raise ValueError(f"T={T} not a multiple of block_size={block_size}")
    nb = T // block_size
    if nb > 65535:
        raise ValueError(f"{nb} token blocks: the kernel takes <= 65535")
    _check(x, "x", torch.float32)
    fn = _build.load("quantize", "quantize_blocked",
                     [_P, _P, _P, _I, _I, _I, _I, _I, _P])
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((*lead, nb, D), dtype=torch.float32,
                         device=x.device)
    _raise_on(fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), N, T, D,
                 block_size, blocked_lanes(N, T, D, block_size,
                                           _sm_count(x.device)), _stream(x)),
              "quantize-blocked")
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
