"""The port's CUDA kernels on the card (``gpu`` marker): each kernel against
its plain PyTorch version on the same CUDA tensors — the paged kernels for
int8, fp8_e4m3 and int4 pages (paged decode also at batches that give
one, two, four and eight splits of the page walk; paged prefill also at
chunks of 512 and 1024 with row tiles past `valid`, which must come out
0.0), the flat decode kernel and the seed baseline per block and per
channel (ring windows included; both also at batches 2 to 40, from
16 splits of their slot walk to one, window 0 and T 1032),
the flash forward (float32 on the CUDA cores and bfloat16 on the tensor
cores; causal, windowed, offset, ragged, GQA groups of 1 to 8), the
quantize/dequantize family — at the smoke shapes and at internlm2_1_8b's
widths (the blocked kernel's slabs also at a flush, at blocks of 24
and 8 and at D 16 to 8192); the smoke engines' greedy tokens on the card
against the CPU (paged and contiguous, and `greedy_generate`); and the
smoke train step's loss on the card against the CPU. Skipped where there is no card; imports
no JAX (the card's machine has none).

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: attention in float32, |a - b| <= 1e-5 + 1e-4 |b| — the kernel
sums in another order than the plain version (tile-wise online softmax);
the flash forward's output on bfloat16 inputs within one bf16 ulp, 2^-8
(1 + |b|), against the plain version walked in the kernel's 64-key tiles
(a probability may round to bf16 one ulp apart; m and l as in float32);
the quantize family bitwise; the train
step's loss within 1e-5 relative, its grad_norm 1e-4 (float32, cuBLAS
against the CPU's sums)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import flash_fwd as FF
from repro_torch.kernels import ops
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import quant_prefill as QP
from repro_torch.kernels import quantize as QK
from torch_parity import cuda_device  # noqa: F401  (fixture)

DTYPES = ["int8", "fp8_e4m3", "int4"]
TOL = dict(atol=1e-5, rtol=1e-4)
# (H, H_kv, D, page) — the smoke config's widths and the full model's
WIDTHS = [(4, 2, 16, 8), (16, 8, 128, 256)]


def _pool(kv_dtype, n_pages, Hkv, D, ps, gen, dev):
    x = torch.randn((2, Hkv, n_pages * ps, D), generator=gen, device=dev)
    q, s = Q.quantize_pages(x, ps, kv_dtype)
    pages = q.reshape(2, Hkv, n_pages, -1, D).permute(0, 2, 3, 1, 4)
    scales = s.permute(0, 2, 1, 3)
    return (pages[0].contiguous(), scales[0].contiguous(),
            pages[1].contiguous(), scales[1].contiguous())


def _table(B, NT, n_pages, gen, dev):
    perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
    return perm[:B * NT].reshape(B, NT).to(torch.int32).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_decode_kernel_matches_plain(kv_dtype, width, cuda_device):
    H, Hkv, D, ps = width
    NT = 8
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    lengths = torch.tensor([0, 1, ps - 1, ps, 3 * ps + 5, NT * ps],
                           dtype=torch.int32, device=cuda_device)
    B = len(lengths)
    pool = _pool(kv_dtype, B * NT + 1, Hkv, D, ps, gen, cuda_device)
    args = (torch.randn((B, H, D), generator=gen, device=cuda_device),
            *pool, _table(B, NT, B * NT + 1, gen, cuda_device), lengths,
            kv_dtype)
    before = QA.paged_decode_partials_cuda.launches
    got = ops.paged_attention_decode_partials(*args[:-1], kv_dtype=kv_dtype)
    torch.cuda.synchronize()
    assert QA.paged_decode_partials_cuda.launches == before + 1
    for g, w in zip(got, QA.paged_decode_partials_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("B", [2, 10, 20, 40])
def test_decode_kernel_split_walk_matches_plain(B, kv_dtype, cuda_device):
    """At internlm2_1_8b's widths the batch sets the split: on 132 SMs one
    page a split (B 2), two and four (B 10, 20: rows longer than a split),
    one split (B 40). Lengths leave most tables with pages past the live
    ones."""
    H, Hkv, D, ps = WIDTHS[1]
    NT = 8
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    cycle = [0, 1, ps - 1, ps, ps + 1, 3 * ps + 5, NT * ps, NT * ps - 1,
             2 * ps, 5 * ps + 100]
    lengths = torch.tensor([cycle[i % len(cycle)] for i in range(B)],
                           dtype=torch.int32, device=cuda_device)
    pool = _pool(kv_dtype, B * NT + 1, Hkv, D, ps, gen, cuda_device)
    args = (torch.randn((B, H, D), generator=gen, device=cuda_device),
            *pool, _table(B, NT, B * NT + 1, gen, cuda_device), lengths,
            kv_dtype)
    got = QA.paged_decode_partials_cuda(*args)
    torch.cuda.synchronize()
    want = QA.paged_decode_partials_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    empty = lengths == 0                    # exactly the plain version's
    assert float(got[0][empty].abs().max()) == 0.0
    assert float(got[2][empty].abs().max()) == 0.0
    assert bool((got[1][empty] == want[1][empty]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_prefill_kernel_matches_plain(kv_dtype, width, cuda_device):
    H, Hkv, D, ps = width
    G, NT, C = H // Hkv, 8, 4 * ps
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    hist = [0, ps, 3 * ps, NT * ps - C]
    valid = [C, 1, C - 1, C // 2 + 3]
    B = len(hist)
    pool = _pool(kv_dtype, B * NT + 1, Hkv, D, ps, gen, cuda_device)
    table = _table(B, NT, B * NT + 1, gen, cuda_device)
    q = torch.randn((B, H, C, D), generator=gen, device=cuda_device)
    k = torch.randn((B, Hkv, C, D), generator=gen, device=cuda_device)
    v = torch.randn((B, Hkv, C, D), generator=gen, device=cuda_device)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    for hb in (0, 1, 3, NT):
        before = QP.paged_prefill_cuda.launches
        got = ops.paged_attention_prefill(q, k, v, *pool, table, i32(hist),
                                          i32(valid), hist_blocks=hb,
                                          kv_dtype=kv_dtype)
        torch.cuda.synchronize()
        assert QP.paged_prefill_cuda.launches == before + 1
        qg = (q.reshape(B, Hkv, G * C, D) * QA.logit_scale(D)).contiguous()
        want = QP.paged_prefill_plain(qg, k, v, *pool, table, i32(hist),
                                      i32(valid), hb, kv_dtype)
        want = want.reshape(B, H, C, D)
        for b in range(B):                # positions past valid: garbage
            torch.testing.assert_close(got[b, :, :valid[b]],
                                       want[b, :, :valid[b]], **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_block", "per_channel"])
@pytest.mark.parametrize("width", WIDTHS)
def test_flat_decode_kernel_matches_plain(per_channel, width, cuda_device):
    H, Hkv, D, bs = width
    T = 4 * bs + 8 if per_channel else 8 * bs     # per channel: T % 64 != 0
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    lengths = i32([0, 1, bs - 1, 3 * bs + 5, T, T + bs + 3])
    windows = i32([T, T, T, 2 * bs, T, bs + 2])   # two rows windowed
    B = len(lengths)
    k = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    quant = (QK.quantize_per_channel_plain if per_channel
             else lambda x: QK.quantize_blocked_plain(x, bs))
    (kq, ks), (vq, vs) = quant(k), quant(v)
    if per_channel:
        ks, vs = ks[:, :, None].contiguous(), vs[:, :, None].contiguous()
    q = torch.randn((B, H, D), generator=gen, device=cuda_device)
    args = (q, kq, ks, vq, vs, lengths, windows)
    before = QA.flat_decode_partials_cuda.launches
    got = QA.flat_decode_partials_cuda(*args)
    torch.cuda.synchronize()
    assert QA.flat_decode_partials_cuda.launches == before + 1
    for g, w in zip(got, QA.flat_decode_partials_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)
    assert float(got[2][0].abs().max()) == 0.0            # empty row: l = 0
    # the seed baseline: the same partials, every tile walked
    before = QA.seed_decode_partials_cuda.launches
    got = ops.quant_attention_decode_partials_vmap(
        q, kq, ks, vq, vs, lengths, window=windows,
        block_t=bs if not per_channel else None)
    torch.cuda.synchronize()
    assert QA.seed_decode_partials_cuda.launches == before + 1
    for g, w in zip(got, QA.flat_decode_partials_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_block", "per_channel"])
@pytest.mark.parametrize("B", [2, 4, 10, 40])
def test_flat_decode_split_walk_matches_plain(B, per_channel, cuda_device):
    """At internlm2_1_8b's widths the batch sets the split
    (`flat_decode_splits`: 16 splits of 128 slots at B 2 down to one split
    at B 40), per block at T 2048 and per channel at the generate cache's
    T 1032; lengths leave most splits of a row dead, one row is a ring
    (past T, in a window), one has window 0."""
    H, Hkv, D, bs = WIDTHS[1]
    T = 1032 if per_channel else 2048
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    cycle = [(0, T), (1, T), (63, T), (64, T), (65, T), (T, T),
             (T + 300, 1024), (T, 0), (700, T), (T - 1, 500)]
    lengths = i32([cycle[i % len(cycle)][0] for i in range(B)])
    windows = i32([cycle[i % len(cycle)][1] for i in range(B)])
    k = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    quant = (QK.quantize_per_channel_plain if per_channel
             else lambda x: QK.quantize_blocked_plain(x, bs))
    (kq, ks), (vq, vs) = quant(k), quant(v)
    if per_channel:
        ks, vs = ks[:, :, None].contiguous(), vs[:, :, None].contiguous()
    args = (torch.randn((B, H, D), generator=gen, device=cuda_device), kq,
            ks, vq, vs, lengths, windows)
    got = QA.flat_decode_partials_cuda(*args)
    torch.cuda.synchronize()
    want = QA.flat_decode_partials_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    dead = (lengths == 0) | (windows == 0)        # exactly the plain's
    assert float(got[0][dead].abs().max()) == 0.0
    assert float(got[2][dead].abs().max()) == 0.0
    assert bool((got[1][dead] == want[1][dead]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_block", "per_channel"])
@pytest.mark.parametrize("B", [2, 4, 10, 40])
def test_seed_decode_split_walk_matches_plain(B, per_channel, cuda_device):
    """The seed baseline walks flat decode's splits (16 of 128 slots at B 2
    down to one at B 40) but copies and folds every slot of each, dead ones
    masked: lengths 0, 1, partial, full and a ring row, windows (one of
    0), per block at T 2048 and per channel at T 1032; a split wholly past
    a row's live slots must still add nothing."""
    H, Hkv, D, bs = WIDTHS[1]
    T = 1032 if per_channel else 2048
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    cycle = [(0, T), (1, T), (63, T), (T, T), (T + 300, 1024), (700, T),
             (T, 0), (65, 40), (T - 1, 500), (300, T)]
    lengths = i32([cycle[i % len(cycle)][0] for i in range(B)])
    windows = i32([cycle[i % len(cycle)][1] for i in range(B)])
    k = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    quant = (QK.quantize_per_channel_plain if per_channel
             else lambda x: QK.quantize_blocked_plain(x, bs))
    (kq, ks), (vq, vs) = quant(k), quant(v)
    if per_channel:
        ks, vs = ks[:, :, None].contiguous(), vs[:, :, None].contiguous()
    args = (torch.randn((B, H, D), generator=gen, device=cuda_device), kq,
            ks, vq, vs, lengths, windows)
    before = QA.seed_decode_partials_cuda.launches
    got = ops.quant_attention_decode_partials_vmap(*args[:6],
                                                   window=windows)
    torch.cuda.synchronize()
    assert QA.seed_decode_partials_cuda.launches == before + 1
    want = QA.flat_decode_partials_plain(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    dead = (lengths == 0) | (windows == 0)        # exactly the plain's
    assert float(got[0][dead].abs().max()) == 0.0
    assert float(got[2][dead].abs().max()) == 0.0
    assert bool((got[1][dead] == want[1][dead]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("C", [512, 1024])
def test_prefill_kernel_dead_tiles_match_plain(C, kv_dtype, cuda_device):
    """internlm2_1_8b's widths, chunks of 512 and 1024: every row below
    `valid` against the plain version, with and without history; every
    output finite; a 64-row tile whose positions are all at or past
    `valid` exactly 0.0."""
    H, Hkv, D, ps = WIDTHS[1]
    G, NT = H // Hkv, 8
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    hist = [0, 256, 1024, 1792]
    valid = [C, C // 2 - 1, 1, 64]
    B = len(hist)
    pool = _pool(kv_dtype, B * NT + 1, Hkv, D, ps, gen, cuda_device)
    table = _table(B, NT, B * NT + 1, gen, cuda_device)
    q = torch.randn((B, H, C, D), generator=gen, device=cuda_device)
    k = torch.randn((B, Hkv, C, D), generator=gen, device=cuda_device)
    v = torch.randn((B, Hkv, C, D), generator=gen, device=cuda_device)
    qg = (q.reshape(B, Hkv, G * C, D) * QA.logit_scale(D)).contiguous()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    for hb in (0, NT):
        args = (qg, k, v, *pool, table, i32(hist), i32(valid), hb, kv_dtype)
        got = QP.paged_prefill_cuda(*args)
        torch.cuda.synchronize()
        want = QP.paged_prefill_plain(*args)
        assert bool(torch.isfinite(got).all())
        got4, want4 = got.reshape(B, H, C, D), want.reshape(B, H, C, D)
        for b in range(B):
            torch.testing.assert_close(got4[b, :, :valid[b]],
                                       want4[b, :, :valid[b]], **TOL)
            dead_from = -(-valid[b] // 64) * 64    # first dead tile's row
            if dead_from < C:
                assert float(got4[b, :, dead_from:].abs().max()) == 0.0


# (B, H, H_kv, S, T, D, causal, window, kv_offset)
FLASH_CASES = [(2, 4, 2, 37, 37, 16, True, None, 0),
               (1, 4, 2, 24, 45, 16, False, None, 0),
               (1, 6, 2, 20, 52, 32, True, 12, 32),
               (2, 16, 8, 130, 130, 128, True, None, 0),
               (1, 16, 8, 257, 300, 128, True, 50, 43),
               (1, 16, 8, 64, 200, 128, False, None, 0),
               # G = 1 and G = 8, S no multiple of the 64-key tile
               (2, 8, 8, 100, 100, 64, True, None, 0),
               (1, 16, 2, 77, 77, 128, True, None, 0),
               # a 64-key window starting mid-tile, crossing tile edges
               (1, 16, 8, 150, 214, 128, True, 64, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_kernel_matches_plain(case, dtype, cuda_device):
    B, H, Hkv, S, T, D, causal, window, off = case
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    mk = lambda *shape: torch.randn(shape, generator=gen,
                                    device=cuda_device).to(dtype)
    q, k, v = mk(B, H, S, D), mk(B, Hkv, T, D), mk(B, Hkv, T, D)
    before = FF.flash_fwd_cuda.launches
    got = ops.flash_prefill(q, k, v, causal=causal, window=window,
                            kv_offset=off)
    torch.cuda.synchronize()
    assert FF.flash_fwd_cuda.launches == before + 1
    want = FF.flash_fwd_plain(q, k, v, causal, window, off, 64)
    tol = TOL if dtype == torch.float32 else dict(atol=2 ** -8, rtol=2 ** -8)
    torch.testing.assert_close(got[0], want[0], **tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, **TOL)


def _bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,bs", [((2, 2, 40, 16), 8),
                                      ((4, 8, 2048, 128), 256),
                                      ((1, 1, 1032, 128), 8)])
def test_quantize_kernels_bitwise(shape, bs, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1
    x[..., 2] = 0.0                                # an all-zero channel
    x[..., 3] *= 1e-29                             # absmax below 127e-30
    x[..., 0, 3] = 1e-29
    counts = [QK.absmax_cuda.launches, QK.quantize_with_scales_cuda.launches,
              QK.quantize_blocked_cuda.launches, QK.dequantize_cuda.launches]
    got = QK.quantize_per_channel_cuda(x)
    for g, w in zip(got, QK.quantize_per_channel_plain(x)):
        _bitwise(g, w)
    got = QK.quantize_blocked_cuda(x, bs)
    for g, w in zip(got, QK.quantize_blocked_plain(x, bs)):
        _bitwise(g, w)
    q, s = got
    for dt in (torch.float32, torch.bfloat16):
        _bitwise(QK.dequantize_cuda(q, s, dt), QK.dequantize_plain(q, s, dt))
    pq, ps = QK.quantize_per_channel_plain(x)
    _bitwise(QK.dequantize_cuda(pq, ps), QK.dequantize_plain(pq, ps))
    torch.cuda.synchronize()
    assert [QK.absmax_cuda.launches, QK.quantize_with_scales_cuda.launches,
            QK.quantize_blocked_cuda.launches, QK.dequantize_cuda.launches] \
        == [counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3] + 3]
    # ops routes a CUDA tensor to the kernels
    before = QK.quantize_blocked_cuda.launches
    ops.quantize_blocked(x, bs)
    assert QK.quantize_blocked_cuda.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape,bs", [((4, 8, 256, 128), 256),
                                      ((2, 2, 48, 16), 24),
                                      ((1, 1, 1032, 64), 8),
                                      ((1, 1, 4096, 8192), 256)],
                         ids=["flush", "bs24-D16", "bs8-D64", "D8192"])
def test_quantize_blocked_slab_bitwise(shape, bs, cuda_device):
    """The blocked kernel's slabs (`blocked_lanes`: 4 lanes at a flush, 8
    at D 8192, a sweep taller than the block at 24, D 16 and 64 narrower
    than one 128-column slab) bitwise against the plain version, with an
    all-zero channel and one of absmax 1e-29."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1
    x[..., 2] = 0.0
    x[..., 3] *= 1e-29
    x[..., 0, 3] = 1e-29
    before = QK.quantize_blocked_cuda.launches
    got = QK.quantize_blocked_cuda(x, bs)
    torch.cuda.synchronize()
    assert QK.quantize_blocked_cuda.launches == before + 1
    for g, w in zip(got, QK.quantize_blocked_plain(x, bs)):
        _bitwise(g, w)


def _pc_input(shape, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    x[..., 2] = 0.0                                # an all-zero channel
    x[..., 3] *= 1e-29                             # absmax below 127e-30
    x[..., 0, 3] = 1e-29
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 8, 1000, 128), (4, 8, 2048, 128),
                                   (1, 2048), (24, 2048), (1, 1, 4096, 8192)],
                         ids=["generate", "timed", "T1", "T24", "D8192"])
def test_per_channel_pair_bitwise(shape, cuda_device):
    """The per-channel pair on its grids (`absmax_plan`, `quantize_plan`)
    at the generate prefill, the timed shape, one row and 24 (gradients of
    norms) and D 8192, each kernel bitwise against its plain version."""
    x = _pc_input(shape, 11, cuda_device)
    before = [QK.absmax_cuda.launches, QK.quantize_with_scales_cuda.launches]
    am = QK.absmax_cuda(x)
    got = QK.quantize_with_scales_cuda(x, am)
    torch.cuda.synchronize()
    assert [QK.absmax_cuda.launches, QK.quantize_with_scales_cuda.launches] \
        == [before[0] + 1, before[1] + 1]
    _bitwise(am, QK.absmax_plain(x))
    for g, w in zip(got, QK.quantize_with_scales_plain(x, am)):
        _bitwise(g, w)


def _with_nan_inf(x):
    """NaN in channel 5, +inf in channel 6, -inf in channel 7 (one row each),
    a NaN and an inf together in channel 8."""
    x = x.clone()
    x[..., 1, 5] = float("nan")
    x[..., -1, 6] = float("inf")
    x[..., 0, 7] = float("-inf")
    x[..., 0, 8] = float("nan")
    x[..., -1, 8] = float("inf")
    return x


def _same_with_nan(got, want):
    """NaN at the same positions, every other bit equal."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        got, want = got[~nan], want[~nan]
    _bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,bs", [((4, 8, 1000, 128), 8),
                                      ((4, 8, 2048, 128), 256),
                                      ((1, 1, 4096, 8192), 256),
                                      ((2, 2, 40, 16), 8)],
                         ids=["generate", "timed", "D8192", "smoke"])
def test_quantize_kernels_nan_inf_match_plain(shape, bs, cuda_device):
    """A channel holding a NaN gets a NaN absmax and scale, one holding an
    inf an inf scale, and every value of both int8 0, as the reference
    gives them: the three quantize kernels against their plain versions
    (NaN positions equal, every other bit equal), the plain versions'
    int8 0 checked on the card."""
    x = _with_nan_inf(_pc_input(shape, 5, cuda_device))
    am = QK.absmax_cuda(x)
    q, s = QK.quantize_with_scales_cuda(x, am)
    bq, bsc = QK.quantize_blocked_cuda(x, bs)
    torch.cuda.synchronize()
    pam = QK.absmax_plain(x)
    pq, ps = QK.quantize_with_scales_plain(x, pam)
    pbq, pbs = QK.quantize_blocked_plain(x, bs)
    for g, w in ((am, pam), (q, pq), (s, ps), (bq, pbq), (bsc, pbs)):
        _same_with_nan(g, w)
    assert torch.isnan(ps[..., 5]).all() and torch.isnan(ps[..., 8]).all()
    assert torch.isinf(ps[..., 6]).all() and torch.isinf(ps[..., 7]).all()
    assert not pq[..., 5:9].any()
    for c, row in ((5, 1), (6, shape[-2] - 1), (7, 0)):    # the blocks hit
        blk = row // bs
        assert (pbs[..., blk, c].isnan() if c == 5
                else pbs[..., blk, c].isinf()).all()
        assert not pbq[..., blk * bs:(blk + 1) * bs, c].any()


@pytest.mark.gpu
def test_absmax_back_to_back(cuda_device):
    """Back-to-back absmax launches on shapes of several grids and output
    sizes, with and without a cluster split of T, larger and smaller in
    turns and twice over: every result bitwise and each output its own, so
    nothing one launch leaves behind reaches the next."""
    shapes = [(1, 65536, 256), (4, 8, 2048, 128), (1, 8192, 2048),
              (3, 5000, 64), (1, 24, 2048), (1, 131072, 1024),
              (2, 4, 1032, 128), (1, 49152, 1024), (1, 1, 16)]
    xs = [_pc_input(s, i, cuda_device) for i, s in enumerate(shapes)]
    want = [QK.absmax_plain(x) for x in xs]
    got = [QK.absmax_cuda(x) for _ in range(2) for x in xs for _ in range(3)]
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        _bitwise(g, want[i // 3 % len(xs)])
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits = {QK.absmax_plan(math.prod(s[:-2]), *s[-2:], sms)[1] > 1
              for s in shapes}
    assert splits == {True, False}, splits


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 8, 2048, 128), (1, 131072, 1024),
                                   (1, 24, 2048)],
                         ids=["timed", "paper", "T24"])
def test_absmax_is_one_kernel(shape, cuda_device):
    """One absmax_cuda call runs exactly one device kernel: no fill before
    it, with a cluster split of T or without."""
    x = _pc_input(shape, 2, cuda_device)
    QK.absmax_cuda(x)                         # builds
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        QK.absmax_cuda(x)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 1 and "absmax_kernel" in device[0], device


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 8, 1000, 128), (1, 49152, 1024)],
                         ids=["generate", "grad"])
def test_per_channel_pair_replays_in_a_cuda_graph(shape, cuda_device):
    """The pair captured once in a CUDA graph and replayed on new inputs,
    each with a smaller absmax than the one before: every replay bitwise
    against the plain versions of its own input."""
    x = _pc_input(shape, 6, cuda_device)
    QK.quantize_per_channel_cuda(x)           # builds outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q, s = QK.quantize_per_channel_cuda(x)
    for scale in (1.0, 0.5, 0.25):
        x.copy_(_pc_input(shape, 7 + int(4 * scale), cuda_device) * scale)
        graph.replay()
        torch.cuda.synchronize()
        pq, ps = QK.quantize_per_channel_plain(x)
        _bitwise(q, pq)
        _bitwise(s, ps)


@pytest.mark.gpu
def test_per_channel_pair_no_host_sync(cuda_device):
    """The pair at the generate prefill's shape and a paper size, with any
    host sync an error."""
    xs = [_pc_input(s, 4, cuda_device)
          for s in ((4, 8, 1000, 128), (1, 65536, 256))]
    for x in xs:
        QK.quantize_per_channel_cuda(x)       # builds and allocates first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [QK.quantize_per_channel_cuda(x) for x in xs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for x, (q, s) in zip(xs, got):
        pq, ps = QK.quantize_per_channel_plain(x)
        _bitwise(q, pq)
        _bitwise(s, ps)


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return x.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("granularity", ["per_block", "per_channel"])
def test_contiguous_smoke_tokens_match_cpu(granularity, cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams,
                                     greedy_generate)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32",
                              quant=Q.QuantConfig(granularity, 8))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 30, 5, 20)]
    sp = SamplingParams.greedy(max_new_tokens=7)

    def run(device, p):
        eng = LLMEngine(p, cfg, EngineConfig(batch=2, max_len=64),
                        device=device)
        toks = [o.token_ids for o in eng.generate(prompts, sp)]
        gen = greedy_generate(p, cfg, np.stack([prompts[0], prompts[3][:13]]),
                              steps=6, device=device)
        return toks, gen.cpu().tolist()

    before = QA.flat_decode_partials_cuda.launches
    assert run(cuda_device, _to(params, cuda_device)) == run("cpu", params)
    assert QA.flat_decode_partials_cuda.launches > before


@pytest.mark.gpu
def test_smoke_engine_tokens_match_cpu(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 70, 5, 40, 21)]
    sp = SamplingParams.greedy(max_new_tokens=8)

    def run(device, p):
        eng = LLMEngine(p, cfg, EngineConfig(batch=2, max_len=128,
                                             paged=True), device=device)
        return [o.token_ids for o in eng.generate(prompts, sp)]

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v) for v in x]
        return x.to(cuda_device)

    assert run(cuda_device, to(params)) == run("cpu", params)


@pytest.mark.gpu
def test_smoke_train_step_loss_matches_cpu(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.step import init_opt_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = SyntheticLM(DataConfig(seq_len=64, global_batch=4,
                                   vocab=cfg.vocab)).batch_at(0)

    def run(device):
        p = _to(params, device)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=10),
                               grad_compression=True)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        _, _, m = step(p, init_opt_state(p, grad_compression=True), b)
        return {k: float(v) for k, v in m.items()}

    before = FF.flash_fwd_cuda.launches
    card, cpu = run(cuda_device), run("cpu")
    assert FF.flash_fwd_cuda.launches >= before + 2 * cfg.n_layers
    assert card["loss"] == pytest.approx(cpu["loss"], rel=1e-5)
    assert card["grad_norm"] == pytest.approx(cpu["grad_norm"], rel=1e-4)
