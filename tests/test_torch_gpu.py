"""The port's CUDA kernels on the card (``gpu`` marker): each kernel against
its plain PyTorch version on the same CUDA tensors — the paged kernels for
int8, fp8_e4m3 and int4 pages (paged decode also at batches that give
one, two, four and eight splits of the page walk; paged prefill also at
chunks of 512 and 1024 with row tiles past `valid`, which must come out
0.0), the flat decode kernel and the seed baseline per block and per
channel (ring windows included; both also at batches 2 to 40, from
16 splits of their slot walk to one, window 0 and T 1032),
the flash forward (float32 on the CUDA cores and bfloat16 on the tensor
cores; causal, windowed, offset, ragged, GQA groups of 1 to 8, and at
D 128 the served models' groups 1, 3, 5 and 6; non-causal at D 64 over
whisper_small's 1500 encoder frames, S = T and S != T, partial last
tiles on both axes), the paged kernels and flat decode also at H / H_kv
32 / 32, 24 / 8, 40 / 8 and 12 / 2 (codeqwen1_5_7b, llama3_2_3b,
qwen2_5_32b, qwen2_vl_2b) and at 12 / 12, D 64 (whisper_small), flat
decode per channel over a cross cache of 1504 slots at length 1500, the
quantize/dequantize family — at the smoke shapes and at internlm2_1_8b's
widths (the blocked kernel's slabs also at a flush, at blocks of 24
and 8 and at D 16 to 8192); the smoke engines' greedy tokens on the card
against the CPU (paged and contiguous, and `greedy_generate`); and the
smoke train step's loss on the card against the CPU; the other served
architectures' smoke tokens (llama3_2_3b, codeqwen1_5_7b, qwen2_5_32b,
qwen2_moe_a2_7b, qwen2_vl_2b; QKV biases non-zero) on both backends
against the CPU, and whisper_small's through `make_serve_fns` (frames,
prefill, greedy decode steps);
threefry bits on the card
against the committed known answers and the CPU, the sampler with no host
sync, and seeded sampled and prefix-cached smoke tokens on the card
against the CPU; the host tier: a demoted page's record holds its bytes
from before the page's overwrite, a swap restore equal to the
unpressured run and to the CPU's, and no host sync in the preemption
pass, a promotion or a decode step with one in flight; the compiled
dispatch: captured-graph serving against eager on the card and against
the CPU (greedy, seeded, rows masked while others prefill, a per-layer
plan, a swap restore: tokens, pool bits and launch counts), a flip
dropping the old graphs and their memory, and replayed decode chunks
and ticks with no host sync; recurrentgemma_9b's kernel shapes (the
flash forward, flat decode and the seed at D 256 and GQA group 16, a
window shorter than the prompt and a wrapped ring; the blocked quantizer
at D 256, block 256) and the smoke tokens of recurrentgemma_9b,
xlstm_350m and mixtral_8x22b on the contiguous backend against the CPU;
one smoke train step of each family beyond internlm's (QKV bias, MoE,
M-RoPE, RG-LRU, xLSTM, whisper_small) with --grad-compression against
the CPU, and the flash attention's gradients (the kernel's forward, the
plain backward) at head widths 64, 128 and 256 against the CPU.
Skipped where there is no card; imports
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
# (H, H_kv, D, page) — the smoke config's widths and the full model's,
# then the other served models' GQA groups: G = 1 (codeqwen1_5_7b; MHA, as
# qwen2_moe_a2_7b), 3 (llama3_2_3b), 5 (qwen2_5_32b) and 6 (qwen2_vl_2b:
# 10 positions in 60 rows of a 64-row tile), and whisper_small's MHA at
# head width 64
WIDTHS = [(4, 2, 16, 8), (16, 8, 128, 256), (32, 32, 128, 256),
          (24, 8, 128, 256), (40, 8, 128, 256), (12, 2, 128, 256),
          (12, 12, 64, 256)]


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
def test_flat_decode_cross_cache_matches_plain(cuda_device):
    """whisper_small's cross attention at decode: per channel over 1504
    slots (the encoder's 1500 frames rounded up to 8, the padding zero)
    at length 1500, and an empty row."""
    B, H, D, T, n = 4, 12, 64, 1504, 1500
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    k = torch.zeros((B, H, T, D), device=cuda_device)
    v = torch.zeros((B, H, T, D), device=cuda_device)
    k[:, :, :n] = torch.randn((B, H, n, D), generator=gen, device=cuda_device)
    v[:, :, :n] = torch.randn((B, H, n, D), generator=gen, device=cuda_device)
    (kq, ks), (vq, vs) = (ops.quantize_per_channel(x) for x in (k, v))
    for x, want in zip((kq, ks), QK.quantize_per_channel_plain(k)):
        _bitwise(x, want)
    ks, vs = ks[:, :, None].contiguous(), vs[:, :, None].contiguous()
    q = torch.randn((B, H, D), generator=gen, device=cuda_device)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    args = (q, kq, ks, vq, vs, i32([n, n, 0, n]), i32([T] * B))
    got = QA.flat_decode_partials_cuda(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, QA.flat_decode_partials_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)
    assert float(got[2][2].abs().max()) == 0.0            # empty row: l = 0
    out = ops.quant_attention_decode(q, kq, ks, vq, vs, n)
    torch.testing.assert_close(out, ops.quant_attention_decode(
        q.cpu(), kq.cpu(), ks.cpu(), vq.cpu(), vs.cpu(), n).to(cuda_device),
        **TOL)


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
               (1, 16, 8, 150, 214, 128, True, 64, 64),
               # the served models' groups at D 128: G = 1 (32 / 32), G = 3
               # (24 / 8: 21 positions in 63 rows a tile) and G = 5 (40 /
               # 8: 12 positions in 60 rows)
               (1, 32, 32, 130, 130, 128, True, None, 0),
               (2, 24, 8, 300, 300, 128, True, None, 0),
               (1, 24, 8, 257, 300, 128, True, 50, 43),
               (2, 40, 8, 300, 300, 128, True, None, 0),
               (1, 40, 8, 200, 264, 128, True, None, 64),
               # G = 6 (qwen2_vl_2b, 12 / 2)
               (2, 12, 2, 300, 300, 128, True, None, 0),
               (1, 12, 2, 257, 300, 128, True, 50, 43),
               # whisper_small, non-causal at D 64: the encoder (S = T =
               # 1500 = 23 x 64 + 28) and cross-attention prefill (256
               # decoder queries over 1500 frames), partial last tiles
               (1, 12, 12, 1500, 1500, 64, False, None, 0),
               (2, 12, 12, 256, 1500, 64, False, None, 0),
               (1, 12, 12, 37, 1500, 64, False, None, 0)]


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
@pytest.mark.parametrize("arch", ["llama3_2_3b", "codeqwen1_5_7b",
                                  "qwen2_5_32b", "qwen2_moe_a2_7b",
                                  "qwen2_vl_2b"])
def test_served_arch_smoke_tokens_match_cpu(arch, cuda_device):
    """The other served architectures' smoke configs (float32, QKV biases
    drawn non-zero): the paged engine (graphed on the card) and the
    contiguous one give the CPU's greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    gen = torch.Generator().manual_seed(1)
    for layer in params["layers"]:
        for name, b in layer["attn"].items():
            if name.startswith("b"):
                b.copy_(0.5 * torch.randn(b.shape, generator=gen))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 70, 5, 40, 21)]
    sp = SamplingParams.greedy(max_new_tokens=8)

    def run(device, paged):
        eng = LLMEngine(_to(params, device), cfg, EngineConfig(
            batch=2, max_len=128, paged=paged), device=device)
        return [o.token_ids for o in eng.generate(prompts, sp)]

    for paged in (True, False):
        assert run(cuda_device, paged) == run("cpu", paged), paged


@pytest.mark.gpu
def test_whisper_smoke_serve_fns_match_cpu(cuda_device):
    """whisper_small's smoke config in float32 through `make_serve_fns`:
    `make_frames` frames, a 16-token prefill and 12 greedy decode steps
    (a block flush in the self caches) give the CPU's tokens; the cross
    caches' lengths equal and scales within 1e-5 relative (the prefill's
    quantize pair at (2, 4, 24, 16))."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_frames
    from repro_torch.models import encdec
    from repro_torch.serving.engine import make_serve_fns
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("whisper_small", smoke=True),
                              dtype="float32")
    params = encdec.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    frames = torch.from_numpy(make_frames(DataConfig(
        seq_len=16, global_batch=2, vocab=cfg.vocab), cfg.d_model,
        cfg.encoder_seq))
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (2, 16)).astype(np.int32))

    def run(device, p):
        init, prefill, decode = make_serve_fns(cfg, max_len=32,
                                               device=device)
        logits, state = prefill(p, {"frames": frames.to(device),
                                    "tokens": toks.to(device)}, init(2))
        out, pos = [], torch.full((2,), 16, dtype=torch.int32)
        for _ in range(12):
            tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
            out.append(tok.cpu().tolist())
            logits, state = decode(p, tok[:, None], state, pos.to(device))
            pos = pos + 1
        return out, state

    before = (FF.flash_fwd_cuda.launches, QA.flat_decode_partials_cuda.launches)
    got, state = run(cuda_device, _to(params, cuda_device))
    want, cpu_state = run("cpu", params)
    assert got == want
    L = cfg.n_layers
    # at prefill one flash forward an encoder layer and two a decoder
    # layer (self, cross); flat decode twice a decoder layer a step
    assert FF.flash_fwd_cuda.launches - before[0] == \
        cfg.n_encoder_layers + 2 * L
    assert QA.flat_decode_partials_cuda.launches - before[1] == 2 * L * 12
    for c, w in zip(state["cross"], cpu_state["cross"]):
        assert c.length == w.length == cfg.encoder_seq
        for name in ("k_s", "v_s"):
            torch.testing.assert_close(getattr(c, name).cpu(),
                                       getattr(w, name), rtol=1e-5, atol=0)


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
        _, _, m = step(p, init_opt_state(p, cfg, grad_compression=True), b)
        return {k: float(v) for k, v in m.items()}

    before = FF.flash_fwd_cuda.launches
    card, cpu = run(cuda_device), run("cpu")
    assert FF.flash_fwd_cuda.launches >= before + 2 * cfg.n_layers
    assert card["loss"] == pytest.approx(cpu["loss"], rel=1e-5)
    assert card["grad_norm"] == pytest.approx(cpu["grad_norm"], rel=1e-4)


@pytest.mark.gpu
def test_prng_bits_on_card_equal_constants(cuda_device):
    """threefry on the card: the committed known answers of jax 0.9, and
    keys, bits and uniforms at (4, 92544) bit for bit against the CPU."""
    from repro_torch.models import prng
    key = prng.PRNGKey(7, device=cuda_device)
    folded = prng.fold_in(key, 3)
    assert tuple(key.tolist()) == prng.KNOWN_KEY_7
    assert tuple(folded.tolist()) == prng.KNOWN_FOLD_7_3
    assert tuple(prng.random_bits(folded, 4).tolist()) == prng.KNOWN_BITS_7_3
    keys = torch.stack([prng.fold_in(prng.PRNGKey(s), j)
                        for s, j in ((0, 0), (11, 5), (2**31 - 1, 47),
                                     (12, 2**31 - 1))])
    card = keys.to(cuda_device)
    assert torch.equal(prng.random_bits(card, 92544).cpu(),
                       prng.random_bits(keys, 92544))
    u_card = prng.uniform(card, 92544, minval=1.1754944e-38).cpu()
    u_cpu = prng.uniform(keys, 92544, minval=1.1754944e-38)
    assert torch.equal(u_card.view(torch.int32), u_cpu.view(torch.int32))


@pytest.mark.gpu
def test_sampler_no_host_sync(cuda_device):
    """`sample_at_step` at the full vocabulary with mixed rows, with any
    host sync an error."""
    from repro_torch.models import sampling as SMP
    from repro_torch.serving.params import SamplingParams, sampling_arrays
    sps = [SamplingParams(temperature=0.7, top_k=50, seed=11),
           SamplingParams.greedy(),
           SamplingParams(temperature=1.0, top_p=0.9, seed=12),
           SamplingParams(temperature=0.8, top_k=40, top_p=0.95)]
    s = SMP.device_arrays(sampling_arrays(sps, steps=[3, 0, 7, 1]),
                          cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    logits = torch.randn((4, 92544 + 64), generator=gen, device=cuda_device)
    args = (logits, s["temperature"], s["top_k"], s["top_p"], s["key"],
            s["step"])
    want = SMP.sample_at_step(*args, vocab=92544)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = SMP.sample_at_step(*args, vocab=92544)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    assert int(got[1]) == int(logits[1, :92544].argmax())


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_sampled_smoke_tokens_match_cpu(paged, cuda_device):
    """Seeded sampled requests mixed with greedy ones, and (paged) the
    prefix cache's hit-against-miss protocol: the same tokens on the card
    (kernels) and on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(9)
    shared = rng.randint(0, cfg.vocab, (32,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, cfg.vocab, (n,))])
               .astype(np.int32) for n in (8, 3, 17, 9)]
    sps = [SamplingParams.greedy(max_new_tokens=8),
           SamplingParams(temperature=0.7, top_k=50, seed=11,
                          max_new_tokens=8),
           SamplingParams(temperature=1.0, top_p=0.9, seed=12,
                          max_new_tokens=8),
           SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                          max_new_tokens=8)]

    def run(device, p):
        eng = LLMEngine(p, cfg, EngineConfig(
            batch=2, max_len=128, paged=paged, prefix_cache=paged,
            prefill_chunk=16 if paged else None), device=device)
        toks = [o.token_ids for o in eng.generate(prompts, sps)]
        toks += [o.token_ids for o in eng.generate(prompts[:1], sps[:1])]
        rep = eng.pool_report()
        return toks, {k: rep[k] for k in ("page_hits", "page_misses")
                      if k in rep}

    card, cpu = run(cuda_device, _to(params, cuda_device)), run("cpu", params)
    assert card == cpu
    assert card[0][0] == card[0][-1]
    if paged:
        assert card[1]["page_hits"] > 0


def _tier_engine(device, params, cfg, **kw):
    from repro_torch.serving import ContinuousBatcher, EngineConfig
    return ContinuousBatcher(params, cfg, EngineConfig(
        batch=2, max_len=64, paged=True, n_pages=24, chunk=1,
        prefix_cache=True, watermark=1, **kw), device=device)


def _smoke_f32():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32")
    return cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")


def _decode_pair(b, cfg, until=10):
    """Submit a greedy and a seeded request; step until both decode with
    at least ``until`` tokens each. Returns the finished outputs (none)."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.RandomState(3)
    p0, p1 = (rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
              for n in (17, 19))
    b.submit(Request(uid=0, prompt=p0,
                     sampling=SamplingParams.greedy(max_new_tokens=16)))
    b.submit(Request(uid=1, prompt=p1, sampling=SamplingParams(
        temperature=0.9, seed=7, max_new_tokens=16)))
    outs = {}
    for _ in range(200):
        for r in b.step():
            outs[r.uid] = list(r.generated)
        rows = [r for r in b.rows if r is not None]
        if len(rows) == 2 and not b.prefilling \
                and all(len(r.generated) >= until for r in rows):
            return outs
    raise AssertionError("the rows did not reach decode")


def _drain(b, outs):
    for _ in range(400):
        for r in b.step():
            outs[r.uid] = list(r.generated)
        if len(outs) == 2:
            return outs
    raise AssertionError("the requests did not complete")


@pytest.mark.gpu
def test_demotion_copies_the_page_before_its_overwrite(cuda_device):
    """Reclaim demotes every cached page to the host tier and the pools are
    overwritten at once, in the same tick with no synchronize between: the
    records hold the bytes from before the overwrite (stream order, not a
    host sync, protects them)."""
    cfg, params = _smoke_f32()
    b = _tier_engine(cuda_device, _to(params, cuda_device), cfg,
                     host_pages=32)
    outs = _drain(b, _decode_pair(b, cfg, until=1))
    a = b.allocator
    cached = list(a.lru)
    assert len(cached) >= 4 and outs
    digests = [a.hash_of[p] for p in cached]
    before = [(c.pool.k_q[cached].clone(), c.pool.v_s[cached].clone())
              for c in b.state]
    ids = a.alloc(len(a.free) + len(a.lru))
    idx = torch.tensor(ids, device=cuda_device)
    for c in b.state:                  # the overwrite, right behind the copy
        c.pool.k_q.view(torch.int8).index_fill_(0, idx, 77)
        c.pool.v_s.index_fill_(0, idx, -1.0)
    tier = b._tiering
    assert tier.demotions == len(cached)
    for j, h in enumerate(digests):
        rec = tier.pages[h].wait()
        for (kq, _, _, vs), (bk, bv) in zip(rec.payloads, before):
            assert torch.equal(kq, bk[j].cpu()) and torch.equal(vs, bv[j].cpu())
            assert kq.is_pinned()


@pytest.mark.gpu
def test_swap_restore_on_card_equals_unpressured(cuda_device):
    """Both rows preempted mid-decode, every cached device page reclaimed:
    the resume restores from the host tier, and the greedy and seeded
    streams equal the unpressured run's on the card and the CPU's swap
    restore, bit for bit."""
    cfg, params = _smoke_f32()
    dev_params = _to(params, cuda_device)

    def forced(device, p):
        b = _tier_engine(device, p, cfg, host_pages=32)
        outs = _decode_pair(b, cfg)
        for i in (0, 1):
            b._preempt_row(i)
        a = b.allocator
        a.release(a.alloc(len(a.free) + len(a.lru)))
        return _drain(b, outs), b.pool_report()

    base = _tier_engine(cuda_device, dev_params, cfg)
    base = _drain(base, _decode_pair(base, cfg))
    card, rep = forced(cuda_device, dev_params)
    cpu, _ = forced("cpu", params)
    assert card == base == cpu
    assert rep["preempt_swap_restores"] == 2 and rep["promotions"] >= 1
    assert rep["preempt_recompute_resumes"] == 0


@pytest.mark.gpu
def test_no_host_sync_with_a_promotion_in_flight(cuda_device):
    """With swap_delay 2: the preemption pass (preempt-by-swap copies the
    row's pages out), the promotion (side-stream copies in) and a decode
    step of the other row while that promotion is in flight, each with any
    host sync an error; the restored stream equals the unpressured one."""
    from repro_torch.core.paging import PoolFaultInjector
    cfg, params = _smoke_f32()
    dev_params = _to(params, cuda_device)
    base = _tier_engine(cuda_device, dev_params, cfg)
    base = _drain(base, _decode_pair(base, cfg))
    b = _tier_engine(cuda_device, dev_params, cfg, host_pages=32,
                     fault_injector=PoolFaultInjector(5, swap_delay=2))
    outs = _decode_pair(b, cfg)
    a = b.allocator
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b._preempt_row(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert b.preempt_by_swap == 1
    a.release(a.alloc(len(a.free) + len(a.lru)))
    chain = b._suspended[1]["full_chain"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        issued = b._issue_prefetch(chain, 0, len(chain))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert issued == len(chain) and len(a.inflight) == issued
    # row 0's decode step with the promotion in flight, replayed from the
    # engine's own graph and then dispatched eagerly; the probe's residuals
    # and lengths put back each time: the engine computes row 0's step
    # again (a page it flushed gets the same bytes)
    assert _probe_decode(b, [0]) == 1
    b._dispatch.enabled = False
    assert _probe_decode(b, [0]) == 0
    b._dispatch.enabled = True
    assert _drain(b, outs) == base
    assert b.preempt_swap_restores == 1 and not a.inflight


# -- the compiled dispatch: captured CUDA graphs on the paged path ----------

def _probe_decode(b, rows, n=1):
    """chip_smoke's `probe_decode`: one decode dispatch of ``rows`` on the
    batcher's live state as a tick runs it up to its read (tables and
    lengths pushed, inputs uploaded, the replays of the engine's own
    graphs), with any host sync an error; the residuals and lengths it
    advances are put back."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import probe_decode
    return probe_decode(b, rows, n)


def _launch_counts():
    return (QA.paged_decode_partials_cuda.launches,
            dict(QA.paged_decode_partials_cuda.launches_by_dtype),
            QP.paged_prefill_cuda.launches,
            dict(QP.paged_prefill_cuda.launches_by_dtype))


def _count_delta(after, before):
    return tuple(a - b if isinstance(a, int) else
                 {k: a[k] - b[k] for k in a} for a, b in zip(after, before))


GRAPH_SPS = {
    "greedy": [None] * 5,
    "sampled": [None, dict(temperature=0.7, top_k=50, seed=11), None,
                dict(temperature=1.0, top_p=0.9, seed=12),
                dict(temperature=0.8, top_k=40, top_p=0.95)]}
GRAPH_CASES = {
    "greedy": ("greedy", dict(batch=2, max_len=128)),
    "sampled-chunk4": ("sampled", dict(batch=2, max_len=128, chunk=4)),
    "masked-prefill16": ("sampled", dict(batch=3, max_len=128,
                                         prefill_chunk=16, chunk=2)),
    "plan-int8-int4": ("greedy", dict(batch=2, max_len=128, prefill_chunk=8,
                                      kv_cache_dtype=("int8", "int4"))),
    "tier-swap-restore": ("tier", {}),
}


def _graph_case(name, device, params, cfg, eager=False):
    """Serve one of GRAPH_CASES; returns (tokens, batcher, launch counts
    of the run). ``eager`` forces eager dispatch on the card."""
    from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams)
    mix, config = GRAPH_CASES[name]
    before = _launch_counts()
    if mix == "tier":
        b = _tier_engine(device, params, cfg, host_pages=32)
        b._dispatch.enabled = b._dispatch.enabled and not eager
        outs = _decode_pair(b, cfg)
        for i in (0, 1):
            b._preempt_row(i)
        a = b.allocator
        a.release(a.alloc(len(a.free) + len(a.lru)))
        toks = _drain(b, outs)
        assert b.preempt_swap_restores == 2
    else:
        eng = LLMEngine(params, cfg, EngineConfig(paged=True, **config),
                        device=device)
        b = eng.batcher
        b._dispatch.enabled = b._dispatch.enabled and not eager
        rng = np.random.RandomState(7)
        prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
                   for n in (13, 70, 5, 40, 21)]
        sps = [SamplingParams(max_new_tokens=9, **sp) if sp else
               SamplingParams.greedy(max_new_tokens=9)
               for sp in GRAPH_SPS[mix]]
        toks = [o.token_ids for o in eng.generate(prompts, sps)]
    torch.cuda.synchronize()
    return toks, b, _count_delta(_launch_counts(), before)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_graphed_serving_equals_eager_and_cpu(case, cuda_device):
    """The paged engine replaying captured graphs (the default on the
    card) against the same engine forced eager on the card and against
    the CPU: identical tokens (greedy and seeded, rows masked while others
    prefill, a per-layer plan, a swap restore through the host tier),
    every layer's pool pages and scales the same bits, and the launch
    counters advanced through the replays exactly as the eager launches
    did."""
    cfg, params = _smoke_f32()
    dev_params = _to(params, cuda_device)
    graphed, gb, gcounts = _graph_case(case, cuda_device, dev_params, cfg)
    eager, eb, ecounts = _graph_case(case, cuda_device, dev_params, cfg,
                                     eager=True)
    cpu, _, _ = _graph_case(case, "cpu", params, cfg)
    assert graphed == eager == cpu
    d = gb._dispatch
    assert d.enabled and d.captures > 0 and d.replays > d.captures
    assert eb._dispatch.captures == 0
    assert gcounts == ecounts and gcounts[0] > 0 and gcounts[2] > 0
    for gc, ec in zip(gb.state, eb.state):
        for n in ("k_q", "v_q", "k_s", "v_s"):
            g, e = getattr(gc.pool, n)[1:], getattr(ec.pool, n)[1:]
            assert torch.equal(g.view(torch.uint8) if g.dtype != torch.float32
                               else g.view(torch.int32),
                               e.view(torch.uint8) if e.dtype != torch.float32
                               else e.view(torch.int32)), n


@pytest.mark.gpu
def test_long_budget_replays_one_scan_graph(cuda_device):
    """Two requests of 200 new tokens (one seeded) under the default chunk
    (no stop condition: chunks of 128 steps and down): the tokens graphed
    equal eager and the CPU's, and what is captured does not grow with
    the chunk: every chunk length replays the decode-scan step's graph of
    its shape key."""
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    cfg, params = _smoke_f32()
    dev_params = _to(params, cuda_device)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 21)]
    sps = [SamplingParams.greedy(max_new_tokens=200),
           SamplingParams(temperature=0.8, top_k=40, seed=3,
                          max_new_tokens=200)]

    def serve(device, p, eager=False):
        eng = LLMEngine(p, cfg, EngineConfig(batch=2, max_len=256,
                                             paged=True), device=device)
        b = eng.batcher
        b._dispatch.enabled = b._dispatch.enabled and not eager
        return [o.token_ids for o in eng.generate(prompts, sps)], b

    graphed, gb = serve(cuda_device, dev_params)
    eager, _ = serve(cuda_device, dev_params, eager=True)
    cpu, _ = serve("cpu", params)
    assert graphed == eager == cpu and list(map(len, graphed)) == [200, 200]
    chunks = {n for n, _ in gb._chunk_fns}
    scans = [c for c in gb._dispatch.captured
             if c["step"] == "decode_scan_step"]
    assert max(chunks) >= 64 and len(chunks) >= 3
    assert 1 <= len(scans) <= 2
    assert gb._dispatch.replays >= sum(chunks)


def _pool_segments(pool) -> int:
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


@pytest.mark.gpu
def test_flip_drops_the_graphs_and_their_memory(cuda_device):
    """An idle flip int8 -> int4 drops every graph of the old generation
    (none replays again), memory_allocated falls back to its level before
    the engine and the old graph pool is released; the keys survive, a
    flip back recaptures, and each side serves a fresh engine's tokens."""
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    cfg, params = _smoke_f32()
    p = _to(params, cuda_device)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (30, 50)]
    sp = SamplingParams.greedy(max_new_tokens=6)
    conf = dict(batch=2, max_len=128, paged=True, prefill_chunk=16)
    serve = lambda e: [o.token_ids for o in e.generate(prompts, sp)]
    serve(LLMEngine(p, cfg, EngineConfig(**conf), device=cuda_device))
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated(cuda_device)
    eng = LLMEngine(p, cfg, EngineConfig(**conf), device=cuda_device)
    b = eng.batcher
    first = serve(eng)
    d = b._dispatch
    steps = lambda: list(d._steps)
    pool, gen, captures = d.pool, d.generation, d.captures
    assert captures > 0 and d.pool_bytes() > 0
    keys = set(b._chunk_prefill_fns) | set(b._chunk_fns)
    b.config.kv_cache_dtype = "int4"
    b._ensure_backend_dtype()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda_device) <= level
    assert d.generation == gen + 1 and not any(s.graphs for s in steps())
    torch.cuda.empty_cache()
    assert _pool_segments(pool) == 0
    flipped = serve(eng)
    fresh = serve(LLMEngine(p, cfg, EngineConfig(kv_cache_dtype="int4",
                                                 **conf), device=cuda_device))
    assert flipped == fresh and d.captures > captures
    assert keys <= set(b._chunk_prefill_fns) | set(b._chunk_fns)
    captures = d.captures
    b.config.kv_cache_dtype = "int8"
    assert serve(eng) == first and d.captures > captures


@pytest.mark.gpu
@pytest.mark.parametrize("mix", ["greedy", "sampled"])
def test_replayed_decode_chunk_makes_no_host_sync(mix, cuda_device):
    """A 4-step decode-scan chunk (greedy; one row seeded) and, under a
    watermark, a per-token tick, each replayed from the engine's graph
    with any host sync an error; the engine then finishes as if never
    probed."""
    from repro_torch.serving import (ContinuousBatcher, EngineConfig,
                                     Request, SamplingParams)
    cfg, params = _smoke_f32()
    p = _to(params, cuda_device)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (17, 19)]
    sps = [SamplingParams.greedy(max_new_tokens=16),
           SamplingParams.greedy(max_new_tokens=16) if mix == "greedy" else
           SamplingParams(temperature=0.9, seed=7, max_new_tokens=16)]

    def run(probe, **conf):
        b = ContinuousBatcher(p, cfg, EngineConfig(
            batch=2, max_len=64, paged=True, **conf), device=cuda_device)
        for i, (pr, s) in enumerate(zip(prompts, sps)):
            b.submit(Request(uid=i, prompt=pr, sampling=s))
        outs, probed = {}, False
        for _ in range(200):
            for r in b.step():
                outs[r.uid] = list(r.generated)
            rows = [r for r in b.rows if r is not None]
            if probe and not probed and len(rows) == 2 \
                    and not b.prefilling and len(rows[0].generated) >= 4:
                _probe_decode(b, [0, 1], n=conf.get("chunk", 1))
                probed = True
            if len(outs) == 2:
                return outs
        raise AssertionError("the requests did not complete")

    for conf in (dict(chunk=4), dict(chunk=1, watermark=1, n_pages=12)):
        assert run(True, **conf) == run(False, **conf)


# -- recurrentgemma_9b's kernels: head width 256, GQA group 16 ----------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S,window,off", [(300, 128, 0), (200, 100, 64),
                                          (130, None, 0)])
def test_flash_forward_d256_group16_matches_plain(S, window, off, dtype,
                                                  cuda_device):
    """16 query heads over one kv head at D 256 (4 positions a 64-row
    tile), a window shorter than the prompt, an offset."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    mk = lambda *shape: torch.randn(shape, generator=gen,
                                    device=cuda_device).to(dtype)
    q, k, v = mk(1, 16, S, 256), mk(1, 1, S + off, 256), mk(1, 1, S + off,
                                                             256)
    got = ops.flash_prefill(q, k, v, causal=True, window=window,
                            kv_offset=off)
    torch.cuda.synchronize()
    want = FF.flash_fwd_plain(q, k, v, True, window, off, 64)
    tol = TOL if dtype == torch.float32 else dict(atol=2 ** -8, rtol=2 ** -8)
    torch.testing.assert_close(got[0], want[0], **tol)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["flat", "seed"])
@pytest.mark.parametrize("window", [200, 256], ids=["window", "full-ring"])
def test_flat_decode_d256_wrapped_ring_matches_plain(kernel, window,
                                                     cuda_device):
    """A per-block ring of 256 slots (block 64) at D 256 and G 16 whose
    rows have wrapped (lengths past T), with a window shorter than the
    ring; an empty row gives o = 0, m = -1e30, l = 0."""
    B, H, Hkv, D, T, bs = 4, 16, 1, 256, 256, 64
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    k = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    q = torch.randn((B, H, D), generator=gen, device=cuda_device)
    (kq, ks), (vq, vs) = (QK.quantize_blocked_plain(x, bs) for x in (k, v))
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    lengths, windows = i32([700, 300, 100, 0]), i32([window] * B)
    fn = (QA.flat_decode_partials_cuda if kernel == "flat"
          else QA.seed_decode_partials_cuda)
    got = fn(q, kq, ks, vq, vs, lengths, windows)
    torch.cuda.synchronize()
    want = QA.flat_decode_partials_plain(q, kq, ks, vq, vs, lengths, windows)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    o, m, l = got
    assert float(o[3].abs().max()) == 0.0 and float(l[3].max()) == 0.0
    assert bool((m[3] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 1, 3072, 256), (4, 1, 256, 256)],
                         ids=["prefill", "flush"])
def test_quantize_blocked_d256_bitwise(shape, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn(shape, generator=gen, device=cuda_device)
    q, s = QK.quantize_blocked_cuda(x, 256)
    pq, ps = QK.quantize_blocked_plain(x, 256)
    _bitwise(q, pq)
    _bitwise(s, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_350m",
                                  "mixtral_8x22b"])
def test_recurrent_smoke_tokens_match_cpu(arch, cuda_device):
    """The contiguous LLMEngine on the three models' smoke configs in
    float32 (RG-LRU gate vectors seeded per channel; prompts longer than
    the window of 16, so the ring wraps): the card's greedy tokens equal
    the CPU's; a paged engine refuses them."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(3)
    for layer in params["layers"]:
        if "rglru" in layer:
            g = layer["rglru"]
            for name, (mean, std) in (("lam", (2.0, 0.5)),
                                      ("w_a", (0.5, 0.25)),
                                      ("w_x", (0.5, 0.25)),
                                      ("b_a", (0.0, 0.25)),
                                      ("b_x", (0.0, 0.25))):
                g[name].copy_(torch.from_numpy((mean + std * rng.randn(
                    g[name].shape[0])).astype(np.float32)))
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 70, 5, 40, 21)]
    sps = [SamplingParams.greedy(max_new_tokens=n) for n in (8, 9, 5, 7, 8)]

    def run(device, p):
        eng = LLMEngine(p, cfg, EngineConfig(batch=2, max_len=128),
                        device=device)
        return [o.token_ids for o in eng.generate(prompts, sps)]

    before = QA.flat_decode_partials_cuda.launches
    assert run(cuda_device, _to(params, cuda_device)) == run("cpu", params)
    attn = any(k != "mlstm" and k != "slstm" for k in cfg.block_pattern)
    assert (QA.flat_decode_partials_cuda.launches > before) == attn
    with pytest.raises(ValueError, match="full-attention stacks only"):
        LLMEngine(_to(params, cuda_device), cfg, EngineConfig(
            batch=2, max_len=128, paged=True), device=cuda_device).generate(
            prompts[:1], sps[0])


TRAIN_ARCHS = ("llama3_2_3b", "codeqwen1_5_7b", "qwen2_5_32b",
               "qwen2_moe_a2_7b", "mixtral_8x22b", "qwen2_vl_2b",
               "recurrentgemma_9b", "xlstm_350m", "whisper_small")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_family_train_step_matches_cpu(arch, cuda_device):
    """One smoke train step of each family beyond internlm's, float32,
    with --grad-compression, on the card (flash forward and the
    per-channel pair through the kernels) against the CPU's (plain
    versions), the same weights (QKV biases and RG-LRU gate vectors drawn
    non-zero) and batch (frames for whisper): loss within 1e-5 relative,
    grad_norm 1e-4, as the internlm step above; the attention blocks'
    flash launches at least 2 a block (forward and recompute)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM, make_frames
    from repro_torch.models import encdec
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.step import init_opt_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    init = encdec.init_params if cfg.family == "encdec" else T.init_params
    params = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.RandomState(3)
    for layer in params.get("layers", []):
        for name in ("bq", "bk", "bv"):
            if name in layer.get("attn", {}):
                layer["attn"][name].copy_(torch.from_numpy(
                    0.5 * rng.randn(layer["attn"][name].shape[0]).astype(
                        np.float32)))
        for name in ("lam", "w_a", "w_x", "b_a", "b_x"):
            if name in layer.get("rglru", {}):
                layer["rglru"][name].add_(torch.from_numpy(0.25 * rng.randn(
                    layer["rglru"][name].shape[0]).astype(np.float32)))
    dcfg = DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab)
    batch = SyntheticLM(dcfg).batch_at(0)
    if cfg.family == "encdec":
        batch["frames"] = make_frames(dcfg, cfg.d_model, cfg.encoder_seq)

    def run(device):
        p = _to(params, device)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=10),
                               grad_compression=True)
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        _, _, m = step(p, init_opt_state(p, cfg, grad_compression=True), b)
        return {k: float(v) for k, v in m.items()}

    n_attn = (3 * cfg.n_layers if cfg.family == "encdec" else sum(
        cfg.block_kind(i) in T.ATTN_KINDS for i in range(cfg.n_layers)))
    before = FF.flash_fwd_cuda.launches
    pair = QK.absmax_cuda.launches
    card, cpu = run(cuda_device), run("cpu")
    assert FF.flash_fwd_cuda.launches - before >= 2 * n_attn
    assert QK.absmax_cuda.launches > pair
    assert math.isfinite(card["loss"])
    assert card["loss"] == pytest.approx(cpu["loss"], rel=1e-5)
    assert card["aux_loss"] == pytest.approx(cpu["aux_loss"], rel=1e-5)
    assert card["grad_norm"] == pytest.approx(cpu["grad_norm"], rel=1e-4)


# (H, H_kv, S, T, D, causal, window): the trained families' shapes at
# their head widths: internlm / qwen2_vl (G 6) at D 128, whisper's
# encoder and cross-attention at D 64 (non-causal, S != T), recurrentgemma
# at D 256 (G 16, a window shorter than S)
FLASH_BWD = {
    "d128_g6": (12, 2, 192, 192, 128, True, None),
    "d64_encoder": (12, 12, 150, 150, 64, False, None),
    "d64_cross": (12, 12, 64, 150, 64, False, None),
    "d256_g16_window": (16, 1, 160, 160, 256, True, 64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(FLASH_BWD))
def test_flash_backward_matches_cpu(case, cuda_device):
    """`models.flash.flash_attention`'s gradients on the card (the kernel's
    forward, its m and l feeding the plain backward) against the CPU's,
    float32: dq, dk, dv within 1e-4 (|b| + max |b|) (cuBLAS against the
    CPU's sums, over tiles of another order)."""
    from repro_torch.models import flash
    torch.backends.cuda.matmul.allow_tf32 = False
    H, Hkv, S, T, D, causal, window = FLASH_BWD[case]
    gen = torch.Generator().manual_seed(sorted(FLASH_BWD).index(case))
    q, k, v, w = (torch.randn(s, generator=gen) for s in (
        (2, H, S, D), (2, Hkv, T, D), (2, Hkv, T, D), (2, H, S, D)))
    kv_offset = T - S if causal else 0

    def grads(device):
        xs = [x.to(device).requires_grad_(True) for x in (q, k, v)]
        out = flash.flash_attention(*xs, causal, window, kv_offset)
        return [g.cpu() for g in torch.autograd.grad(
            (out * w.to(device)).sum(), xs)]

    before = FF.flash_fwd_cuda.launches
    card, cpu = grads(cuda_device), grads("cpu")
    assert FF.flash_fwd_cuda.launches == before + 1
    for a, b in zip(card, cpu):
        tol = 1e-4 * (b.abs() + b.abs().max())
        assert bool(((a - b).abs() <= tol).all()), float((a - b).abs().max())
