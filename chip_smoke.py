#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (no fallback anywhere):
  1. card and build: the card's name and power limit, torch/CUDA versions;
     every CUDA kernel built from csrc/ for sm_90a, one nvcc per source, all
     at once (ptxas register/spill summary printed; full logs in
     build/kernels/*.log); TF32 off; the count of tensor-core instructions
     (HMMA/HGMMA, from cuobjdump -sass) in each flash forward kernel (the
     bf16 kernel must have some) and in each paged prefill kernel (every
     one must have some).
  2. each kernel against its plain PyTorch version on the card, at the
     main paths' full shapes (internlm2_1_8b: H 16, H_kv 8, D 128, block
     256): paged decode and prefill for int8, fp8_e4m3 and int4 pages; flat
     decode and the seed baseline per block and per channel (mixed lengths,
     an empty row and a ring row, length 3000 in a window of 1024; both
     per channel also at the generate path's T = 1032, partial last tiles;
     the seed timed at full lengths and at lengths 1, which must take at
     least SEED_LEN1_MIN of the first: it reads every slot); the
     flash forward in bf16 at the training shape (4, 16, 2048, 128) causal
     and the contiguous prefill's 1536 rebuild, with a window and
     kv_offset, and at an odd S in float32; the quantize family bitwise at
     (4, 8, 2048, 128), per channel at (4, 8, 1000, 128) (also timed there,
     each kernel and the pair back to back) and blocked at a flush's (4, 8,
     256, 128) (also timed there beside its bound), and with NaN and inf
     channels (NaN where the plain versions have it, every other bit
     equal, int8 0 in those channels as in the reference); an empty launch
     timed as the kernels are, the harness's floor. Times
     from CUDA events, the L2 cache flushed and the host's enqueue kept
     off the clock before each launch;
     the flash forward's and paged prefill's achieved TFLOP/s and the
     decode kernels' GB/s beside them, the decode kernels' split counts,
     the worst multiple of the tolerance over the checks, paged prefill's
     second bound (its split bf16 products at the tensor-core peak) and
     its row tiles past `valid` checked to be 0.0; the paged, flat and
     seed decode calls once more with any host sync an error.
  3. the paper's kernels at its eight (T, D) sizes: quantize per channel,
     quantize blocked (block 256) and dequantize through `kernels.ops`
     (launches counted), each bitwise against its plain version, Eq. 9
     checked (with float32 rounding slack), errors and times printed (the
     per-channel pair also back to back); then the pair at each distinct
     (T, D) that --grad-compression quantizes (internlm2_1_8b's 12 stacked
     gradient leaves), bitwise and timed.
  4. CPU <-> card parity: the smoke config in float32 on the card
     (kernels) and on the CPU (plain versions): identical greedy tokens
     from the paged LLMEngine, the contiguous LLMEngine and greedy_generate
     (per block and per channel).
  5. the slices at full width: internlm2_1_8b with random bf16 weights from
     a seeded torch.Generator serves 5 greedy requests through the paged
     LLMEngine and through the contiguous one (batch 4, max_len 2048), and
     runs greedy_generate per block (a block flush in every layer) and per
     channel (batch 4, 1000-token prompts, 32 steps); the seed baseline
     runs over the contiguous cache's shape beside flat decode; then, the
     serving weights freed, the train CLI's entry point takes 3 steps at
     batch 4 x 2048 and 1 more with --grad-compression (step 0's loss held
     against the plain flash forward's). The kernels' launch counters are
     set to 0 just before each path and must be > 0 just after for every
     kernel the path runs.
  6. a {"kernels": [...]} line, then the card line, then as the last line
     {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device or without the repository's src/.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 peak outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 dense tensor-core peak
DTYPES = ("int8", "fp8_e4m3", "int4")
# kernel vs plain version, both float32 on the card; sums run in another
# order (tile-wise online softmax vs one softmax), so elementwise
# |a - b| <= ATOL + RTOL * |b|
ATOL, RTOL = 1e-5, 1e-4
# flash forward on bfloat16 inputs, against the plain version walked in
# the kernel's 64-key tiles: m and l (float32 sums of unrounded
# probabilities) as above; the output within one bf16 ulp (2^-8) of its
# scale, as both versions round each probability to bf16 before P.V and a
# last-bit difference in a float32 logit can move that rounding a whole
# bf16 ulp
ATOL_BF16 = RTOL_BF16 = 2.0 ** -8
FLASH_TILE = 64                # keys per kernel tile (csrc/flash_fwd.cu)
PREFILL_ROWS = 64              # query rows per tile (csrc/paged_prefill.cu)
# the full-width train step's loss through the kernel vs through the
# plain flash forward, bf16 model: relative
LOSS_RTOL = 1e-3
# the seed baseline reads and folds every slot of T whatever the lengths:
# its time at lengths 1 over its time at full lengths must reach this
SEED_LEN1_MIN = 0.8


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


_FLUSH = []


# cycles the card spins after the L2 flush, about 0.1 ms: the host enqueues
# the timed call meanwhile, so the events time the card's work and not the
# wrapper's Python (which takes up to ~0.1 ms a call); a call of two
# wrappers (the per-channel pair) spins four times as long
SPIN_CYCLES = 200_000
PAIR_SPIN = 4 * SPIN_CYCLES


def time_cold_ms(fn, iters: int, warmup: int = 1,
                 spin: int = SPIN_CYCLES, clean: bool = False) -> float:
    """Mean ms of ``fn`` with the 50 MB L2 cache evicted (a 256 MB write,
    which leaves the L2 full of dirty lines: a cold read pays their
    write-back; ``clean``: a 256 MB read, which leaves clean lines) before
    each launch; CUDA events bracket ``fn`` alone, and a spin of ``spin``
    cycles on the card after the flush keeps the host's enqueue off the
    clock."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.float32,
                                  device="cuda"))
    pairs = []
    for i in range(warmup + iters):
        if clean:
            _FLUSH[0].sum()
        else:
            _FLUSH[0].zero_()
        torch.cuda._sleep(spin)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        if i >= warmup:
            pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound_of(nbytes: float, flops: float = 0.0,
             flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """(least ms at 3.35 TB/s and ``flop_rate`` (float32: 67 TFLOP/s),
    what bounds it)."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def same_bits(a, b) -> bool:
    import torch
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def same_bits_nan(a, b) -> bool:
    """NaN at the same positions, every other bit equal."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return same_bits(a, b)
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan)) and same_bits(a[~nan],
                                                                b[~nan])


def excess(got, want, atol=ATOL, rtol=RTOL) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 passes."""
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


# -- inputs -----------------------------------------------------------------

def make_pool(kv_dtype, n_pages, Hkv, D, ps, gen, dev):
    """A pool of random quantized pages (page 0 the sentinel)."""
    import torch
    from repro_torch.core import quantization as Q
    x = torch.randn((2, Hkv, n_pages * ps, D), generator=gen, device=dev)
    q, s = Q.quantize_pages(x, ps, kv_dtype)    # (2, Hkv, P*ps_eff, D)
    ps_eff = q.shape[2] // n_pages
    pages = q.reshape(2, Hkv, n_pages, ps_eff, D).permute(0, 2, 3, 1, 4)
    scales = s.permute(0, 2, 1, 3)              # (2, P, Hkv, D)
    return (pages[0].contiguous(), scales[0].contiguous(),
            pages[1].contiguous(), scales[1].contiguous())


def page_table(B, NT, n_pages, gen, dev):
    import torch
    perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
    return perm[:B * NT].reshape(B, NT).to(torch.int32).contiguous()


def kv_bytes(tokens: int, Hkv: int, D: int, kv_dtype: str) -> float:
    per = 0.5 if kv_dtype == "int4" else 1.0
    return 2 * tokens * Hkv * D * per


def dequant_bf16(pool, table, kv_dtype):
    """(B, Hkv, NT*ps, D) bf16 K and V gathered through the table: the
    library yardstick's input."""
    from repro_torch.kernels.quant_attention import page_dequant
    kq, ks, vq, vs = pool
    tbl = table.long()
    B, NT = table.shape

    def deq(q, s):
        x = page_dequant(q[tbl], s[tbl], kv_dtype)    # (B, NT, ps, Hkv, D)
        return x.reshape(B, -1, x.shape[-2], x.shape[-1]).permute(
            0, 2, 1, 3).bfloat16().contiguous()
    return deq(kq, ks), deq(vq, vs)


# -- phase 2: kernels against their plain versions ---------------------------

def check_decode(dev, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_attention as QA
    B, H, Hkv, D, ps, NT = 5, 16, 8, 128, 256, 8
    lengths = torch.tensor([0, 1, 255, 256, 2048], dtype=torch.int32,
                           device=dev)
    tB, t_len = 4, [2048, 1536, 1024, 512]      # timing: 4 rows deep in decode
    out = {"per_dtype": []}
    for kv_dtype in DTYPES:
        n_pages = B * NT + 1
        pool = make_pool(kv_dtype, n_pages, Hkv, D, ps, gen, dev)
        table = page_table(B, NT, n_pages, gen, dev)
        q = torch.randn((B, H, D), generator=gen, device=dev)
        args = (q, *pool, table, lengths, kv_dtype)
        got = QA.paged_decode_partials_cuda(*args)
        torch.cuda.synchronize()
        want = QA.paged_decode_partials_plain(*args)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ex = max(excess(g, w) for g, w in zip(got, want))
        if ex > 1.0 or not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"paged decode {kv_dtype}: kernel vs plain "
                                 f"off by {err:.3e} ({ex:.2f}x tolerance)")
        # timing at the main path's decode shape
        tl = torch.tensor(t_len, dtype=torch.int32, device=dev)
        tq, ttab = q[:tB].contiguous(), table[:tB].contiguous()
        targs = (tq, *pool, ttab, tl, kv_dtype)
        # the serving call adds no host sync: it must run with any sync an
        # error (the split count comes from shapes, never from lengths)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.paged_attention_decode_partials(tq, *pool, ttab, tl,
                                                kv_dtype=kv_dtype)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ms = time_cold_ms(lambda: QA.paged_decode_partials_cuda(*targs), 50)
        plain_ms = time_cold_ms(
            lambda: QA.paged_decode_partials_plain(*targs), 5)
        live = sum(t_len)
        pages = sum(-(-t // ps) for t in t_len)
        nbytes = (kv_bytes(live, Hkv, D, kv_dtype) + 2 * pages * Hkv * D * 4
                  + pages * 4 + tB * 4 + tB * H * D * 4 * 2 + tB * H * 8)
        flops = 4 * D * H * live
        bound = max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S) * 1e3
        k, v = dequant_bf16(pool, ttab, kv_dtype)
        mask = (torch.arange(k.shape[2], device=dev)[None]
                < tl[:, None])[:, None, None, :]
        qb = tq.bfloat16()[:, :, None]
        lib_ms = time_cold_ms(lambda: F.scaled_dot_product_attention(
            qb, k, v, attn_mask=mask, enable_gqa=True), 50)
        row = {"dtype": kv_dtype, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
               >= flops / F32_FLOP_PER_S else "operations",
               "library_ms": lib_ms, "gb_per_s": nbytes / ms / 1e6}
        out["per_dtype"].append(row)
        log(f"[decode] {kv_dtype}: max_abs_err {err:.3e} (tol {ATOL:g} + "
            f"{RTOL:g}|ref|, {ex:.3f}x) kernel {ms:.4f} ms "
            f"({row['gb_per_s']:.0f} GB/s of 3350) plain "
            f"{plain_ms:.4f} ms sdpa(bf16) {lib_ms:.4f} ms bound "
            f"{bound:.5f} ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB at "
            f"3.35 TB/s, {flops / 1e9:.3f} GFLOP at 67 TFLOP/s f32); "
            f"no host sync under set_sync_debug_mode('error')")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = {b: QA.decode_splits(b, Hkv, H // Hkv, NT, sms) for b in (B, tB)}
    log(f"[decode] (splits, pages a split) on {sms} SMs: checked batch {B} "
        f"{splits[B]}, timed batch {tB} {splits[tB]}")
    out["check_shapes"] = (f"q ({B},{H},{D}) f32; pool ({B * NT + 1},ps_packed,"
                           f"{Hkv},{D}); page_table ({B},{NT}); lengths "
                           f"{lengths.tolist()}; (splits, pages a split) "
                           f"{splits[B]}")
    out["timed_shapes"] = (f"q ({tB},{H},{D}); page {ps}; lengths {t_len}; "
                           f"(splits, pages a split) {splits[tB]}")
    return out


def check_prefill(dev, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quant_prefill as QP
    B, H, Hkv, D, ps, NT = 4, 16, 8, 128, 256, 8
    G = H // Hkv
    dispatches = [  # (C, hist_len, valid): a full chunk and a partial one
        (1024, [0, 256, 1024, 1792], [1024, 511, 1, 1024]),
        (512, [1792, 0, 256, 1024], [511, 512, 1, 300])]
    out = {"per_dtype": []}
    for kv_dtype in DTYPES:
        n_pages = B * NT + 1
        pool = make_pool(kv_dtype, n_pages, Hkv, D, ps, gen, dev)
        table = page_table(B, NT, n_pages, gen, dev)
        row = {"dtype": kv_dtype, "max_abs_err": 0.0, "worst_tol_ratio": 0.0}
        for di, (C, hl, vd) in enumerate(dispatches):
            hist = torch.tensor(hl, dtype=torch.int32, device=dev)
            valid = torch.tensor(vd, dtype=torch.int32, device=dev)
            hb = 1 << (-(-max(hl) // ps) - 1).bit_length()
            q = torch.randn((B, H, C, D), generator=gen, device=dev)
            k = torch.randn((B, Hkv, C, D), generator=gen, device=dev)
            v = torch.randn((B, Hkv, C, D), generator=gen, device=dev)
            qg = (q.reshape(B, Hkv, G * C, D) * QA.logit_scale(D)
                  ).contiguous()
            args = (qg, k, v, *pool, table, hist, valid, hb, kv_dtype)
            got = QP.paged_prefill_cuda(*args)
            torch.cuda.synchronize()
            want = QP.paged_prefill_plain(*args)
            got4 = got.reshape(B, H, C, D)
            want4 = want.reshape(B, H, C, D)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"paged prefill {kv_dtype} C={C}: a "
                                     f"non-finite output")
            for b in range(B):               # the caller drops rows past valid
                g, w = got4[b, :, :vd[b]], want4[b, :, :vd[b]]
                err = float((g - w).abs().max())
                ex = excess(g, w)
                if ex > 1.0:
                    raise AssertionError(
                        f"paged prefill {kv_dtype} C={C} row {b}: kernel vs "
                        f"plain off by {err:.3e} ({ex:.2f}x tolerance)")
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["worst_tol_ratio"] = max(row["worst_tol_ratio"], ex)
                dead = -(-vd[b] // PREFILL_ROWS) * PREFILL_ROWS
                if dead < C and float(got4[b, :, dead:].abs().max()):
                    raise AssertionError(
                        f"paged prefill {kv_dtype} C={C} row {b}: a row tile "
                        f"past valid={vd[b]} is not 0.0")
            if di:
                continue
            # timing at the full chunk: the main path's dispatch shape
            ms = time_cold_ms(lambda: QP.paged_prefill_cuda(*args), 10)
            plain_ms = time_cold_ms(lambda: QP.paged_prefill_plain(*args),
                                    3, 1)
            flops = hflops = nbytes = 0.0
            pages = 0
            for b in range(B):
                n = vd[b]                    # rows that matter: qpos < valid
                flops += 4 * D * H * (n * hl[b] + n * (n + 1) // 2)
                hflops += 4 * D * H * n * hl[b]
                pages += -(-hl[b] // ps)
                nbytes += kv_bytes(hl[b], Hkv, D, kv_dtype)
            nbytes += (q.numel() + k.numel() + v.numel()) * 4 \
                + 2 * pages * Hkv * D * 4 + pages * 4 + B * 8 \
                + q.numel() * 4
            bound = max(nbytes / HBM_BYTES_PER_S,
                        flops / F32_FLOP_PER_S) * 1e3
            # the kernel's own design: bf16 tensor-core products, 3 a
            # history (row, key) pair, 6 a chunk pair, for Q.K and P.V each
            tc_flops = 3 * hflops + 6 * (flops - hflops)
            bound_tc = max(nbytes / HBM_BYTES_PER_S,
                           tc_flops / BF16_FLOP_PER_S) * 1e3
            kh, vh = dequant_bf16(pool, table[:, :hb], kv_dtype)
            kall = torch.cat([kh, k.bfloat16()], dim=2)
            vall = torch.cat([vh, v.bfloat16()], dim=2)
            T = kh.shape[2]
            qpos = torch.arange(C, device=dev)
            hmask = torch.arange(T, device=dev)[None] < hist[:, None]
            cmask = (qpos[None, :] <= qpos[:, None])[None] & \
                (qpos[None, None, :] < valid[:, None, None])
            mask = torch.cat([hmask[:, None, :].expand(B, C, T), cmask],
                             dim=-1)[:, None]
            qb = q.bfloat16()
            lib_ms = time_cold_ms(lambda: F.scaled_dot_product_attention(
                qb, kall, vall, attn_mask=mask, enable_gqa=True), 10)
            row.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / F32_FLOP_PER_S else "operations",
                        "library_ms": lib_ms, "bound_tc_ms": bound_tc,
                        "tflop_per_s": flops / ms / 1e9})
            log(f"[prefill] {kv_dtype} C={C}: kernel {ms:.4f} ms "
                f"({row['tflop_per_s']:.1f} TFLOP/s of the counted float32 "
                f"work) plain {plain_ms:.4f} ms sdpa(bf16) {lib_ms:.4f} ms "
                f"bound {bound:.5f} ms ({row['bound_by']}: "
                f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s f32, "
                f"{nbytes / 1e6:.1f} MB at 3.35 TB/s); the design's bound "
                f"{bound_tc:.5f} ms ({tc_flops / 1e9:.2f} GFLOP of split "
                f"bf16 products at 989 TFLOP/s)")
        log(f"[prefill] {kv_dtype}: max_abs_err {row['max_abs_err']:.3e} "
            f"over both dispatches (tol {ATOL:g} + {RTOL:g}|ref|, worst "
            f"{row['worst_tol_ratio']:.3f}x); every output finite, row "
            f"tiles past valid 0.0")
        out["per_dtype"].append(row)
    out["check_shapes"] = "; ".join(
        f"C={C} q ({B},{H},{C},{D}) hist_len {hl} valid {vd}"
        for C, hl, vd in dispatches)
    out["timed_shapes"] = (f"C=1024 q ({B},{H},1024,{D}) hist_len "
                           f"{dispatches[0][1]} valid {dispatches[0][2]}, "
                           f"hist_blocks 8, page {ps}")
    # ops-level dispatch on CUDA tensors must reach the kernel
    before = QP.paged_prefill_cuda.launches
    ops.paged_attention_prefill(q, k, v, *pool, table, hist, valid,
                                hist_blocks=hb, kv_dtype=kv_dtype)
    if QP.paged_prefill_cuda.launches != before + 1:
        raise AssertionError("ops.paged_attention_prefill did not launch "
                             "the kernel for CUDA tensors")
    return out



def _flat_quant(mode, k, v, bs):
    """The cache's int8 K/V and scale rows: per block, or one per channel."""
    from repro_torch.kernels import quantize as QK
    if mode == "per_block":
        (kq, ks), (vq, vs) = (QK.quantize_blocked_plain(x, bs) for x in (k, v))
        return kq, ks, vq, vs
    (kq, ks), (vq, vs) = (QK.quantize_per_channel_plain(x) for x in (k, v))
    return kq, ks[:, :, None].contiguous(), vq, vs[:, :, None].contiguous()


def _flat_check(label, args, kernel=None):
    """A contiguous decode kernel (default: flat decode) against the plain
    version on ``args``: (max |err|, multiple of the tolerance); an empty
    row must give o = 0, m = -1e30, l = 0 exactly."""
    import torch
    from repro_torch.kernels import quant_attention as QA
    got = (kernel or QA.flat_decode_partials_cuda)(*args)
    torch.cuda.synchronize()
    want = QA.flat_decode_partials_plain(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ex = max(excess(g, w) for g, w in zip(got, want))
    if ex > 1.0 or not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"{label}: kernel vs plain off by {err:.3e} "
                             f"({ex:.2f}x tolerance)")
    o, m, l = got
    empty = args[5] == 0
    if bool(empty.any()) and (float(o[empty].abs().max()) or float(
            l[empty].max()) or bool((m[empty] != -1e30).any())):
        raise AssertionError(f"{label}: an empty row must give o = 0, "
                             f"m = -1e30, l = 0")
    return err, ex


def check_flat_decode(dev, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quantize as QK
    B, H, Hkv, D, T, bs = 4, 16, 8, 128, 2048, 256
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    lengths, windows = i32([2048, 1280, 0, 3000]), i32([T, T, T, 1024])
    k = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    # per channel, the generate path's cache: T = 1032 (max_len rounded to
    # 8) is no multiple of the 64-token tile, so every live row ends in a
    # partial tile
    Tp = 1032
    lp, wp = i32([1032, 1000, 1017, 0]), i32([Tp] * B)
    kp = torch.randn((B, Hkv, Tp, D), generator=gen, device=dev)
    vp = torch.randn((B, Hkv, Tp, D), generator=gen, device=dev)
    full = i32([T] * B)                  # timing: every row at length T
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = {t: QA.flat_decode_splits(B, Hkv, H // Hkv, t, sms)
              for t in (T, Tp)}
    out = {"per_mode": []}
    for mode in ("per_block", "per_channel"):
        kq, ks, vq, vs = _flat_quant(mode, k, v, bs)
        err, ex = _flat_check(f"flat decode {mode}",
                              (q, kq, ks, vq, vs, lengths, windows))
        if mode == "per_channel":
            e2, x2 = _flat_check(f"flat decode {mode} T={Tp}", (
                q, *_flat_quant(mode, kp, vp, bs), lp, wp))
            err, ex = max(err, e2), max(ex, x2)
        targs = (q, kq, ks, vq, vs, full, full)
        # the serving call adds no host sync: it must run with any sync an
        # error (the split count comes from shapes, never from lengths)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.quant_attention_decode_partials(q, kq, ks, vq, vs, full,
                                                window=full)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ms = time_cold_ms(lambda: QA.flat_decode_partials_cuda(*targs), 50)
        plain_ms = time_cold_ms(lambda: QA.flat_decode_partials_plain(*targs),
                                5)
        nb, live = ks.shape[2], B * T
        nbytes = (2 * live * Hkv * D + 2 * B * Hkv * nb * D * 4
                  + 2 * B * H * D * 4 + 2 * B * H * 4 + 2 * B * 4)
        flops = 4 * D * H * live
        bound, by = bound_of(nbytes, flops)
        kb = QK.dequantize_plain(kq, ks, torch.bfloat16)
        vb = QK.dequantize_plain(vq, vs, torch.bfloat16)
        qb = q.bfloat16()[:, :, None]
        lib_ms = time_cold_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, enable_gqa=True), 50)
        row = {"mode": mode, "max_abs_err": err, "worst_tol_ratio": ex,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": by, "library_ms": lib_ms,
               "gb_per_s": nbytes / ms / 1e6}
        out["per_mode"].append(row)
        log(f"[flat_decode] {mode}: max_abs_err {err:.3e} (tol {ATOL:g} + "
            f"{RTOL:g}|ref|, worst {ex:.3f}x) kernel {ms:.4f} ms "
            f"({row['gb_per_s']:.0f} GB/s of 3350) plain {plain_ms:.4f} ms "
            f"sdpa(bf16) {lib_ms:.4f} ms bound {bound:.5f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB at 3.35 TB/s, {flops / 1e9:.3f} GFLOP "
            f"at 67 TFLOP/s f32); no host sync under "
            f"set_sync_debug_mode('error')")
    log(f"[flat_decode] (splits, slots a split) on {sms} SMs: timed T {T} "
        f"{splits[T]}, T {Tp} {splits[Tp]}")
    out["check_shapes"] = (f"q ({B},{H},{D}) f32; k/v ({B},{Hkv},{T},{D}) "
                           f"int8, block {bs} or per channel; lengths "
                           f"{lengths.tolist()} windows {windows.tolist()}; "
                           f"per channel also k/v ({B},{Hkv},{Tp},{D}) "
                           f"lengths {lp.tolist()}")
    out["timed_shapes"] = (f"k/v ({B},{Hkv},{T},{D}), lengths {[T] * B}; "
                           f"L2 flushed; (splits, slots a split) "
                           f"{splits[T]}")
    return out


def check_seed_decode(dev, gen):
    """The seed baseline at the contiguous engine's decode shape, per block
    and per channel, mixed lengths (one empty, one ring row in a window;
    per channel also the generate path's T = 1032 with a row of length 1,
    whose later splits are wholly dead); timed at full length as flat
    decode is (the same bytes), and at lengths 1, where it must still take
    at least SEED_LEN1_MIN of that time: it reads and folds every slot."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quantize as QK
    B, H, Hkv, D, T, bs = 4, 16, 8, 128, 2048, 256
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    lengths, windows = i32([1500, 300, 0, 3000]), i32([T, T, T, 1024])
    k = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    Tp = 1032
    lp, wp = i32([1032, 1, 700, 0]), i32([Tp, Tp, 100, Tp])
    kp = torch.randn((B, Hkv, Tp, D), generator=gen, device=dev)
    vp = torch.randn((B, Hkv, Tp, D), generator=gen, device=dev)
    full, ones = i32([T] * B), i32([1] * B)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = {t: QA.flat_decode_splits(B, Hkv, H // Hkv, t, sms)
              for t in (T, Tp)}
    out = {"per_mode": []}
    for mode in ("per_block", "per_channel"):
        kq, ks, vq, vs = _flat_quant(mode, k, v, bs)
        err, ex = _flat_check(f"seed decode {mode}",
                              (q, kq, ks, vq, vs, lengths, windows),
                              QA.seed_decode_partials_cuda)
        if mode == "per_channel":
            e2, x2 = _flat_check(f"seed decode {mode} T={Tp}", (
                q, *_flat_quant(mode, kp, vp, bs), lp, wp),
                QA.seed_decode_partials_cuda)
            err, ex = max(err, e2), max(ex, x2)
        # the baseline's entry adds no host sync either (splits from shapes)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.quant_attention_decode_partials_vmap(q, kq, ks, vq, vs, full,
                                                     window=full)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        targs = (q, kq, ks, vq, vs, full, full)
        ms = time_cold_ms(lambda: QA.seed_decode_partials_cuda(*targs), 50)
        ms1 = time_cold_ms(lambda: QA.seed_decode_partials_cuda(
            q, kq, ks, vq, vs, ones, full), 50)
        if ms1 < SEED_LEN1_MIN * ms:
            raise AssertionError(f"seed decode {mode}: {ms1:.4f} ms at "
                                 f"lengths 1 < {SEED_LEN1_MIN} x {ms:.4f} ms "
                                 f"at full lengths: it must read every slot")
        plain_ms = time_cold_ms(lambda: QA.flat_decode_partials_plain(*targs),
                                5)
        nb = ks.shape[2]
        nbytes = (2 * B * T * Hkv * D + 2 * B * Hkv * nb * D * 4
                  + 2 * B * H * D * 4 + 2 * B * H * 4 + 2 * B * 4)
        flops = 4 * D * H * B * T
        bound, by = bound_of(nbytes, flops)
        kb = QK.dequantize_plain(kq, ks, torch.bfloat16)
        vb = QK.dequantize_plain(vq, vs, torch.bfloat16)
        qb = q.bfloat16()[:, :, None]
        lib_ms = time_cold_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, enable_gqa=True), 50)
        row = {"mode": mode, "max_abs_err": err, "worst_tol_ratio": ex,
               "ms": ms, "ms_lengths_1": ms1, "lengths_1_over_full": ms1 / ms,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": lib_ms, "gb_per_s": nbytes / ms / 1e6}
        out["per_mode"].append(row)
        log(f"[seed_decode] {mode}: max_abs_err {err:.3e} (tol {ATOL:g} + "
            f"{RTOL:g}|ref|, worst {ex:.3f}x) kernel {ms:.4f} ms "
            f"({row['gb_per_s']:.0f} GB/s of 3350), at lengths 1 {ms1:.4f} ms "
            f"({ms1 / ms:.3f}x full, >= {SEED_LEN1_MIN}) plain {plain_ms:.4f} "
            f"ms sdpa(bf16) {lib_ms:.4f} ms bound {bound:.5f} ms ({by}: "
            f"{nbytes / 1e6:.2f} MB at 3.35 TB/s); no host sync under "
            f"set_sync_debug_mode('error')")
    log(f"[seed_decode] (splits, slots a split) on {sms} SMs: timed T {T} "
        f"{splits[T]}, T {Tp} {splits[Tp]}")
    out["check_shapes"] = (f"q ({B},{H},{D}) f32; k/v ({B},{Hkv},{T},{D}) "
                           f"int8, block {bs} or per channel; lengths "
                           f"{lengths.tolist()} windows {windows.tolist()}; "
                           f"per channel also k/v ({B},{Hkv},{Tp},{D}) "
                           f"lengths {lp.tolist()} windows {wp.tolist()}")
    out["timed_shapes"] = (f"k/v ({B},{Hkv},{T},{D}), lengths {[T] * B} "
                           f"and {[1] * B}; L2 flushed; (splits, slots a "
                           f"split) {splits[T]}")
    return out


def _flash_inputs(B, H, Hkv, S, T, D, dtype, gen, dev):
    import torch
    mk = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)
    return mk(B, H, S, D), mk(B, Hkv, T, D), mk(B, Hkv, T, D)


def check_flash(dev, gen):
    """The flash forward kernel against its plain version: bf16 at the
    training shape (4, 16, 2048, 128) causal and at the contiguous
    prefill's rebuild (4, 16, 1536, 128); a window with kv_offset; an odd S
    in float32. Timed at the training shape beside SDPA on the same bf16
    q/k/v (the port never calls SDPA)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_fwd as FF
    cases = [  # label, (B, H, Hkv, S, T, D), dtype, causal, window, offset
        ("train", (4, 16, 8, 2048, 2048, 128), torch.bfloat16, True, None, 0),
        ("prefill 1536", (4, 16, 8, 1536, 1536, 128), torch.bfloat16, True,
         None, 0),
        ("window+offset", (2, 16, 8, 300, 812, 128), torch.bfloat16, True,
         256, 512),
        ("odd S f32", (2, 16, 8, 999, 999, 128), torch.float32, True, None,
         0),
    ]
    worst = {"max_abs_err": 0.0}
    for label, shape, dt, causal, window, off in cases:
        q, k, v = _flash_inputs(*shape, dt, gen, dev)
        got = FF.flash_fwd_cuda(q, k, v, causal, window, off)
        torch.cuda.synchronize()
        want = FF.flash_fwd_plain(q, k, v, causal, window, off, FLASH_TILE)
        atol, rtol = ((ATOL_BF16, RTOL_BF16) if dt == torch.bfloat16
                      else (ATOL, RTOL))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ex = max(excess(got[0], want[0], atol, rtol),
                 *(excess(g, w) for g, w in zip(got[1:], want[1:])))
        if ex > 1.0 or not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"flash forward {label}: kernel vs plain "
                                 f"off by {err:.3e} ({ex:.2f}x tolerance)")
        worst["max_abs_err"] = max(worst["max_abs_err"], err)
        log(f"[flash_fwd] {label} {shape} {str(dt)[6:]}: max_abs_err "
            f"{err:.3e} (out: tol {atol:g} + {rtol:g}|ref|; m, l: {ATOL:g} + "
            f"{RTOL:g}|ref|; {ex:.3f}x)")
        if label != "train":
            continue
        B, H, Hkv, S, T, D = shape
        ms = time_cold_ms(lambda: FF.flash_fwd_cuda(q, k, v), 10)
        plain_ms = time_cold_ms(lambda: FF.flash_fwd_plain(q, k, v), 3)
        lib_ms = time_cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 10)
        flops = 4 * D * H * B * S * (S + 1) // 2      # live (query, key) pairs
        nbytes = (q.numel() + k.numel() + v.numel()) * 2 + B * H * S * D * 4 \
            + 2 * B * H * S * 4
        bound, by = bound_of(nbytes, flops, BF16_FLOP_PER_S)
        worst.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": lib_ms,
                      "tflop_per_s": flops / ms / 1e9})
        log(f"[flash_fwd] train: kernel {ms:.4f} ms "
            f"({worst['tflop_per_s']:.1f} TFLOP/s of 989 bf16) plain "
            f"{plain_ms:.4f} ms sdpa(bf16) {lib_ms:.4f} ms "
            f"({flops / lib_ms / 1e9:.1f} TFLOP/s) bound {bound:.5f} ms "
            f"({by}: {flops / 1e9:.2f} GFLOP at 989 TFLOP/s bf16, "
            f"{nbytes / 1e6:.1f} MB at 3.35 TB/s)")
    worst["check_shapes"] = "; ".join(
        f"{label} (B,H,Hkv,S,T,D)={shape} {str(dt)[6:]} causal={c} "
        f"window={w} kv_offset={o}" for label, shape, dt, c, w, o in cases)
    worst["timed_shapes"] = "q (4,16,2048,128), k/v (4,8,2048,128) bf16 causal"
    return worst


def sass_mma_counts(lib: str) -> dict:
    """Tensor-core instructions (HMMA / HGMMA) in a built library's SASS
    (cuobjdump from the CUDA toolkit), by kernel function (mangled name)."""
    import os
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = line.split("Function :")[1].strip()
            counts[key] = 0
        elif key and ("HMMA" in line or "HGMMA" in line):
            counts[key] += 1
    return counts


def flash_mma_count() -> dict:
    """HMMA / HGMMA instructions in the flash library's two kernels: the
    bf16 kernel must have some, the float32 kernel none."""
    counts = {"bf16 (flash_fwd_tc_kernel)": 0, "float32 (flash_fwd_kernel)": 0}
    for fn, n in sass_mma_counts("flash_fwd").items():
        key = ("bf16 (flash_fwd_tc_kernel)" if "flash_fwd_tc_kernel" in fn
               else "float32 (flash_fwd_kernel)"
               if "flash_fwd_kernel" in fn else None)
        if key:
            counts[key] += n
    if not counts["bf16 (flash_fwd_tc_kernel)"]:
        raise AssertionError(f"no HMMA/HGMMA in the bf16 flash kernel: {counts}")
    return counts


def prefill_mma_count() -> dict:
    """HMMA / HGMMA instructions in each paged prefill kernel (one per head
    width and page format): every one must have some."""
    counts = {fn: n for fn, n in sass_mma_counts("paged_prefill").items()
              if "paged_prefill_kernel" in fn}
    if not counts or not all(counts.values()):
        raise AssertionError(f"a paged prefill kernel has no HMMA/HGMMA: "
                             f"{counts}")
    return counts


def _time_rows(specs: dict, iters: int, plain_iters: int,
               clean: bool = False) -> dict:
    """Each (kernel, plain, bytes, operations, library call or None, its
    name) of ``specs`` timed with the L2 flushed beside its bound (with
    ``clean``, the kernel also after a flush that leaves clean lines:
    "ms_clean_l2"); "pair" (two wrappers back to back) with the longer
    spin."""
    rows = {}
    for name, (kern, plain, nbytes, flops, lib, lib_name) in specs.items():
        bound, by = bound_of(nbytes, flops)
        spin = PAIR_SPIN if name == "pair" else SPIN_CYCLES
        rows[name] = {
            "ms": time_cold_ms(kern, iters, spin=spin),
            **({"ms_clean_l2": time_cold_ms(kern, iters, spin=spin,
                                            clean=True)} if clean else {}),
            "plain_ms": time_cold_ms(plain, plain_iters),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_cold_ms(lib, iters) if lib else None,
            "library": lib_name, "bytes": nbytes}
    return rows


def per_channel_rows(x, iters: int, plain_iters: int) -> dict:
    """The per-channel pair on float32 x (..., T, D): each kernel bitwise
    against its plain version, then each and the two back to back
    (`quantize_per_channel_cuda`, bound: the sum of theirs) timed
    (`_time_rows`, also after a flush that leaves the L2 clean). Launches
    here are comparisons, not the main path."""
    import torch
    from repro_torch.kernels import quantize as QK
    T, D = x.shape[-2:]
    n = x.numel()
    N = n // (T * D)
    am = QK.absmax_cuda(x)
    q, s = QK.quantize_with_scales_cuda(x, am)
    torch.cuda.synchronize()
    if not (same_bits(am, QK.absmax_plain(x)) and all(
            same_bits(g, w) for g, w in zip(
                (q, s), QK.quantize_with_scales_plain(x, am)))):
        raise AssertionError(f"per-channel pair at {tuple(x.shape)}: kernel "
                             f"and plain version differ (must be bitwise)")
    a_bytes, q_bytes = 4 * n + 4 * N * D, 5 * n + 8 * N * D
    return _time_rows({
        "absmax": (lambda: QK.absmax_cuda(x), lambda: QK.absmax_plain(x),
                   a_bytes, 2 * n,
                   lambda: torch.linalg.vector_norm(x, float("inf"), dim=-2),
                   "torch.linalg.vector_norm(x, inf, dim=-2)"),
        "quantize_with_scales": (
            lambda: QK.quantize_with_scales_cuda(x, am),
            lambda: QK.quantize_with_scales_plain(x, am), q_bytes, 4 * n, None,
            "none: no single PyTorch call rounds x / s half to even into "
            "symmetric +-127 int8 (torch.quantize_per_channel adds a zero "
            "point and clamps to [-128, 127])"),
        "pair": (lambda: QK.quantize_per_channel_cuda(x),
                 lambda: QK.quantize_per_channel_plain(x), a_bytes + q_bytes,
                 6 * n, None, "none")}, iters, plain_iters, clean=True)


def quantize_family(x, bs: int, iters: int, plain_iters: int) -> dict:
    """The four quantize kernels on float32 x (..., T, D), and the
    per-channel pair back to back: each bitwise against its plain version,
    then timed with the L2 flushed (kernel, plain version, one PyTorch call
    where one computes the same function) beside its bound. Launches here
    are comparisons, not the main path."""
    import torch
    from repro_torch.kernels import quantize as QK
    T, D = x.shape[-2:]
    n = x.numel()
    N, nb = n // (T * D), T // bs
    rows = per_channel_rows(x, iters, plain_iters)
    bq, bsc = QK.quantize_blocked_cuda(x, bs)
    deq = QK.dequantize_cuda(bq, bsc)
    deq16 = QK.dequantize_cuda(bq, bsc, torch.bfloat16)
    torch.cuda.synchronize()
    for name, got, want in (
            ("quantize_blocked", (bq, bsc), QK.quantize_blocked_plain(x, bs)),
            ("dequantize", (deq, deq16),
             (QK.dequantize_plain(bq, bsc),
              QK.dequantize_plain(bq, bsc, torch.bfloat16)))):
        if not all(same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} at {tuple(x.shape)}: kernel and "
                                 f"plain version differ (must be bitwise)")
    rows.update(_time_rows({
        "quantize_blocked": (
            lambda: QK.quantize_blocked_cuda(x, bs),
            lambda: QK.quantize_blocked_plain(x, bs),
            4 * n + n + 4 * N * nb * D, 6 * n, None,
            "none: no single PyTorch call computes per-(block, channel) "
            "scales and the int8 values together"),
        "dequantize": (
            lambda: QK.dequantize_cuda(bq, bsc),
            lambda: QK.dequantize_plain(bq, bsc),
            n + 4 * N * nb * D + 4 * n, n,
            lambda: torch.mul(bq.view(N, nb, bs, D), bsc.view(N, nb, 1, D)),
            "torch.mul(int8 values, float32 scale rows) -> float32")},
        iters, plain_iters))
    return rows


def with_nan_inf(x):
    """x with a NaN in channel 5, +inf in 6, -inf in 7, NaN and inf in 8
    (one row each, of every matrix)."""
    x = x.clone()
    x[..., 1, 5] = float("nan")
    x[..., -1, 6] = float("inf")
    x[..., 0, 7] = float("-inf")
    x[..., 0, 8] = float("nan")
    x[..., -1, 8] = float("inf")
    return x


def check_nan_inf(x, bs: int) -> str:
    """The three quantize kernels on x with NaN and inf channels against
    their plain versions (NaN at the same positions, every other bit
    equal), and the reference's answer on the card: NaN / inf scales,
    int8 0 for every value of those channels."""
    import torch
    from repro_torch.kernels import quantize as QK
    x = with_nan_inf(x)
    am = QK.absmax_cuda(x)
    q, s = QK.quantize_with_scales_cuda(x, am)
    bq, bsc = QK.quantize_blocked_cuda(x, bs)
    torch.cuda.synchronize()
    pam = QK.absmax_plain(x)
    pq, ps = QK.quantize_with_scales_plain(x, pam)
    pbq, pbs = QK.quantize_blocked_plain(x, bs)
    for name, got, want in (("absmax", (am,), (pam,)),
                            ("quantize_with_scales", (q, s), (pq, ps)),
                            ("quantize_blocked", (bq, bsc), (pbq, pbs))):
        if not all(same_bits_nan(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} at {tuple(x.shape)} with NaN/inf "
                                 f"channels: kernel and plain version differ")
    if not (bool(torch.isnan(ps[..., [5, 8]]).all())
            and bool(torch.isinf(ps[..., [6, 7]]).all())
            and not bool(pq[..., 5:9].any())):
        raise AssertionError("per-channel plain version on the card: NaN/inf "
                             "channels not NaN/inf scales with int8 0")
    return (f"{tuple(x.shape)}: channels with NaN / +inf / -inf / both, "
            f"NaN positions equal and every other bit, int8 0 there")


def check_quantize(dev, gen):
    import torch
    from repro_torch.kernels import quantize as QK
    shape, bs = (4, 8, 2048, 128), 256
    x = torch.rand(shape, generator=gen, device=dev) * 2 - 1
    x[..., 2] = 0.0                                 # an all-zero channel
    x[..., 3] *= 1e-29                              # absmax 1e-29 < 127e-30
    x[..., 0, 3] = 1e-29
    rows = quantize_family(x, bs, 50, 5)
    # the other shapes the main paths give the family, bitwise: the per
    # channel prefill of 1000 tokens (no multiple of the kernels' row
    # blocks) with its one scale row, and a block flush, which quantizes
    # the (4, 8, 256, 128) bf16 residual as float32
    xp = torch.rand((4, 8, 1000, 128), generator=gen, device=dev) * 2 - 1
    xf = (torch.rand((4, 8, bs, 128), generator=gen, device=dev) * 2 - 1
          ).bfloat16().float()
    am = QK.absmax_cuda(xp)
    q, s = QK.quantize_with_scales_cuda(xp, am)
    fq, fs = QK.quantize_blocked_cuda(xf, bs)
    deq = QK.dequantize_cuda(q, s[..., None, :])
    torch.cuda.synchronize()
    for name, got, want in (
            ("absmax", (am,), (QK.absmax_plain(xp),)),
            ("quantize_with_scales", (q, s),
             QK.quantize_with_scales_plain(xp, am)),
            ("quantize_blocked", (fq, fs), QK.quantize_blocked_plain(xf, bs)),
            ("dequantize", (deq,), (QK.dequantize_plain(q, s[..., None, :]),))):
        if not all(same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} at the main path's shape: kernel "
                                 f"and plain version differ (must be bitwise)")
    log(f"[quantize] bitwise also at {tuple(xp.shape)} (absmax, quantize "
        f"with scales, dequantize of one scale row) and {tuple(xf.shape)} "
        f"(quantize blocked: a block flush)")
    nan_inf = [check_nan_inf(x, bs), check_nan_inf(xp, 8)]
    log(f"[quantize] NaN and inf as the reference: {'; '.join(nan_inf)}")
    # the harness's fixed cost: an empty launch (a spin of 0 cycles)
    floor = time_cold_ms(lambda: torch.cuda._sleep(0), 100)
    floor_clean = time_cold_ms(lambda: torch.cuda._sleep(0), 100, clean=True)
    log(f"[quantize] empty launch, timed as every kernel here: {floor:.5f} "
        f"ms (L2 left clean: {floor_clean:.5f}; the floor under any kernel "
        f"time)")
    generate = per_channel_rows(xp, 50, 5)
    for name, r in generate.items():
        log(f"[quantize] {name} {tuple(xp.shape)} (the generate prefill): "
            f"kernel {r['ms']:.5f} ms (L2 left clean: "
            f"{r['ms_clean_l2']:.5f}) plain {r['plain_ms']:.4f} ms bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    # the blocked kernel at the flush's shape, where its blocks must fill
    # the card: one token block a (row, kv head) matrix
    n, nmat = xf.numel(), xf.numel() // (bs * 128)
    fbound, fby = bound_of(4 * n + n + 4 * nmat * 128, 6 * n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes = QK.blocked_lanes(nmat, bs, 128, bs, sms)
    flush = {"shape": str(tuple(xf.shape)), "block": bs, "lanes": lanes,
             "blocks": -(-128 // (4 * lanes)) * nmat,
             "ms": time_cold_ms(lambda: QK.quantize_blocked_cuda(xf, bs), 50),
             "plain_ms": time_cold_ms(
                 lambda: QK.quantize_blocked_plain(xf, bs), 5),
             "bound_ms": fbound, "bound_by": fby}
    log(f"[quantize] quantize_blocked at a flush {tuple(xf.shape)}: kernel "
        f"{flush['ms']:.4f} ms plain {flush['plain_ms']:.4f} ms bound "
        f"{fbound:.5f} ms ({fby}); {flush['blocks']} blocks of "
        f"{4 * lanes}-column slabs on {sms} SMs")
    for name, r in rows.items():
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else "none")
        clean = (f" (L2 left clean: {r['ms_clean_l2']:.5f})"
                 if "ms_clean_l2" in r else "")
        log(f"[quantize] {name} {shape}: bitwise; kernel {r['ms']:.5f} ms"
            f"{clean} plain {r['plain_ms']:.4f} ms library {lib} bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}: "
            f"{r['bytes'] / 1e6:.2f} MB at 3.35 TB/s)")
    rows["quantize_blocked"]["flush"] = flush
    return {"rows": rows, "shape": f"x {shape} f32 U(-1,1), block {bs}",
            "also": f"x {tuple(xp.shape)} per channel, {tuple(xf.shape)} "
                    f"blocked (bf16 values); NaN and inf channels at "
                    f"{shape} and {tuple(xp.shape)}",
            "generate": generate, "generate_shape": str(tuple(xp.shape)),
            "floor_ms": floor, "floor_clean_l2_ms": floor_clean,
            "nan_inf": nan_inf}


# -- phase 3: the paper's kernels at the paper's sizes ------------------------

# the paper's Table 3 sizes, (name, T, D)
PAPER_SIZES = [
    ("small", 2_048, 128),
    ("medium", 16_384, 256),
    ("large", 65_536, 256),
    ("very_large", 131_072, 256),
    ("realistic_small", 131_072, 1_024),
    ("realistic_medium", 131_072, 2_048),
    ("realistic_large", 131_072, 4_096),
    ("realistic_vlarge", 131_072, 8_192),
]
QUANT_KERNELS = ("absmax", "quantize_with_scales", "quantize_blocked",
                 "dequantize")
PAIR = ("absmax", "quantize_with_scales")


def _quant_counts():
    from repro_torch.kernels import quantize as QK
    return {"absmax": QK.absmax_cuda, "quantize_with_scales":
            QK.quantize_with_scales_cuda, "quantize_blocked":
            QK.quantize_blocked_cuda, "dequantize": QK.dequantize_cuda}


def paper_phase(dev, gen):
    """Per size: the paper's path through `kernels.ops` (quantize per
    channel -> dequantize -> errors, and the blocked pair), its launches
    counted from 0; then each kernel bitwise against its plain version and
    timed (those launches not counted)."""
    import torch
    from repro_torch.core import quantization as Q
    from repro_torch.kernels import ops
    counters = _quant_counts()
    launches = dict.fromkeys(QUANT_KERNELS, 0)
    sizes = []
    for name, T, D in PAPER_SIZES:
        x = torch.rand((T, D), generator=gen, device=dev) * 2 - 1
        qv = torch.rand((64, D), generator=gen, device=dev) * 2 - 1
        for c in counters.values():
            c.launches = 0
        q, s = ops.quantize_per_channel(x)
        xh = ops.dequantize(q, s)
        bq, bsc = ops.quantize_blocked(x, 256)
        bxh = ops.dequantize(bq, bsc)
        torch.cuda.synchronize()
        for k, c in counters.items():
            launches[k] += c.launches
        err = float(Q.max_abs_error(x, xh))
        eq9 = float(Q.theoretical_max_error(s))
        berr = float(Q.max_abs_error(x, bxh))
        beq9 = float(Q.theoretical_max_error(bsc))
        # Eq. 9 holds in exact arithmetic; float32 rounds the quotient x / s
        # (which can tip a near-tie to the farther integer) and the product
        # q * s, each by at most 2^-24 relative: 2^-23 max|x| of slack
        slack = 2.0 ** -23 * float(x.abs().max())
        if err > eq9 + slack or berr > beq9 + slack:
            raise AssertionError(f"{name}: max error {err:.8g} / {berr:.8g} "
                                 f"above Eq. 9's s/2 {eq9:.8g} / {beq9:.8g} "
                                 f"+ float32 slack {slack:.3g}")
        l2 = float(Q.l2_error(x, xh))
        kk = min(T, 4096)                # the statistic is T-invariant
        attn = float(Q.attention_score_error_raw(qv, x[:kk], xh[:kk]))
        del q, s, xh, bq, bsc, bxh
        iters, plain_iters = (20, 3) if T * D < 1 << 26 else (5, 2)
        rows = quantize_family(x, 256, iters, plain_iters)
        sizes.append({"name": name, "T": T, "D": D, "max_abs_err": err,
                      "eq9_bound": eq9, "float32_slack": slack,
                      "blocked_max_abs_err": berr,
                      "l2_err": l2, "l2_per_element": l2 / (T * D) ** 0.5,
                      "attn_err_raw": attn, "kernels": rows})
        log(f"[paper] {name} ({T}x{D}) per channel: " + ", ".join(
            f"{k} {rows[k]['ms']:.5f} ms (L2 left clean "
            f"{rows[k]['ms_clean_l2']:.5f}; bound {rows[k]['bound_ms']:.5f})"
            for k in ("absmax", "quantize_with_scales", "pair")))
        log(f"[paper] {name} ({T}x{D}): max_abs_err {err:.8f} vs s/2 "
            f"{eq9:.8f} (blocked {berr:.8f} vs {beq9:.8f}; slack "
            f"{slack:.3g}), l2/elem "
            f"{l2 / (T * D) ** 0.5:.6f}, attn_err_raw {attn:.5f}; "
            + "; ".join(f"{k} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
                        f"plain {r['plain_ms']:.3f})"
                        for k, r in rows.items()))
        del x, qv, rows
        torch.cuda.empty_cache()
    if min(launches.values()) < 1:
        raise AssertionError(f"paper path skipped a kernel: {launches}")
    log(f"[paper] path launches {launches}")
    return {"sizes": sizes, "launches": launches}


def grad_shapes():
    """{(T, D): leaves}: the matrices --grad-compression quantizes per
    channel each step, internlm2_1_8b's stacked gradient leaves reshaped
    as `optim.compression` does (shapes only: the leaves are built on the
    meta device)."""
    import collections

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    params = T.stack_layers(T.init_params(get_config("internlm2_1_8b"),
                                          torch.Generator(), device="meta"))
    return collections.Counter(
        (math.prod(leaf.shape[:-1]), leaf.shape[-1]) if leaf.ndim > 1
        else (1, leaf.shape[0]) for leaf in _leaves(params))


def grad_phase(dev, gen):
    """The per-channel pair at each distinct compressed-gradient shape:
    bitwise, then timed (`per_channel_rows`)."""
    import torch
    shapes = grad_shapes()
    if sum(shapes.values()) != 12:
        raise AssertionError(f"expected 12 stacked leaves: {shapes}")
    out = []
    for (T, D), leaves in sorted(shapes.items()):
        x = torch.rand((T, D), generator=gen, device=dev) * 2 - 1
        big = x.numel() >= 1 << 26
        rows = per_channel_rows(x, 5 if big else 30, 2 if big else 5)
        out.append({"T": T, "D": D, "leaves": leaves, **rows})
        log(f"[grad] ({T}x{D}) x{leaves}: bitwise; " + ", ".join(
            f"{k} {r['ms']:.5f} ms (L2 left clean {r['ms_clean_l2']:.5f}; "
            f"bound {r['bound_ms']:.5f}, plain {r['plain_ms']:.3f})"
            for k, r in rows.items()))
        del x
        torch.cuda.empty_cache()
    return out


# -- phase 4: CPU <-> card parity --------------------------------------------

def _to(x, d):
    if isinstance(x, dict):
        return {k: _to(v, d) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, d) for v in x]
    return x.to(d)


def parity_smoke(dev):
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.models import transformer as T
    from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams,
                                     greedy_generate)
    base = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                               dtype="float32")
    params = T.init_params(base, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, base.vocab, (n,)).astype(np.int32)
               for n in (13, 70, 5, 40, 21)]
    sps = [SamplingParams.greedy(max_new_tokens=n) for n in (8, 9, 5, 7, 8)]
    batch = np.stack([p[:13] for p in (prompts[0], prompts[1])])
    runs = [("paged", base, True), ("contiguous per_block", base, False),
            ("contiguous per_channel", dataclasses.replace(
                base, quant=QuantConfig("per_channel")), False)]
    for label, cfg, paged in runs:
        streams = {}
        for d in ("cpu", dev):
            p = _to(params, d)
            eng = LLMEngine(p, cfg, EngineConfig(batch=2, max_len=128,
                                                 paged=paged), device=d)
            toks = [o.token_ids for o in eng.generate(prompts, sps)]
            if not paged:
                toks.append(greedy_generate(p, cfg, batch, steps=8,
                                            device=d).cpu().tolist())
            streams[str(d)] = toks
        if streams["cpu"] != streams[str(dev)]:
            raise AssertionError(f"smoke f32 {label}: greedy tokens differ: "
                                 f"cpu {streams['cpu']} vs card "
                                 f"{streams[str(dev)]}")
        n_tok = sum(len(t) if not isinstance(t[0], list) else
                    sum(map(len, t)) for t in streams["cpu"])
        log(f"[parity] smoke f32 {label}: {n_tok} greedy tokens identical on "
            f"cpu (plain versions) and card (kernels)"
            + ("" if paged else ", greedy_generate included"))


# -- phase 5: the slices at full width ---------------------------------------

def _counters():
    """Every kernel's launcher, by the name the kernels line gives it."""
    from repro_torch.kernels import flash_fwd as FF
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quant_prefill as QP
    return {"paged_decode": QA.paged_decode_partials_cuda,
            "paged_prefill": QP.paged_prefill_cuda,
            "flat_decode": QA.flat_decode_partials_cuda, **_quant_counts(),
            "flash_fwd": FF.flash_fwd_cuda,
            "seed_decode": QA.seed_decode_partials_cuda}


def _run_path(dev, label: str, needs: tuple, fn):
    """Set every launch count to 0, run ``fn`` (the path), read the counts;
    fails when a kernel of ``needs`` was not launched. Returns (fn's result,
    wall s, counts, peak bytes allocated)."""
    import torch
    counters = _counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.launches for k, c in counters.items()}
    if any(counts[k] < 1 for k in needs):
        raise AssertionError(f"{label}: the path skipped a kernel: {counts}")
    return res, wall, counts, torch.cuda.max_memory_allocated(dev)


def serve_full_width(dev, params, cfg, paged: bool):
    import numpy as np
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    label = "paged" if paged else "contiguous"
    needs = (("paged_decode", "paged_prefill") if paged
             else ("flat_decode", "quantize_blocked", "flash_fwd"))
    eng = LLMEngine(params, cfg, EngineConfig(batch=4, max_len=2048,
                                              paged=paged), device=dev)
    rng = np.random.RandomState(0)
    lens = (1500, 900, 300, 37, 1100)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lens]
    sp = SamplingParams.greedy(max_new_tokens=48)
    outs, wall, counts, peak = _run_path(
        dev, f"serve {label}", needs, lambda: eng.generate(prompts, sp))
    reasons = [o.finish_reason for o in outs]
    if reasons != ["length"] * 5 or any(len(o.token_ids) != 48 for o in outs):
        raise AssertionError(f"full-width {label} requests did not all "
                             f"finish by length: {reasons}")
    if not all(0 <= t < cfg.vocab for o in outs for t in o.token_ids):
        raise AssertionError("a generated token lies outside the vocabulary")
    rep = eng.pool_report()
    gen_tokens = sum(len(o.token_ids) for o in outs)
    res = {"backend": label, "requests": len(outs), "prompt_lens": list(lens),
           "generated_tokens": gen_tokens, "wall_s": wall,
           "tokens_per_s": gen_tokens / wall, "ttft_s_p50": rep["ttft_s_p50"],
           "ticks": rep["ticks"], "launches": counts,
           "max_memory_allocated_bytes": peak}
    log(f"[serve {label}] 5/5 requests finished by length: {gen_tokens} "
        f"tokens in {wall:.3f} s ({res['tokens_per_s']:.2f} tok/s), TTFT p50 "
        f"{rep['ttft_s_p50'] * 1e3:.1f} ms, {rep['ticks']} ticks, launches "
        f"{counts}, max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[serve {label}] " + json.dumps(res))
    return counts


def generate_full_width(dev, params, cfg, granularity: str):
    """greedy_generate, 4 prompts of 1000 tokens, 32 steps. Per channel
    (the paper's setting): one 1000-token prefill (block 8), 32 decode
    steps. Per block (block 256): a 768-token prefill, the other 232 prompt
    tokens fed through decode, 32 steps; the cache crosses 1024, so every
    layer flushes one block of its bf16 residual through quantize_blocked
    (4 launches per layer in all: K and V at prefill and at the flush)."""
    import dataclasses

    import numpy as np
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.serving import greedy_generate
    gc = dataclasses.replace(cfg, quant=QuantConfig(granularity))
    B, S, steps = 4, 1000, 32
    needs = (("flat_decode", "absmax", "quantize_with_scales", "flash_fwd")
             if granularity == "per_channel"
             else ("flat_decode", "quantize_blocked", "flash_fwd"))
    prompts = np.random.RandomState(1).randint(0, gc.vocab, (B, S)).astype(
        np.int32)
    toks, wall, counts, peak = _run_path(
        dev, f"greedy_generate {granularity}", needs,
        lambda: greedy_generate(params, gc, prompts, steps=steps,
                                device=dev))
    if tuple(toks.shape) != (B, steps) or not bool(
            ((toks >= 0) & (toks < gc.vocab)).all()):
        raise AssertionError(f"greedy_generate gave {tuple(toks.shape)} "
                             f"tokens or one outside the vocabulary")
    if granularity == "per_block" and \
            counts["quantize_blocked"] < 4 * cfg.n_layers:
        raise AssertionError(f"greedy_generate per_block: no block flush "
                             f"({counts['quantize_blocked']} quantize_blocked "
                             f"launches, prefill alone gives "
                             f"{2 * cfg.n_layers})")
    res = {"quant": granularity, "batch": B, "prompt_len": S,
           "steps": steps, "wall_s": wall, "tokens_per_s": B * steps / wall,
           "launches": counts, "max_memory_allocated_bytes": peak}
    log(f"[generate {granularity}] {B}x{steps} tokens after {B}x{S}-token "
        f"prompts in {wall:.3f} s ({res['tokens_per_s']:.2f} tok/s, prefill "
        f"included; one batched call, no TTFT), launches {counts}, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[generate {granularity}] " + json.dumps(res))
    return counts


def seed_path(dev, gen):
    """The seed baseline through `ops.quant_attention_decode_partials_vmap`
    over the contiguous engine's cache (batch 4, H_kv 8, T 2048, D 128,
    block 256) at mixed lengths, timed beside the flat entry on the same
    cache, as benchmarks/e2e_decode.py compares the two (L2 flushed)."""
    import torch
    from repro_torch.kernels import ops
    B, H, Hkv, D, T, bs = 4, 16, 8, 128, 2048, 256
    lens = torch.tensor([2048, 1536, 1024, 512], dtype=torch.int32,
                        device=dev)
    k = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    kq, ks, vq, vs = _flat_quant("per_block", k, v, bs)
    args = (q, kq, ks, vq, vs, lens)
    out, _, counts, _ = _run_path(
        dev, "seed baseline", ("seed_decode",),
        lambda: ops.quant_attention_decode_partials_vmap(*args))
    flat = ops.quant_attention_decode_partials(*args)
    err = max(float((a - b).abs().max()) for a, b in zip(out, flat))
    if max(excess(a, b) for a, b in zip(out, flat)) > 1.0:
        raise AssertionError(f"seed baseline vs flat entry off by {err:.3e}")
    seed_ms = time_cold_ms(
        lambda: ops.quant_attention_decode_partials_vmap(*args), 50)
    flat_ms = time_cold_ms(
        lambda: ops.quant_attention_decode_partials(*args), 50)
    res = {"lengths": lens.tolist(), "seed_ms": seed_ms, "flat_ms": flat_ms,
           "seed_over_flat": seed_ms / flat_ms, "max_abs_err_vs_flat": err,
           "launches": counts}
    log(f"[seed path] lengths {lens.tolist()}: seed {seed_ms:.4f} ms, flat "
        f"{flat_ms:.4f} ms ({seed_ms / flat_ms:.2f}x), max |seed - flat| "
        f"{err:.3e}; " + json.dumps(res))
    return counts


def _plain_flash_loss(dev, cfg, batch):
    """Step 0's loss of the train CLI's model (seed 0 weights) with the
    forward's attention through the plain flash version on the card, and
    through the kernel, no gradients."""
    import torch
    from repro_torch.kernels import flash_fwd as FF
    from repro_torch.models import transformer as T
    from repro_torch.training.step import loss_fn
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    out = {}
    kernel = FF.flash_fwd_cuda
    with torch.no_grad():
        try:
            for name, fn in (("plain", FF.flash_fwd_plain),
                             ("kernel", kernel)):
                FF.flash_fwd_cuda = fn
                out[name] = float(loss_fn(params, batch, cfg)[1]["loss"])
        finally:
            FF.flash_fwd_cuda = kernel
    return out


def train_full_width(dev):
    """`launch.train.main` at full width: 3 steps of internlm2_1_8b at
    batch 4 x 2048 (SyntheticLM seed 0, no checkpoint dir), then, after
    that run's state is freed, 1 step with --grad-compression. flash_fwd
    runs in each block's forward and again in its recompute: >= 2 x 24
    launches a step. Step 0's loss is held against the same forward
    through the plain flash version on the card."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    cfg = get_config("internlm2_1_8b")
    B, S = 4, 2048
    argv = ["--arch", "internlm2_1_8b", "--batch", str(B), "--seq", str(S),
            "--log-every", "1"]
    runs = {}
    for label, extra, steps, needs in (
            ("train", [], 3, ("flash_fwd",)),
            ("train compressed", ["--grad-compression"], 1,
             ("flash_fwd", "absmax", "quantize_with_scales", "dequantize"))):
        rows = []
        _, wall, counts, peak = _run_path(
            dev, label, needs, lambda: train_cli.main(
                argv + ["--steps", str(steps)] + extra,
                on_step=lambda i, m, sec: rows.append(
                    {"step": i, **m, "step_ms": sec * 1e3,
                     "tokens_per_s": B * S / sec})))
        gc.collect()
        torch.cuda.empty_cache()
        if len(rows) != steps or not all(
                math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                for r in rows):
            raise AssertionError(f"{label}: steps or losses not finite: "
                                 f"{rows}")
        if counts["flash_fwd"] < 2 * cfg.n_layers * steps:
            raise AssertionError(f"{label}: {counts['flash_fwd']} flash "
                                 f"launches, < 2 x {cfg.n_layers} x {steps}")
        runs[label] = {"steps": rows, "wall_s": wall, "launches": counts,
                       "max_memory_allocated_bytes": peak}
        for r in rows:
            log(f"[{label}] step {r['step']}: loss {r['loss']:.5f} grad_norm "
                f"{r['grad_norm']:.4f} lr {r['lr']:.3e} step "
                f"{r['step_ms']:.1f} ms ({r['tokens_per_s']:.0f} tok/s)")
        log(f"[{label}] {steps} steps in {wall:.2f} s, launches {counts}, "
            f"max_memory_allocated {peak / 2**30:.2f} GiB")
    data = SyntheticLM(DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab,
                                  seed=0))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(0).items()}
    losses = _plain_flash_loss(dev, cfg, batch)
    cli0 = runs["train"]["steps"][0]["loss"]
    rel = abs(cli0 - losses["plain"]) / abs(losses["plain"])
    if rel > LOSS_RTOL:
        raise AssertionError(f"step-0 loss through the kernel {cli0} vs "
                             f"plain flash {losses['plain']}: {rel:.2e} > "
                             f"{LOSS_RTOL:g}")
    runs["step0_loss"] = {"cli_kernel": cli0, **losses, "rel_diff": rel}
    log(f"[train] step-0 loss: CLI (kernel) {cli0:.6f}, forward with kernel "
        f"{losses['kernel']:.6f}, with plain flash {losses['plain']:.6f} "
        f"(rel diff {rel:.2e} <= {LOSS_RTOL:g})")
    gc.collect()
    torch.cuda.empty_cache()
    log("[train] " + json.dumps(runs))
    return {k: v["launches"] for k, v in runs.items() if "launches" in v}


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, list):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def kernels_line(decode, prefill, flat, quant, paper, grad, flash, seed,
                 mma, path_counts):
    """One entry per hand-written kernel: the keys of every entry of the
    kernels line, its launches summed over the main paths that ran it."""
    launches = {k: sum(c.get(k, 0) for c in path_counts.values())
                for k in _counters()}
    by_path = {k: {p: c[k] for p, c in path_counts.items() if c.get(k)}
               for k in launches}
    csrc = "src/repro_torch/kernels/csrc/"
    ref = "src/repro/kernels/"
    attn_tol = f"|a-b| <= {ATOL:g} + {RTOL:g}|b| (float32)"
    sdpa = ("torch.nn.functional.scaled_dot_product_attention over "
            "pre-dequantized bf16 K/V")
    out = []
    for name, res, src, replaces in (
            ("paged_decode", decode, "paged_decode.cu",
             "quant_attention.py:396"),
            ("paged_prefill", prefill, "paged_prefill.cu",
             "quant_prefill.py:63")):
        main_row = res["per_dtype"][0]          # int8: the main path's pages
        out.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": ref + replaces, "dtype": main_row["dtype"],
            "max_abs_err": max(r["max_abs_err"] for r in res["per_dtype"]),
            "tol": attn_tol, "library": sdpa,
            "shapes": {"checked": res["check_shapes"],
                       "timed": res["timed_shapes"]},
            "per_dtype": res["per_dtype"],
            **({"sass_mma": res["sass_mma"]} if "sass_mma" in res else {}),
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "gb_per_s",
                                        "bound_tc_ms", "tflop_per_s")
               if k in main_row}})
        if "worst_tol_ratio" in main_row:
            out[-1]["worst_tol_ratio"] = max(r["worst_tol_ratio"]
                                             for r in res["per_dtype"])
    for name, res, src, replaces in (
            ("flat_decode", flat, "flat_decode.cu", "quant_attention.py:112"),
            ("seed_decode", seed, "seed_decode.cu", "quant_attention.py:271")):
        main_row = res["per_mode"][0]           # per block: the engine's
        out.append({
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": ref + replaces, "dtype": "int8",
            "max_abs_err": max(r["max_abs_err"] for r in res["per_mode"]),
            "tol": attn_tol, "library": sdpa,
            "shapes": {"checked": res["check_shapes"],
                       "timed": res["timed_shapes"]},
            "per_mode": res["per_mode"],
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "gb_per_s")
               if k in main_row}})
        if "worst_tol_ratio" in main_row:
            out[-1]["worst_tol_ratio"] = max(r["worst_tol_ratio"]
                                             for r in res["per_mode"])
    out.append({
        "name": "flash_fwd", "route": "cuda", "source": csrc + "flash_fwd.cu",
        "replaces": ref + "flash_fwd.py:37", "dtype": "bfloat16 (float32 "
        "too)", "max_abs_err": flash["max_abs_err"],
        "tol": f"out |a-b| <= {ATOL_BF16:g} + {RTOL_BF16:g}|b| (bf16 "
               f"inputs; one bf16 ulp), else and m, l: {ATOL:g} + "
               f"{RTOL:g}|b|; plain walked in {FLASH_TILE}-key tiles",
        "library": "torch.nn.functional.scaled_dot_product_attention, "
                   "causal, bf16 q/k/v",
        "shapes": {"checked": flash["check_shapes"],
                   "timed": flash["timed_shapes"]},
        "sass_mma": mma, "tflop_per_s": flash["tflop_per_s"],
        **{k: flash[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}})
    lines = {"absmax": "quantize.py:35", "quantize_with_scales":
             "quantize.py:49", "quantize_blocked": "quantize.py:59",
             "dequantize": "quantize.py:67"}
    for name in QUANT_KERNELS:
        r = quant["rows"][name]
        out.append({
            "name": name, "route": "cuda", "source": csrc + "quantize.cu",
            "replaces": ref + lines[name], "dtype": "int8",
            "max_abs_err": 0.0,
            "tol": "bitwise", "library": r["library"],
            "shapes": {"checked": f"{quant['shape']}; {quant['also']}; "
                                  f"the paper sizes"
                                  + ("; the compressed gradients' shapes"
                                     if name in PAIR else ""),
                       "timed": quant["shape"] + "; L2 flushed"},
            "paper": [{"name": z["name"], "T": z["T"], "D": z["D"],
                       **{k: z["kernels"][name][k] for k in (
                           "ms", "plain_ms", "bound_ms", "library_ms")},
                       **({"pair_ms": z["kernels"]["pair"]["ms"],
                           "pair_bound_ms": z["kernels"]["pair"]["bound_ms"]}
                          if name in PAIR else {})}
                      for z in paper["sizes"]],
            **({"flush": r["flush"]} if "flush" in r else {}),
            **({"nan_inf": quant["nan_inf"]} if name != "dequantize"
               else {}),
            **({"generate": {"shape": quant["generate_shape"],
                             **quant["generate"][name]},
                "pair": {"timed": quant["rows"]["pair"],
                         "generate": quant["generate"]["pair"]},
                "grad": [{"T": g["T"], "D": g["D"], "leaves": g["leaves"],
                          **g[name], "pair_ms": g["pair"]["ms"],
                          "pair_bound_ms": g["pair"]["bound_ms"]}
                         for g in grad],
                "floor_ms": quant["floor_ms"],
                "floor_clean_l2_ms": quant["floor_clean_l2_ms"]}
               if name in PAIR else {}),
            **{k: r[k] for k in ("ms", "ms_clean_l2", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms") if k in r}})
    for e in out:
        e["launches"] = launches[e["name"]]
        e["launches_by_path"] = by_path[e["name"]]
        # both key namings in use, same numbers: max_abs_err/max_err,
        # ms/kernel_ms
        e["max_err"], e["kernel_ms"] = e["max_abs_err"], e["ms"]
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script runs the port on the card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return fail(f"{SRC / 'repro_torch'} not found: run from a checkout "
                    f"of the repository")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {sorted(logs) or 'up to date'} in "
        f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, text in logs.items():
        (_build.BUILD_DIR / f"{name}.log").write_text(text)
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")

    mma = flash_mma_count()
    log(f"[sass] HMMA/HGMMA instructions in flash_fwd: {mma}")
    pmma = prefill_mma_count()
    log(f"[sass] HMMA/HGMMA instructions in paged_prefill: {pmma}")

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    decode = check_decode(dev, gen)
    prefill = check_prefill(dev, gen)
    flat = check_flat_decode(dev, gen)
    seed = check_seed_decode(dev, gen)
    flash = check_flash(dev, gen)
    quant = check_quantize(dev, gen)
    log(f"[kernels] checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paper = paper_phase(dev, gen)
    grad = grad_phase(dev, gen)
    log(f"[paper] phase in {time.perf_counter() - t0:.1f} s (gradient "
        f"shapes included)")
    t0 = time.perf_counter()
    parity_smoke(dev)
    log(f"[parity] in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = get_config("internlm2_1_8b")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B params bf16 on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    path_counts = {
        "serve paged": serve_full_width(dev, params, cfg, paged=True),
        "serve contiguous": serve_full_width(dev, params, cfg, paged=False),
        "greedy_generate per_block": generate_full_width(dev, params, cfg,
                                                         "per_block"),
        "greedy_generate per_channel": generate_full_width(dev, params, cfg,
                                                           "per_channel"),
        "paper": paper["launches"],
        "seed baseline": seed_path(dev, gen)}
    log(f"[serve] phase in {time.perf_counter() - t0:.1f} s")
    del params                     # the serving weights make way for training
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    path_counts.update(train_full_width(dev))
    log(f"[train] phase in {time.perf_counter() - t0:.1f} s")

    prefill["sass_mma"] = pmma
    kernels = kernels_line(decode, prefill, flat, quant, paper, grad, flash,
                           seed, mma, path_counts)
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError("a kernel was launched on no main path")
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
