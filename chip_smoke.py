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
     the seed timed at full lengths and at lengths 1 in turns, whose
     median must reach SEED_LEN1_MIN of the first's: it reads every slot);
     paged decode, paged prefill (both dispatches), flat decode (both
     granularities) and the bf16 flash forward (the 1536 rebuild) also at the other
     served models' H / H_kv 32 / 32, 24 / 8, 40 / 8 and 12 / 2 (GQA groups
     1, 3, 5 and 6; correctness only, the timed shapes unchanged); the
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
     seed decode calls once more with any host sync an error; then
     recurrentgemma_9b's shapes at head width 256 and GQA group 16 (H /
     H_kv 16 / 1): the flash forward in bf16 and float32, causal with the
     2048 window over S = 3072 (timed at 4 rows beside SDPA with the
     window as a boolean mask), flat decode and the seed on a ring of 2048
     slots (block 256) whose rows have wrapped, windows shortened by the
     residual tail, an empty row (timed with every slot live), and the
     blocked quantizer at D 256, block 256, bitwise (a prefill and a
     flush); then qwen2_vl_2b's GQA group 6 (12 / 2, D 128) and
     whisper_small's head width 64 (12 / 12), each timed beside its bound
     and SDPA (`check_g6_d64`): paged decode and prefill (int8), flat
     decode per block and the bf16 flash forward (the 1536 rebuild) at G 6;
     the flash forward non-causal in bf16 and float32 at the encoder's
     (4, 12, 1500, 1500, 64) and at S 256 over T 1500 (partial last
     tiles), flat decode per channel over a 1504-slot cross cache at
     length 1500 with an empty row and per block over the 512-slot self
     cache, quantize_blocked bitwise at (4, 12, 256, 64) and (4, 12, 512,
     64), the per-channel pair bitwise at (4, 12, 1504, 64) (zero past
     1500) and (4, 12, 256, 64).
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
     (per block and per channel); threefry bits on the card bit for bit
     against the committed known answers of jax 0.9 and against the CPU;
     identical tokens of seeded sampled requests mixed with greedy ones
     (temperature 0.7 top_k 50, 1.0 top_p 0.9, 0.8 top_k 40 top_p 0.95)
     through the paged and the contiguous LLMEngine and sampled
     `generate`, and of the prefix cache's hit-against-miss and
     shared-prefix protocols with identical counters (a differing sampled
     token fails after its step and the gap between the draw's two
     leading perturbed logits are printed); the overload protocols of
     tests/test_overload.py (fast resume against the unpressured run,
     recompute resume, transient allocation faults, delayed reclaim) with
     identical tokens and pool reports; the tier protocols of
     tests/test_tiering.py (hit == miss through the host tier with the lru
     and freq evictors, the forced swap restore of a greedy and a seeded
     row, a swap fault falling back to recompute, swap_delay riding the
     in-flight population, a demote / promote interleaving) and the live
     dtype flip, with identical tokens, reports and populations; mixed
     per-layer precision plans (PLAN2 = ("int8", "int4") on the 2-layer
     model, ("int8", "fp8_e4m3", "int4") on a 3-layer one): five requests
     with the prefix cache, hit == miss, the rejected dtype request, the
     idle flips int8 -> plan -> int8 and the grouped revisit through a
     6-page host tier with and without int4 at rest, with identical
     tokens, reports and errors; the smoke configs of llama3_2_3b,
     codeqwen1_5_7b, qwen2_5_32b and qwen2_moe_a2_7b in float32 with
     seeded non-zero QKV biases: identical greedy tokens from the paged
     and the contiguous LLMEngine; those of recurrentgemma_9b, xlstm_350m
     and mixtral_8x22b in float32 with the RG-LRU gate vectors seeded per
     channel: identical greedy tokens from the contiguous LLMEngine
     (prompts past the window of 16: the ring wraps), and the paged
     engine's refusal (the reference's ValueError); qwen2_vl_2b's
     (M-RoPE, text mode; QKV biases seeded) beside the four decoder-only
     models above; whisper_small's through `make_serve_fns` (make_frames
     frames, 16-token prompts, 12 greedy steps across a block flush):
     identical tokens, and the refusals (paged, int4, chunk prefill: the
     reference's ValueErrors; the batcher: the named one).
  5. the slices at full width: internlm2_1_8b with random bf16 weights from
     a seeded torch.Generator serves 5 greedy requests through the paged
     LLMEngine and through the contiguous one (batch 4, max_len 2048). Every
     paged engine dispatches its decode ticks, decode-scan chunks, sampler
     draws and prompt chunks as replays of captured CUDA graphs (the
     default on the card; a chunk of n decode steps replays one step's
     graph n times); the decode dispatches probed for host syncs below
     run as a tick runs them (table and length pushes, uploads, graph
     replays) on the engines' live state. The paged engine serves
     them again with requests 1, 3 and 4 sampled
     (greedy rows must equal the greedy run's, sampled rows must differ
     from it; then a sampled decode step at the served lengths runs with
     any host sync an error); the paged and the sampled cell each graphed
     (captures included), eager (every step dispatched eagerly) and
     graphed again (replays only): tokens, pool pages and scales and
     launch counts identical graphed and eager, tok/s, TTFT p50 and peak
     memory each way, the graphs and their pool's bytes, and one decode
     chunk replayed with no host sync and profiled graphed and eager (the
     device's busy share; the traced paged kernels equal the counters),
     then 2 x 512 new tokens under the default chunk graphed against one
     token a tick; and with the prefix cache (prefill_chunk
     512, a 1536-token shared prefix: a warm rerun and three requests
     together each adopt 6 pages, compute 1536 prefill tokens fewer and
     give their cold runs' tokens; the counters are the reference's
     logic's, every page cached or free at drain; TTFT cold and warm
     printed beside the card's name and power limit), and under overload
     (prefix cache, chunk 1, watermark 0, a pool of 7 pages of 256: (a) a
     greedy and a sampled request preempted by held pages and resumed fast
     give the unpressured run's tokens bit for bit; (b) resumed by
     recompute, they keep the tokens before the preemption and the pending
     token; (c) a 2x oversubscribed burst of 8 requests at mixed
     priorities drains with full budgets, its preemptions, resumes,
     stalls, goodput and TTFT printed, then a watermark decode step runs
     with any host sync an error), and with the host tier (pinned records,
     stream-ordered copies: (a) a greedy and a sampled row preempted after
     8 tokens and every cached device page reclaimed resume by 2 swap
     restores with the unpressured run's tokens bit for bit; (b) the
     1536-token prefix, demoted by two fillers on a 9-page pool, is
     promoted back and adopted as 6 hits with its cold tokens, TTFT cold,
     device-warm and host-warm printed; (c) int4 at rest completes; (d)
     under swap_delay 2 the preemption pass, a promotion and a decode step
     with it in flight make no host sync; (e) the idle dtype flip int8 ->
     fp8_e4m3 serves a fresh fp8 engine's tokens and memory_allocated
     falls back; one page's copy out and in timed by CUDA events against
     the link's bound, beside its re-prefill), and with the per-layer plan
     P24 = ("int8", "fp8_e4m3", "int4") x 8 passed as a JSON path ((a) the
     five prompts: pools at their dtypes and shapes, pool bytes, capacity
     ratio and saved fraction as predicted, layer 0's prompt pages bit for
     bit the uniform int8 run's, paged decode and prefill launched equally
     for each dtype; (b) an all-int8 plan gives the uniform run's tokens;
     (c) the prefix cell cold then warm; (d) the tier revisit with and
     without int4 at rest, host bytes a page as predicted, demote and
     promote without host sync; (e) a mixed decode step without host
     sync; (f) idle flips int8 -> P24 -> int8 freeing the old pools); it
     runs greedy_generate per block (a block flush in every layer) and per
     channel (batch 4, 1000-token prompts, 32 steps); the seed baseline
     runs over the contiguous cache's shape beside flat decode; then, the
     serving weights freed, the other served models one at a time, each
     freed before the next (random bf16 weights from a seeded generator,
     QKV biases seeded non-zero): llama3_2_3b, codeqwen1_5_7b,
     qwen2_5_32b (64 layers, 65.5 GB of weights), qwen2_moe_a2_7b
     (60 experts, top 4, 4 shared) and qwen2_vl_2b (28 layers, GQA 12 /
     2, M-RoPE) serve the five prompts through the
     paged LLMEngine graphed on a fresh engine and graphed again (the
     same tokens, 48 a request inside the vocabulary; the decode-scan
     step and chunk prefill captured; paged decode and prefill launched
     n_layers times a step and a chunk), with parameter bytes, tok/s,
     TTFT p50, peak memory, captures and one replayed decode step's
     device time against the weights it streams at 3.35 TB/s; the MoE
     also eager (tokens, pool bits and launches = graphed), with
     requests 1, 3 and 4 sampled graphed and eager, and a decode step
     and chunk replayed with any host sync an error; llama3_2_3b, the
     MoE and qwen2_vl_2b also through the contiguous LLMEngine; then
     recurrentgemma_9b
     (38 layers, 19.1 GB), xlstm_350m (24 layers) and mixtral_8x22b cut
     to 4 of its 56 layers (~20.8 GB), one at a time, bf16 weights from a
     seeded generator (RG-LRU gate vectors seeded), through the
     contiguous LLMEngine: the five prompts and two past the 2048 window
     (2500, 3000; mixtral one of 4500 past its 4096), 48 tokens each, with
     flash forward, flat decode and quantize_blocked launched exactly as
     predicted from the scheduler's prefills, decode steps and block
     flushes (xlstm_350m runs no attention kernel), tok/s, TTFT p50, peak
     memory and the least event-timed decode step against the weight
     bytes it streams; and, with attention, a prompt of the window's
     length and 264 tokens, which flush a block into the wrapped ring
     (launches as predicted); then whisper_small (12 + 12 layers, bf16
     weights from a seeded generator) through `make_serve_fns`: make_frames
     frames (4, 1500, 768), 256-token prompts, max_len 512, 48 greedy
     decode steps, launches exactly as predicted (flash 36, quantize_blocked
     24, the pair 24 + 24 at the prefill; flat decode 24 a step), the
     encoder's time, TTFT, tok/s, peak memory and the least event-timed
     decode step against its weight and cross-cache bytes; then the train
     CLI's entry point takes 3 steps at
     batch 4 x 2048 and 1 more with --grad-compression (step 0's loss held
     against the plain flash forward's), and trains, one model at a time,
     each freed before the next (`TRAIN_FAMILIES`): qwen2_vl_2b (28
     layers, 4 x 2048), xlstm_350m (24 layers, 4 x 2048: no attention),
     whisper_small (12 + 12 layers, frames (4, 1500, 768), 448 tokens),
     recurrentgemma_9b cut to 5 of 38 layers (1 x 4096, past its 2048
     window; then 1 step with --grad-compression over the pattern's
     period-3 + tail layout) and qwen2_moe_a2_7b cut to 4 of 24 layers (2
     x 2048), 2 steps each through the same `main` (a cut answered by the
     config registry): parameter bytes, step ms (step 0 apart), tok/s,
     peak memory, finite losses and grad norms, flash launches of at
     least 2 x the attention calls of a forward x steps (whisper's
     encoder, self and cross: 36), and with attention step 0's loss
     against the plain flash forward's; then sharded training
     (`sharded_full_width`, `SHARDED_RUNS`): the parent frees its card
     memory and spawns 4 ranks on cuda:0 over gloo (every collective
     staged through pinned host buffers), mesh (data 2, model 2),
     `file://` rendezvous and a timeout: internlm2_1_8b uncut at 4 x 2048
     (2 x 1024 a rank), 2 steps and a fresh compressed step, and
     qwen2_moe_a2_7b at 4 of 24 layers, 2 x 2048, 2 steps, through
     `mesh_context` around `make_train_step` (each rank draws the seed-0
     weights and keeps its shards of each part as it is made,
     `launch.specs.init_shards`): losses within LOSS_RTOL and grad norms
     within GNORM_RTOL of the same models' single-process steps above,
     step 0's loss against the plain flash forward's, flash launched >=
     2 x the attention layers x steps on each rank, the pair and
     dequantize in the compressed step, the same bytes sent by every
     step; per rank peak memory (and the init's), step ms, and the bytes
     each collective sends a step by axes; then one rank at (1, 1) over
     NCCL (the backend asserted) takes internlm2_1_8b's first 2 steps. The kernels' launch counters are
     set to 0 just before each path and must be > 0 just after for every
     kernel the path runs.
  6. a {"kernels": [...]} line, then the card line, then as the last line
     {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device or without the repository's src/.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 peak outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 dense tensor-core peak
PCIE_BYTES_PER_S = 64e9        # H100 SXM host link, PCIe Gen5 x16, each way
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
# (H, H_kv) of the other served models at D 128, checked beside the main
# path's 16 / 8: GQA groups 1 (codeqwen1_5_7b; MHA, as qwen2_moe_a2_7b's
# 16 / 16), 3 (llama3_2_3b), 5 (qwen2_5_32b) and 6 (qwen2_vl_2b)
GROUP_WIDTHS = ((32, 32), (24, 8), (40, 8), (12, 2))
PREFILL_ROWS = 64              # query rows per tile (csrc/paged_prefill.cu)
# the full-width train step's loss through the kernel vs through the
# plain flash forward, bf16 model: relative
LOSS_RTOL = 1e-3
# the sharded step's gradient norm against the single-process step's,
# relative: bf16 partial sums reduced over "model" (the MLP's and MoE's
# down-projections, dK / dV, as the reference's shard_map bodies) round
# once more than one process's matmul; 0.12-0.68% at full depth on the
# card (PR 28 run 1), 0.1-0.3% in the CPU runs at smoke depth
GNORM_RTOL = 2e-2
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


def time_cold_samples(fns, iters: int, warmup: int = 1,
                      spin: int = SPIN_CYCLES,
                      clean: bool = False) -> list[list[float]]:
    """Per-launch ms of each of ``fns``, launched in turns (fns[0], fns[1],
    ..., fns[0], ...) so a drift of the card's clock or of the host falls
    on all of them alike; the L2 cache is evicted before each launch (a
    256 MB write, which leaves the L2 full of dirty lines: a cold read pays
    their write-back; ``clean``: a 256 MB read, which leaves clean lines);
    CUDA events bracket the call alone, and a spin of ``spin`` cycles on
    the card after the flush keeps the host's enqueue off the clock."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.float32,
                                  device="cuda"))
    pairs = [[] for _ in fns]
    for i in range(warmup + iters):
        for fn, got in zip(fns, pairs):
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
                got.append((t0, t1))
    torch.cuda.synchronize()
    return [[a.elapsed_time(b) for a, b in got] for got in pairs]


def time_cold_ms(fn, iters: int, warmup: int = 1,
                 spin: int = SPIN_CYCLES, clean: bool = False) -> float:
    """Mean ms of ``fn`` over ``iters`` cold launches (time_cold_samples)."""
    (ts,) = time_cold_samples([fn], iters, warmup, spin, clean)
    return sum(ts) / iters


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
        for H2, Hkv2 in GROUP_WIDTHS:        # the other served groups
            pool2 = make_pool(kv_dtype, n_pages, Hkv2, D, ps, gen, dev)
            q2 = torch.randn((B, H2, D), generator=gen, device=dev)
            a2 = (q2, *pool2, table, lengths, kv_dtype)
            got2 = QA.paged_decode_partials_cuda(*a2)
            torch.cuda.synchronize()
            want2 = QA.paged_decode_partials_plain(*a2)
            e2 = max(float((g - w).abs().max()) for g, w in zip(got2, want2))
            x2 = max(excess(g, w) for g, w in zip(got2, want2))
            if x2 > 1.0 or not all(bool(torch.isfinite(g).all())
                                   for g in got2):
                raise AssertionError(
                    f"paged decode {kv_dtype} H/H_kv {H2}/{Hkv2}: kernel vs "
                    f"plain off by {e2:.3e} ({x2:.2f}x tolerance)")
            log(f"[decode] {kv_dtype} H/H_kv {H2}/{Hkv2} (G {H2 // Hkv2}): "
                f"max_abs_err {e2:.3e} ({x2:.3f}x tolerance)")
            err, ex = max(err, e2), max(ex, x2)
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
                           f"{splits[B]}; also H/H_kv "
                           f"{', '.join(f'{a}/{b}' for a, b in GROUP_WIDTHS)}")
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
        for H2, Hkv2 in GROUP_WIDTHS:        # the other served groups
            pool2 = make_pool(kv_dtype, n_pages, Hkv2, D, ps, gen, dev)
            for C, hl, vd in dispatches:
                e2, x2 = _prefill_check(
                    f"paged prefill {kv_dtype} H/H_kv {H2}/{Hkv2} C={C}",
                    B, H2, Hkv2, C, D, hl, vd, pool2, table, ps, kv_dtype,
                    gen, dev)
                row["max_abs_err"] = max(row["max_abs_err"], e2)
                row["worst_tol_ratio"] = max(row["worst_tol_ratio"], x2)
            log(f"[prefill] {kv_dtype} H/H_kv {H2}/{Hkv2} (G {H2 // Hkv2}): "
                f"both dispatches within tolerance, row tiles past valid 0.0")
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
        for C, hl, vd in dispatches) + (
        f"; also H/H_kv {', '.join(f'{a}/{b}' for a, b in GROUP_WIDTHS)}")
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



def _prefill_check(label, B, H, Hkv, C, D, hl, vd, pool, table, ps,
                   kv_dtype, gen, dev):
    """Paged prefill against its plain version on fresh q / k / v at
    (B, H, H_kv, C, D) over ``pool``: rows below ``valid`` within the
    tolerance, row tiles past it 0.0. Returns (max |err|, multiple of the
    tolerance)."""
    import torch
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quant_prefill as QP
    G = H // Hkv
    hist = torch.tensor(hl, dtype=torch.int32, device=dev)
    valid = torch.tensor(vd, dtype=torch.int32, device=dev)
    hb = 1 << (-(-max(hl) // ps) - 1).bit_length()
    q = torch.randn((B, H, C, D), generator=gen, device=dev)
    k = torch.randn((B, Hkv, C, D), generator=gen, device=dev)
    v = torch.randn((B, Hkv, C, D), generator=gen, device=dev)
    qg = (q.reshape(B, Hkv, G * C, D) * QA.logit_scale(D)).contiguous()
    args = (qg, k, v, *pool, table, hist, valid, hb, kv_dtype)
    got = QP.paged_prefill_cuda(*args)
    torch.cuda.synchronize()
    want = QP.paged_prefill_plain(*args)
    got4, want4 = got.reshape(B, H, C, D), want.reshape(B, H, C, D)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: a non-finite output")
    err = ex = 0.0
    for b in range(B):
        g, w = got4[b, :, :vd[b]], want4[b, :, :vd[b]]
        e, x = float((g - w).abs().max()), excess(g, w)
        if x > 1.0:
            raise AssertionError(f"{label} row {b}: kernel vs plain off by "
                                 f"{e:.3e} ({x:.2f}x tolerance)")
        err, ex = max(err, e), max(ex, x)
        dead = -(-vd[b] // PREFILL_ROWS) * PREFILL_ROWS
        if dead < C and float(got4[b, :, dead:].abs().max()):
            raise AssertionError(f"{label} row {b}: a row tile past "
                                 f"valid={vd[b]} is not 0.0")
    return err, ex


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
        for H2, Hkv2 in GROUP_WIDTHS:        # the other served groups
            k2 = torch.randn((B, Hkv2, T, D), generator=gen, device=dev)
            v2 = torch.randn((B, Hkv2, T, D), generator=gen, device=dev)
            q2 = torch.randn((B, H2, D), generator=gen, device=dev)
            e2, x2 = _flat_check(
                f"flat decode {mode} H/H_kv {H2}/{Hkv2}",
                (q2, *_flat_quant(mode, k2, v2, bs), lengths, windows))
            log(f"[flat_decode] {mode} H/H_kv {H2}/{Hkv2} (G {H2 // Hkv2}): "
                f"max_abs_err {e2:.3e} ({x2:.3f}x tolerance)")
            err, ex = max(err, e2), max(ex, x2)
            del k2, v2
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
                           f"lengths {lp.tolist()}; also H/H_kv "
                           f"{', '.join(f'{a}/{b}' for a, b in GROUP_WIDTHS)}")
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
        # full lengths and lengths 1 in turns; the check compares medians,
        # which one launch held up by the host cannot move
        ts, ts1 = time_cold_samples([
            lambda: QA.seed_decode_partials_cuda(*targs),
            lambda: QA.seed_decode_partials_cuda(q, kq, ks, vq, vs, ones,
                                                 full)], 50)
        ms, ms1 = sum(ts) / len(ts), sum(ts1) / len(ts1)
        med, med1 = statistics.median(ts), statistics.median(ts1)
        if med1 < SEED_LEN1_MIN * med:
            raise AssertionError(f"seed decode {mode}: median {med1:.4f} ms "
                                 f"at lengths 1 < {SEED_LEN1_MIN} x median "
                                 f"{med:.4f} ms at full lengths: it must "
                                 f"read every slot")
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
               "ms": ms, "ms_lengths_1": ms1, "median_ms": med,
               "median_ms_lengths_1": med1,
               "lengths_1_over_full": med1 / med,
               "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
               "library_ms": lib_ms, "gb_per_s": nbytes / ms / 1e6}
        out["per_mode"].append(row)
        log(f"[seed_decode] {mode}: max_abs_err {err:.3e} (tol {ATOL:g} + "
            f"{RTOL:g}|ref|, worst {ex:.3f}x) kernel {ms:.4f} ms "
            f"({row['gb_per_s']:.0f} GB/s of 3350), at lengths 1 {ms1:.4f} ms "
            f"(medians {med1:.4f} / {med:.4f} ms: {med1 / med:.3f}x full, "
            f">= {SEED_LEN1_MIN}) plain {plain_ms:.4f} "
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
        # the other served groups at the contiguous prefill's rebuild: G 1
        # (64 positions a tile), 3 (21 in 63 rows), 5 (12 in 60 rows), 6
        # (10 in 60 rows)
        *((f"prefill 1536 H/H_kv {h}/{hk}", (4, h, hk, 1536, 1536, 128),
           torch.bfloat16, True, None, 0) for h, hk in GROUP_WIDTHS),
        ("G 3 window+offset", (2, 24, 8, 300, 812, 128), torch.bfloat16,
         True, 256, 512),
        ("G 5 odd S f32", (2, 40, 8, 999, 999, 128), torch.float32, True,
         None, 0),
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


# recurrentgemma_9b's attention at full width: 16 query heads over one kv
# head at D 256 (GQA group 16), a 2048-token window, block 256
D256 = dict(H=16, Hkv=1, D=256, window=2048, bs=256)


def check_d256(dev, gen):
    """recurrentgemma_9b's kernel shapes against the plain versions: the
    flash forward at D 256, H / H_kv 16 / 1, bf16 and float32, causal with
    the 2048 window over S = 3072 (a rebuild of the 3000-token prompt);
    flat decode (and the seed, which shares its walk) at D 256, G 16, per
    block 256 on a ring of 2048 slots whose rows have wrapped, with the
    window and the residual tail's shorter budget (window - n_tail), and
    an empty row; the blocked quantizer at D 256, block 256, at the
    prefill's (4, 1, 3072, 256) and a flush's (4, 1, 256, 256), bitwise.
    Each timed with the L2 flushed beside its bound and one PyTorch call
    (SDPA with the window's boolean mask; SDPA over pre-dequantized bf16
    K/V). Returns {row name: row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_fwd as FF
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quantize as QK
    H, Hkv, D, W, bs = (D256[k] for k in ("H", "Hkv", "D", "window", "bs"))
    rows = {}
    # flash forward: correctness in both dtypes at B 1, timed in bf16 at
    # the rebuild's batch of 4 rows
    S = 3072
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = _flash_inputs(1, H, Hkv, S, S, D, dt, gen, dev)
        got = FF.flash_fwd_cuda(q, k, v, True, W, 0)
        torch.cuda.synchronize()
        want = FF.flash_fwd_plain(q, k, v, True, W, 0, FLASH_TILE)
        atol, rtol = ((ATOL_BF16, RTOL_BF16) if dt == torch.bfloat16
                      else (ATOL, RTOL))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        ex = max(excess(got[0], want[0], atol, rtol),
                 *(excess(g, w) for g, w in zip(got[1:], want[1:])))
        if ex > 1.0 or not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"flash forward D 256 {dt}: kernel vs "
                                 f"plain off by {err:.3e} ({ex:.2f}x)")
        worst = max(worst, err)
        log(f"[flash_fwd D256] (1,{H},{Hkv},{S},{S},{D}) {str(dt)[6:]} "
            f"causal window {W}: max_abs_err {err:.3e} ({ex:.3f}x tolerance)")
        del q, k, v, got, want
    B = 4
    q, k, v = _flash_inputs(B, H, Hkv, S, S, D, torch.bfloat16, gen, dev)
    qpos = torch.arange(S, device=dev)
    mask = (qpos[None] <= qpos[:, None]) & (qpos[None] > qpos[:, None] - W)
    live = int(mask.sum())                      # (query, key) pairs
    flops = 4 * D * H * B * live
    nbytes = (q.numel() + k.numel() + v.numel()) * 2 + B * H * S * D * 4 \
        + 2 * B * H * S * 4
    bound, by = bound_of(nbytes, flops, BF16_FLOP_PER_S)
    ms = time_cold_ms(lambda: FF.flash_fwd_cuda(q, k, v, True, W, 0), 10)
    rows["flash_fwd_d256"] = {
        "max_abs_err": worst, "ms": ms,
        "plain_ms": time_cold_ms(
            lambda: FF.flash_fwd_plain(q, k, v, True, W, 0), 2),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_cold_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), 10),
        "library": "torch.nn.functional.scaled_dot_product_attention, bf16 "
                   "q/k/v, the causal window as a boolean mask",
        "tflop_per_s": flops / ms / 1e9,
        "shapes": {"checked": f"(1,{H},{Hkv},{S},{S},{D}) bf16 and float32 "
                              f"causal window {W}",
                   "timed": f"q ({B},{H},{S},{D}), k/v ({B},{Hkv},{S},{D}) "
                            f"bf16 causal window {W}"}}
    r = rows["flash_fwd_d256"]
    log(f"[flash_fwd D256] timed ({B},{H},{Hkv},{S},{S},{D}) bf16: kernel "
        f"{ms:.4f} ms ({r['tflop_per_s']:.1f} TFLOP/s of 989) plain "
        f"{r['plain_ms']:.2f} ms sdpa(mask) {r['library_ms']:.4f} ms bound "
        f"{bound:.5f} ms ({by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} "
        f"MB)")
    del q, k, v, mask
    # flat decode on the ring: T = 2048 slots, lengths past T (wrapped)
    T = W
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    flushed = i32([2816, 2560, 2304, 0])          # block multiples
    windows = i32([W - 72, W, W - 200, W])        # window - n_tail
    k = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    qd = torch.randn((B, H, D), generator=gen, device=dev)
    (kq, ks), (vq, vs) = (QK.quantize_blocked_plain(x, bs) for x in (k, v))
    err = ex = 0.0
    for name, fn in (("flat decode", QA.flat_decode_partials_cuda),
                     ("seed decode", QA.seed_decode_partials_cuda)):
        e, x = _flat_check(f"{name} D256 G16 ring",
                           (qd, kq, ks, vq, vs, flushed, windows), fn)
        log(f"[{name.replace(' ', '_')} D256] ({B},{H},{D}) over "
            f"({B},{Hkv},{T},{D}) int8 block {bs}, lengths "
            f"{flushed.tolist()} (wrapped) windows {windows.tolist()}: "
            f"max_abs_err {e:.3e} ({x:.3f}x tolerance)")
        err, ex = max(err, e), max(ex, x)
    full, wfull = i32([3072] * B), i32([W] * B)
    targs = (qd, kq, ks, vq, vs, full, wfull)
    nb = T // bs
    nbytes = (2 * B * T * Hkv * D + 2 * B * Hkv * nb * D * 4
              + 2 * B * H * D * 4 + 2 * B * H * 4 + 2 * B * 4)
    flops = 4 * D * H * B * T
    bound, by = bound_of(nbytes, flops)
    ms = time_cold_ms(lambda: QA.flat_decode_partials_cuda(*targs), 50)
    kb = QK.dequantize_plain(kq, ks, torch.bfloat16)
    vb = QK.dequantize_plain(vq, vs, torch.bfloat16)
    qb = qd.bfloat16()[:, :, None]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows["flat_decode_d256"] = {
        "max_abs_err": err, "worst_tol_ratio": ex, "ms": ms,
        "plain_ms": time_cold_ms(
            lambda: QA.flat_decode_partials_plain(*targs), 5),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_cold_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, enable_gqa=True), 50),
        "library": "torch.nn.functional.scaled_dot_product_attention over "
                   "pre-dequantized bf16 K/V",
        "gb_per_s": nbytes / ms / 1e6,
        "kv_reads": -(-(H // Hkv) // 2),
        "splits": QA.flat_decode_splits(B, Hkv, H // Hkv, T, sms),
        "shapes": {"checked": f"q ({B},{H},{D}); k/v ({B},{Hkv},{T},{D}) "
                              f"int8 block {bs}; lengths "
                              f"{flushed.tolist()} windows "
                              f"{windows.tolist()}; the seed too",
                   "timed": f"k/v ({B},{Hkv},{T},{D}), lengths {[3072] * B} "
                            f"window {W} (every slot live)"}}
    r = rows["flat_decode_d256"]
    log(f"[flat_decode D256] timed: kernel {ms:.4f} ms "
        f"({r['gb_per_s']:.0f} GB/s of 3350 counting each byte once; the "
        f"G 16 walk reads K/V {r['kv_reads']} times) plain "
        f"{r['plain_ms']:.4f} ms sdpa(bf16) {r['library_ms']:.4f} ms bound "
        f"{bound:.5f} ms ({by}: {nbytes / 1e6:.2f} MB); (splits, slots a "
        f"split) {r['splits']}")
    del k, v, kq, vq, kb, vb
    # the blocked quantizer: a prefill's K and a flush's residual
    x = torch.randn((B, Hkv, S, D), generator=gen, device=dev)
    xf = torch.randn((B, Hkv, bs, D), generator=gen, device=dev)
    for xx in (x, xf):
        got = QK.quantize_blocked_cuda(xx, bs)
        torch.cuda.synchronize()
        if not all(same_bits(g, w) for g, w in zip(
                got, QK.quantize_blocked_plain(xx, bs))):
            raise AssertionError(f"quantize_blocked D256 at "
                                 f"{tuple(xx.shape)}: kernel and plain "
                                 f"version differ (must be bitwise)")
    n = x.numel()
    spec = {"quantize_blocked": (
        lambda: QK.quantize_blocked_cuda(x, bs),
        lambda: QK.quantize_blocked_plain(x, bs),
        4 * n + n + 4 * (n // bs), 6 * n, None,
        "none: no single PyTorch call computes per-(block, channel) scales "
        "and the int8 values together")}
    r = _time_rows(spec, 50, 5)["quantize_blocked"]
    nf = xf.numel()
    r["flush_ms"] = time_cold_ms(lambda: QK.quantize_blocked_cuda(xf, bs),
                                 50)
    r["flush_bound_ms"] = bound_of(5 * nf + 4 * (nf // bs), 6 * nf)[0]
    r.update({"max_abs_err": 0.0, "lanes": QK.blocked_lanes(
        B * Hkv, S, D, bs, sms), "shapes": {
            "checked": f"({B},{Hkv},{S},{D}) and ({B},{Hkv},{bs},{D}) "
                       f"block {bs}, bitwise",
            "timed": f"({B},{Hkv},{S},{D}) block {bs}; the flush "
                     f"({B},{Hkv},{bs},{D})"}})
    rows["quantize_blocked_d256"] = r
    log(f"[quantize_blocked D256] bitwise at ({B},{Hkv},{S},{D}) and "
        f"({B},{Hkv},{bs},{D}); kernel {r['ms']:.4f} ms (bound "
        f"{r['bound_ms']:.5f} ms, {r['bound_by']}) plain {r['plain_ms']:.4f} "
        f"ms; flush {r['flush_ms']:.4f} ms (bound {r['flush_bound_ms']:.5f} "
        f"ms); {r['lanes']} lanes a row")
    return rows


# qwen2_vl_2b's attention at full width: 12 query heads over 2 kv heads at
# D 128 (GQA group 6: 10 positions fill 60 rows of a 64-row tile);
# whisper_small's: 12 / 12 at D 64, 1500 encoder frames, a cross cache of
# 1504 slots (1500 rounded up to 8), 256-token prompts, block 256
G6 = dict(H=12, Hkv=2, D=128, ps=256)
D64 = dict(H=12, D=64, frames=1500, slots=1504, prompt=256, bs=256)


def _timed_row(kern, plain, nbytes, flops, flop_rate, lib, lib_name,
               iters: int = 20, plain_iters: int = 3, **extra) -> dict:
    """A kernel timed with the L2 flushed beside its plain version, its
    bound (bytes at 3.35 TB/s, operations at ``flop_rate``) and one
    PyTorch call (``lib``, or None where none computes the function)."""
    bound, by = bound_of(nbytes, flops, flop_rate)
    ms = time_cold_ms(kern, iters)
    return {"ms": ms, "plain_ms": time_cold_ms(plain, plain_iters),
            "bound_ms": bound, "bound_by": by,
            "library_ms": time_cold_ms(lib, iters) if lib else None,
            "library": lib_name, "bytes": nbytes, "operations": flops,
            **extra}


def _flash_check(label, shape, dt, causal, gen, dev):
    """The flash forward kernel against its plain version (64-key tiles)
    on fresh inputs of (B, H, H_kv, S, T, D): (max |err|, multiple of the
    tolerance, (q, k, v))."""
    import torch
    from repro_torch.kernels import flash_fwd as FF
    q, k, v = _flash_inputs(*shape, dt, gen, dev)
    got = FF.flash_fwd_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    want = FF.flash_fwd_plain(q, k, v, causal, None, 0, FLASH_TILE)
    atol, rtol = ((ATOL_BF16, RTOL_BF16) if dt == torch.bfloat16
                  else (ATOL, RTOL))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ex = max(excess(got[0], want[0], atol, rtol),
             *(excess(g, w) for g, w in zip(got[1:], want[1:])))
    if ex > 1.0 or not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"flash forward {label}: kernel vs plain off "
                             f"by {err:.3e} ({ex:.2f}x tolerance)")
    log(f"[flash_fwd {label}] {shape} {str(dt)[6:]} causal={causal}: "
        f"max_abs_err {err:.3e} ({ex:.3f}x tolerance)")
    return err, ex, (q, k, v)


def _flash_row(label, shape, causal, gen, dev, worst) -> dict:
    """bf16 flash forward at ``shape`` timed beside SDPA on the same
    q / k / v (causal or not, as the path calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_fwd as FF
    err, ex, (q, k, v) = _flash_check(label, shape, torch.bfloat16, causal,
                                      gen, dev)
    B, H, Hkv, S, T, D = shape
    pairs = B * (S * (S + 1) // 2 if causal else S * T)
    flops = 4 * D * H * pairs
    nbytes = (q.numel() + k.numel() + v.numel()) * 2 + B * H * S * D * 4 \
        + 2 * B * H * S * 4
    r = _timed_row(lambda: FF.flash_fwd_cuda(q, k, v, causal),
                   lambda: FF.flash_fwd_plain(q, k, v, causal), nbytes,
                   flops, BF16_FLOP_PER_S,
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=causal, enable_gqa=True),
                   "torch.nn.functional.scaled_dot_product_attention, bf16 "
                   "q/k/v" + (", causal" if causal else ""), iters=10,
                   plain_iters=2, max_abs_err=max(worst[0], err),
                   worst_tol_ratio=max(worst[1], ex))
    r["tflop_per_s"] = flops / r["ms"] / 1e9
    log(f"[flash_fwd {label}] timed {shape} bf16 causal={causal}: kernel "
        f"{r['ms']:.4f} ms ({r['tflop_per_s']:.1f} TFLOP/s of 989) plain "
        f"{r['plain_ms']:.3f} ms sdpa {r['library_ms']:.4f} ms bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB)")
    return r


def _flat_row(label, q, kq, ks, vq, vs, live: int, ref_args, dev) -> dict:
    """Flat decode checked on ``ref_args`` and timed with every row at
    ``live`` slots beside SDPA over the live slots' dequantized bf16 K/V
    (GQA)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quantize as QK
    err, ex = _flat_check(label, ref_args)
    B, H, D = q.shape
    Hkv, T, nb = kq.shape[1], kq.shape[2], ks.shape[2]
    n = torch.full((B,), live, dtype=torch.int32, device=dev)
    w = torch.full((B,), T, dtype=torch.int32, device=dev)
    targs = (q, kq, ks, vq, vs, n, w)
    nbytes = (2 * B * live * Hkv * D + 2 * B * Hkv * nb * D * 4
              + 2 * B * H * D * 4 + 2 * B * H * 4 + 2 * B * 4)
    flops = 4 * D * H * B * live
    kb = QK.dequantize_plain(kq, ks, torch.bfloat16)[:, :, :live]
    vb = QK.dequantize_plain(vq, vs, torch.bfloat16)[:, :, :live]
    qb = q.bfloat16()[:, :, None]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    r = _timed_row(lambda: QA.flat_decode_partials_cuda(*targs),
                   lambda: QA.flat_decode_partials_plain(*targs), nbytes,
                   flops, F32_FLOP_PER_S,
                   lambda: F.scaled_dot_product_attention(
                       qb, kb, vb, enable_gqa=True),
                   "torch.nn.functional.scaled_dot_product_attention over "
                   "pre-dequantized bf16 K/V", iters=50, plain_iters=5,
                   max_abs_err=err, worst_tol_ratio=ex,
                   splits=QA.flat_decode_splits(B, Hkv, H // Hkv, T, sms))
    r["gb_per_s"] = nbytes / r["ms"] / 1e6
    log(f"[flat_decode {label}] max_abs_err {err:.3e} ({ex:.3f}x "
        f"tolerance); timed ({B},{H},{D}) over ({B},{Hkv},{T},{D}) at "
        f"{live} live slots: kernel {r['ms']:.4f} ms ({r['gb_per_s']:.0f} "
        f"GB/s) plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: {nbytes / 1e6:.2f} "
        f"MB); (splits, slots a split) {r['splits']}")
    return r


def check_g6_d64(dev, gen):
    """qwen2_vl_2b's and whisper_small's kernel shapes against the plain
    versions, each timed with the L2 flushed beside its bound and SDPA
    where SDPA computes the same function. GQA group 6 (H / H_kv 12 / 2,
    D 128; the three page formats and both paged dispatches are also in
    check_decode / check_prefill through GROUP_WIDTHS): paged decode
    (int8, 4 rows at 2048 / 1536 / 1024 / 512), paged prefill (int8, C
    1024 over 0-1792 history tokens), flat decode per block (T 2048) and
    the bf16 flash forward at the contiguous prefill's rebuild (4, 12,
    1536, 128) causal. Head width 64 (whisper_small, 12 / 12): the flash
    forward non-causal in bf16 and float32 at the encoder's (4, 12, 1500,
    1500, 64) and cross-attention prefill's S 256 over T 1500 (partial
    last tiles on both axes); flat decode per channel over the 1504-slot
    cross cache at length 1500 with an empty row, and per block over the
    512-slot self cache; `quantize_blocked` bitwise at the self prefill's
    (4, 12, 256, 64) and (4, 12, 512, 64) (1504 is no multiple of the
    256 block); the per-channel pair bitwise at (4, 12, 1504, 64) (zero
    padding past 1500, as the cross cache) and (4, 12, 256, 64). Returns
    {row name: row}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quant_prefill as QP
    from repro_torch.kernels import quantize as QK
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    rows = {}
    H, Hkv, D, ps = (G6[k] for k in ("H", "Hkv", "D", "ps"))
    G, B, NT = H // Hkv, 4, 8
    # paged decode
    n_pages = B * NT + 1
    pool = make_pool("int8", n_pages, Hkv, D, ps, gen, dev)
    table = page_table(B, NT, n_pages, gen, dev)
    t_len = [2048, 1536, 1024, 512]
    tl = i32(t_len)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    args = (q, *pool, table, tl, "int8")
    got = QA.paged_decode_partials_cuda(*args)
    torch.cuda.synchronize()
    want = QA.paged_decode_partials_plain(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ex = max(excess(g, w) for g, w in zip(got, want))
    if ex > 1.0:
        raise AssertionError(f"paged decode G 6: kernel vs plain off by "
                             f"{err:.3e} ({ex:.2f}x tolerance)")
    live = sum(t_len)
    pages = sum(-(-t // ps) for t in t_len)
    nbytes = (kv_bytes(live, Hkv, D, "int8") + 2 * pages * Hkv * D * 4
              + pages * 4 + B * 4 + B * H * D * 4 * 2 + B * H * 8)
    k, v = dequant_bf16(pool, table, "int8")
    mask = (torch.arange(k.shape[2], device=dev)[None]
            < tl[:, None])[:, None, None, :]
    qb = q.bfloat16()[:, :, None]
    r = _timed_row(lambda: QA.paged_decode_partials_cuda(*args),
                   lambda: QA.paged_decode_partials_plain(*args), nbytes,
                   4 * D * H * live, F32_FLOP_PER_S,
                   lambda: F.scaled_dot_product_attention(
                       qb, k, v, attn_mask=mask, enable_gqa=True),
                   "torch.nn.functional.scaled_dot_product_attention over "
                   "pre-dequantized bf16 K/V, lengths as a mask", iters=50,
                   plain_iters=5, max_abs_err=err, worst_tol_ratio=ex)
    r["gb_per_s"] = nbytes / r["ms"] / 1e6
    r["shapes"] = {"checked": f"q ({B},{H},{D}); int8 pages of {ps}; "
                              f"lengths {t_len} (fp8 and int4: "
                              f"check_decode)", "timed": "the same"}
    rows["paged_decode_g6"] = r
    log(f"[decode G6] int8 H/H_kv {H}/{Hkv}: max_abs_err {err:.3e} "
        f"({ex:.3f}x); kernel {r['ms']:.4f} ms ({r['gb_per_s']:.0f} GB/s) "
        f"plain {r['plain_ms']:.4f} ms sdpa {r['library_ms']:.4f} ms bound "
        f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
    del k, v, mask
    # paged prefill: the full chunk of check_prefill at G 6
    C, hl, vd = 1024, [0, 256, 1024, 1792], [1024, 511, 1, 1024]
    err, ex = _prefill_check("paged prefill G 6", B, H, Hkv, C, D, hl, vd,
                             pool, table, ps, "int8", gen, dev)
    hist, valid = i32(hl), i32(vd)
    hb = 1 << (-(-max(hl) // ps) - 1).bit_length()
    q = torch.randn((B, H, C, D), generator=gen, device=dev)
    k = torch.randn((B, Hkv, C, D), generator=gen, device=dev)
    v = torch.randn((B, Hkv, C, D), generator=gen, device=dev)
    qg = (q.reshape(B, Hkv, G * C, D) * QA.logit_scale(D)).contiguous()
    args = (qg, k, v, *pool, table, hist, valid, hb, "int8")
    flops = hflops = 0.0
    nbytes, pages = 0.0, 0
    for b in range(B):
        n = vd[b]
        flops += 4 * D * H * (n * hl[b] + n * (n + 1) // 2)
        hflops += 4 * D * H * n * hl[b]
        pages += -(-hl[b] // ps)
        nbytes += kv_bytes(hl[b], Hkv, D, "int8")
    nbytes += (q.numel() + k.numel() + v.numel()) * 4 \
        + 2 * pages * Hkv * D * 4 + pages * 4 + B * 8 + q.numel() * 4
    kh, vh = dequant_bf16(pool, table[:, :hb], "int8")
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
    r = _timed_row(lambda: QP.paged_prefill_cuda(*args),
                   lambda: QP.paged_prefill_plain(*args), nbytes, flops,
                   F32_FLOP_PER_S,
                   lambda: F.scaled_dot_product_attention(
                       qb, kall, vall, attn_mask=mask, enable_gqa=True),
                   "torch.nn.functional.scaled_dot_product_attention over "
                   "pre-dequantized bf16 history + the chunk, mask",
                   iters=10, plain_iters=2, max_abs_err=err,
                   worst_tol_ratio=ex)
    tc_flops = 3 * hflops + 6 * (flops - hflops)
    r["bound_tc_ms"] = bound_of(nbytes, tc_flops, BF16_FLOP_PER_S)[0]
    r["tflop_per_s"] = flops / r["ms"] / 1e9
    r["shapes"] = {"checked": f"C={C} q ({B},{H},{C},{D}) hist_len {hl} "
                              f"valid {vd}, int8 (fp8, int4 and C 512: "
                              f"check_prefill)", "timed": "the same"}
    rows["paged_prefill_g6"] = r
    log(f"[prefill G6] int8 H/H_kv {H}/{Hkv} C={C} ({G * C} query rows a "
        f"kv head): max_abs_err {err:.3e} ({ex:.3f}x), row tiles past valid "
        f"0.0; kernel {r['ms']:.4f} ms ({r['tflop_per_s']:.1f} TFLOP/s "
        f"counted f32) plain {r['plain_ms']:.3f} ms sdpa "
        f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']}); the design's bound {r['bound_tc_ms']:.5f} ms")
    del q, k, v, qg, kall, vall, mask, pool
    # flat decode per block, T 2048
    T, bs = 2048, 256
    k = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    kq, ks, vq, vs = _flat_quant("per_block", k, v, bs)
    r = _flat_row("G6 per_block", q, kq, ks, vq, vs, T,
                  (q, kq, ks, vq, vs, i32([2048, 1280, 0, 1000]),
                   i32([T] * B)), dev)
    r["shapes"] = {"checked": f"q ({B},{H},{D}); k/v ({B},{Hkv},{T},{D}) "
                              f"int8 block {bs}; lengths [2048, 1280, 0, "
                              f"1000]", "timed": f"lengths {[T] * B}"}
    rows["flat_decode_g6"] = r
    del k, v, kq, vq
    # the flash forward at the contiguous prefill's rebuild
    shape = (4, H, Hkv, 1536, 1536, D)
    e32, x32, _ = _flash_check("G6", (1, H, Hkv, 999, 999, D),
                               torch.float32, True, gen, dev)
    r = _flash_row("G6", shape, True, gen, dev, (e32, x32))
    r["shapes"] = {"checked": f"{shape} bf16 causal; (1,{H},{Hkv},999,999,"
                              f"{D}) float32 causal",
                   "timed": f"{shape} bf16 causal"}
    rows["flash_fwd_g6"] = r
    # -- head width 64 (whisper_small) --------------------------------------
    H, D, S, Tc, P, bs = (D64[k] for k in ("H", "D", "frames", "slots",
                                           "prompt", "bs"))
    worst = [0.0, 0.0]
    for shape in ((4, H, H, P, S, D), (1, H, H, 37, S, D)):
        for dt in (torch.bfloat16, torch.float32):
            e, x, _ = _flash_check("D64 cross", shape, dt, False, gen, dev)
            worst = [max(worst[0], e), max(worst[1], x)]
    e, x, _ = _flash_check("D64 encoder", (2, H, H, S, S, D), torch.float32,
                           False, gen, dev)
    worst = [max(worst[0], e), max(worst[1], x)]
    shape = (4, H, H, S, S, D)
    r = _flash_row("D64 encoder", shape, False, gen, dev, worst)
    cross = _flash_row("D64 cross", (4, H, H, P, S, D), False, gen, dev,
                       worst)
    r.update({"cross_" + k: cross[k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "tflop_per_s")})
    r["shapes"] = {"checked": f"{shape} bf16 and (2,{H},{H},{S},{S},{D}) "
                              f"float32 non-causal; (4,{H},{H},{P},{S},{D})"
                              f" and (1,{H},{H},37,{S},{D}) both dtypes",
                   "timed": f"encoder {shape} bf16 non-causal; cross_*: "
                            f"(4,{H},{H},{P},{S},{D})"}
    rows["flash_fwd_d64"] = r
    # flat decode per channel over the cross cache, and per block over the
    # self cache
    k = torch.zeros((B, H, Tc, D), device=dev)
    v = torch.zeros((B, H, Tc, D), device=dev)
    k[:, :, :S] = torch.randn((B, H, S, D), generator=gen, device=dev)
    v[:, :, :S] = torch.randn((B, H, S, D), generator=gen, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev)
    kq, ks, vq, vs = _flat_quant("per_channel", k, v, bs)
    r = _flat_row("D64 cross per_channel", q, kq, ks, vq, vs, S,
                  (q, kq, ks, vq, vs, i32([S, S, 0, S]), i32([Tc] * B)),
                  dev)
    ks2 = torch.randn((B, H, 512, D), generator=gen, device=dev)
    vs2 = torch.randn((B, H, 512, D), generator=gen, device=dev)
    e, x = _flat_check("flat decode D64 self per_block", (
        q, *_flat_quant("per_block", ks2, vs2, bs), i32([256, 512, 0, 300]),
        i32([512] * B)))
    r["max_abs_err"] = max(r["max_abs_err"], e)
    r["worst_tol_ratio"] = max(r["worst_tol_ratio"], x)
    r["shapes"] = {"checked": f"q ({B},{H},{D}); per channel k/v "
                              f"({B},{H},{Tc},{D}) lengths [{S}, {S}, 0, "
                              f"{S}]; per block 256 ({B},{H},512,{D}) "
                              f"lengths [256, 512, 0, 300]",
                   "timed": f"per channel, every row at {S} of {Tc}"}
    rows["flat_decode_d64"] = r
    # the quantizers
    xp = torch.randn((B, H, P, D), generator=gen, device=dev)
    x512 = torch.randn((B, H, 512, D), generator=gen, device=dev)
    for xx in (xp, x512):
        if not all(same_bits(g, w) for g, w in zip(
                QK.quantize_blocked_cuda(xx, bs),
                QK.quantize_blocked_plain(xx, bs))):
            raise AssertionError(f"quantize_blocked D64 at "
                                 f"{tuple(xx.shape)}: kernel and plain "
                                 f"version differ (must be bitwise)")
    n = xp.numel()
    r = _time_rows({"quantize_blocked": (
        lambda: QK.quantize_blocked_cuda(xp, bs),
        lambda: QK.quantize_blocked_plain(xp, bs), 5 * n + 4 * (n // bs),
        6 * n, None, "none: no single PyTorch call computes per-(block, "
        "channel) scales and the int8 values together")}, 50, 5)
    r = r["quantize_blocked"]
    r.update({"max_abs_err": 0.0, "shapes": {
        "checked": f"({B},{H},{P},{D}) and ({B},{H},512,{D}) block {bs}, "
                   f"bitwise", "timed": f"({B},{H},{P},{D}) block {bs}"}})
    rows["quantize_blocked_d64"] = r
    small = per_channel_rows(xp, 20, 3)      # bitwise at the prompt's shape
    pair = per_channel_rows(k, 50, 5)        # and at the cross cache's
    for name in PAIR:
        pair[name].update({"max_abs_err": 0.0, "shapes": {
            "checked": f"({B},{H},{Tc},{D}) (zero past {S}) and "
                       f"({B},{H},{P},{D}), bitwise",
            "timed": f"({B},{H},{Tc},{D})"},
            "pair_ms": pair["pair"]["ms"],
            "pair_bound_ms": pair["pair"]["bound_ms"],
            "prompt_shape_ms": small[name]["ms"]})
        rows[f"{name}_d64"] = pair[name]
    log(f"[quantize D64] blocked bitwise at ({B},{H},{P},{D}) and "
        f"({B},{H},512,{D}): {rows['quantize_blocked_d64']['ms']:.4f} ms "
        f"(bound {rows['quantize_blocked_d64']['bound_ms']:.5f}); the pair "
        f"bitwise at ({B},{H},{Tc},{D}) and ({B},{H},{P},{D}): absmax "
        f"{pair['absmax']['ms']:.4f} + quantize_with_scales "
        f"{pair['quantize_with_scales']['ms']:.4f} ms, back to back "
        f"{pair['pair']['ms']:.4f} ms (bound {pair['pair']['bound_ms']:.5f}"
        f" ms)")
    return rows


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


# (temperature, top_k, top_p, seed) mixes of the sampled phases: a greedy
# row beside the three sampled settings chip_smoke serves
SAMPLED_MIX = [dict(temperature=0.0),
               dict(temperature=0.7, top_k=50, seed=11),
               dict(temperature=1.0, top_p=0.9, seed=12),
               dict(temperature=0.8, top_k=40, top_p=0.95, seed=None)]


def draw_gap(params, cfg, hist, sp, uid: int, step: int) -> float:
    """Diagnosis of a token that differs between card and CPU: the gap
    between the two largest perturbed logits (filtered logits plus the
    gumbel noise of ``fold_in(key, step)``; the raw logits for a greedy
    row) of the draw that follows ``hist``, on the CPU. A gap within ~1e-6
    is a near-tie that float32 rounding may decide either way."""
    import numpy as np
    import torch
    from repro_torch.models import prng
    from repro_torch.models import sampling as SMP
    from repro_torch.models import transformer as T
    from repro_torch.serving.params import request_key
    toks = torch.as_tensor(np.asarray(hist, np.int32))[None]
    bs = cfg.quant.block_size
    state = T.init_decode_state(cfg, 1, -(-(toks.shape[1] + 1) // bs) * bs,
                                device="cpu")
    S0 = toks.shape[1] // bs * bs
    if S0:
        logits, state = T.prefill(params, toks[:, :S0], cfg, state)
    pos = torch.full((1,), S0, dtype=torch.int32)
    for j in range(S0, toks.shape[1]):
        logits, state = T.decode_step(params, toks[:, j:j + 1], cfg, state,
                                      pos)
        pos = pos + 1
    z = logits[:, :cfg.vocab].float()
    if not sp.is_greedy:
        z = SMP._filter_logits(z / sp.temperature,
                               torch.tensor([sp.top_k], dtype=torch.int32),
                               torch.tensor([sp.top_p], dtype=torch.float32))
        key = torch.as_tensor(request_key(uid, sp).astype(np.int64))[None]
        z = z + prng.gumbel(SMP.fold_keys(key, torch.tensor([step])),
                            cfg.vocab)
    top = torch.topk(z[0], 2).values
    return float(top[0] - top[1])


def _first_difference(cpu, card):
    for r, (a, b) in enumerate(zip(cpu, card)):
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return r, j
        if len(a) != len(b):
            return r, min(len(a), len(b))
    return None


def parity_sampling(dev):
    """Phase 4, sampling and the prefix cache: threefry on the card against
    the committed known answers and the CPU; then the smoke model in
    float32, card (kernels) against CPU (plain versions): seeded sampled
    requests mixed with greedy ones through the paged and the contiguous
    LLMEngine, sampled `generate`, and the prefix-cache protocols of
    tests/test_prefix_cache.py (hit against miss, a prefix shared across
    requests) with their counters. A differing token fails after its step
    and draw gap are printed."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import prng
    from repro_torch.models import transformer as T
    from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams,
                                     generate)
    key = prng.fold_in(prng.PRNGKey(7, device=dev), 3)
    bits = prng.random_bits(key, 4)
    if (tuple(key.tolist()) != prng.KNOWN_FOLD_7_3
            or tuple(bits.tolist()) != prng.KNOWN_BITS_7_3):
        raise AssertionError(f"threefry on the card: fold_in(PRNGKey(7), 3) "
                             f"= {key.tolist()}, bits {bits.tolist()}; want "
                             f"{prng.KNOWN_FOLD_7_3}, {prng.KNOWN_BITS_7_3}")
    keys = torch.stack([prng.fold_in(prng.PRNGKey(s), j) for s, j in
                        ((0, 0), (11, 5), (12, 47), (2**31 - 1, 9))])
    if not torch.equal(prng.random_bits(keys.to(dev), 92544).cpu(),
                       prng.random_bits(keys, 92544)):
        raise AssertionError("threefry bits at (4, 92544): card != CPU")
    log("[parity] threefry on the card: the committed known answers of jax "
        "0.9 and (4, 92544) bits bit for bit against the CPU")

    base = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                               dtype="float32")
    params = T.init_params(base, torch.Generator().manual_seed(0),
                           device="cpu")
    on = {"cpu": params, str(dev): _to(params, dev)}
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, base.vocab, (n,)).astype(np.int32)
               for n in (13, 70, 5, 40, 21)]
    sps = [SamplingParams(max_new_tokens=n, **SAMPLED_MIX[i % 4])
           for i, n in enumerate((8, 9, 5, 7, 8))]

    def check(label, streams, hists=None):
        at = _first_difference(streams["cpu"], streams[str(dev)])
        if at is None:
            return
        r, j = at
        msg = (f"smoke f32 {label}: tokens differ at request {r}, step {j}: "
               f"cpu {streams['cpu'][r]} vs card {streams[str(dev)][r]}")
        if hists is not None:
            hist = np.concatenate([hists[r], streams["cpu"][r][:j]])
            gap = draw_gap(params, base, hist, sps[r], r, j)
            msg += f"; the draw's two leading perturbed logits {gap:.3e} apart"
        log(f"[parity] {msg}")
        raise AssertionError(msg)

    for paged in (True, False):
        label = "paged" if paged else "contiguous"
        streams = {d: [o.token_ids for o in LLMEngine(
            p, base, EngineConfig(batch=2, max_len=128, paged=paged),
            device=d).generate(prompts, sps)] for d, p in on.items()}
        check(f"sampled {label}", streams, prompts)
        log(f"[parity] smoke f32 sampled {label}: "
            f"{sum(map(len, streams['cpu']))} tokens of greedy and seeded "
            f"sampled requests identical on cpu and card")
    batch = np.stack([p[:13] for p in (prompts[0], prompts[1], prompts[3],
                                       prompts[4])])
    gen_sps = [SamplingParams(**kw) for kw in SAMPLED_MIX]
    streams = {d: generate(p, base, batch, steps=8, sampling=gen_sps,
                           device=d).cpu().tolist() for d, p in on.items()}
    check("sampled generate", streams)
    log("[parity] smoke f32 sampled generate: 4x8 tokens identical on cpu "
        "and card")

    rng = np.random.RandomState(1)
    prompt = rng.randint(0, base.vocab, (40,)).astype(np.int32)
    shared = rng.randint(0, base.vocab, (32,)).astype(np.int32)
    tails = [np.concatenate([shared, rng.randint(0, base.vocab, (8,))])
             .astype(np.int32) for _ in range(3)]
    greedy = SamplingParams.greedy
    streams, counters = {}, {}
    for d, p in on.items():
        cfg = EngineConfig(batch=1, max_len=64, paged=True,
                           prefix_cache=True, prefill_chunk=16)
        eng = LLMEngine(p, base, cfg, device=d)
        toks = [eng.generate([prompt], greedy(max_new_tokens=6))[0].token_ids
                for _ in range(2)]
        rep = eng.pool_report()
        eng = LLMEngine(p, base, dataclasses.replace(cfg, batch=2),
                        device=d)
        toks += [o.token_ids for o in eng.generate(
            tails, greedy(max_new_tokens=4))]
        rep2 = eng.pool_report()
        streams[d] = toks
        counters[d] = [{k: r[k] for k in ("page_hits", "page_misses",
                                          "reclaims", "cow_retargets",
                                          "pages_cached", "pages_free",
                                          "prefill_tokens_computed")}
                       for r in (rep, rep2)]
    check("prefix cache", streams)
    c = counters[str(dev)]
    if c != counters["cpu"] or streams["cpu"][0] != streams["cpu"][1] \
            or c[0]["page_hits"] < 1 or c[1]["page_hits"] < 1:
        raise AssertionError(f"smoke f32 prefix cache: counters cpu "
                             f"{counters['cpu']} card {c}, tokens "
                             f"{streams['cpu']}")
    log(f"[parity] smoke f32 prefix cache: hit against miss and a shared "
        f"prefix, tokens and counters identical on cpu and card "
        f"({json.dumps(c)})")


def _overload_report(rep: dict) -> dict:
    """A pool report without its wall-clock TTFT percentiles."""
    return {k: v for k, v in rep.items() if not k.startswith("ttft")}


def overload_protocols(params, cfg, d) -> dict:
    """The overload protocols of tests/test_overload.py on device ``d``
    (the smoke model): fast resume (``hold_pages`` 18 over ticks 12-30
    against the same run unpressured), recompute resume (the suspended
    row's cached pages reclaimed before re-admission), transient
    allocation faults and delayed reclaim (each against a fault-free run).
    Returns each protocol's tokens and pool reports."""
    import numpy as np
    from repro_torch.core.paging import PoolFaultInjector
    from repro_torch.serving import (ContinuousBatcher, EngineConfig,
                                     Request, SamplingParams)
    rng = np.random.RandomState(0)
    p0, p1 = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
              for n in (9, 11)]
    greedy = SamplingParams.greedy

    def batcher(inj, **kw):
        return ContinuousBatcher(params, cfg, EngineConfig(
            max_len=64, paged=True, chunk=1, fault_injector=inj, **kw),
            device=d)

    def resume_run(pressure: bool, recompute: bool):
        inj = PoolFaultInjector(seed=1)
        b = batcher(inj, batch=2, n_pages=24, prefix_cache=True,
                    watermark=1)
        b.submit(Request(uid=0, prompt=p0,
                         sampling=greedy(max_new_tokens=20)))
        b.submit(Request(uid=1, prompt=p1, sampling=(
            greedy(max_new_tokens=20) if recompute else SamplingParams(
                temperature=0.9, seed=7, max_new_tokens=20))))
        outs, snap = {}, None
        for t in range(400):
            if pressure and t == 12:
                inj.hold_pages = 18
            if pressure and not recompute and t == 30:
                inj.hold_pages = 0
            if recompute and t == 16 and b._suspended and snap is None:
                uid = next(iter(b._suspended))
                s = b._suspended[uid]
                snap = [uid, [int(x) for x in s["full_toks"]], s["pending"]]
                inj.hold_pages = 0
                b.allocator.release(b.allocator.alloc(b.allocator.available))
            for r in b.step():
                outs[r.uid] = list(r.generated)
            if len(outs) == 2:
                return {"tokens": outs, "snapshot": snap,
                        "report": _overload_report(b.pool_report())}
        raise AssertionError(f"overload protocol on {d}: requests did not "
                             f"complete")

    def drain_three(inj, **kw):
        b = batcher(inj, **kw)
        for u, n in enumerate((9, 11, 7)):
            b.submit(Request(uid=u, prompt=np.random.RandomState(u).randint(
                0, cfg.vocab, (n,)).astype(np.int32),
                sampling=greedy(max_new_tokens=8)))
        done = b.run_to_completion(max_ticks=800)
        return {"tokens": {r.uid: r.generated for r in done},
                "report": _overload_report(b.pool_report())}

    return {
        "fast resume": [resume_run(False, False), resume_run(True, False)],
        "recompute resume": [resume_run(True, True)],
        "transient alloc faults": [
            drain_three(None, batch=2, n_pages=24, prefix_cache=True),
            drain_three(PoolFaultInjector(seed=11, p_alloc_fail=0.5),
                        batch=2, n_pages=24, prefix_cache=True)],
        "delayed reclaim": [
            drain_three(None, batch=1, n_pages=8),
            drain_three(PoolFaultInjector(seed=3, reclaim_delay=3),
                        batch=1, n_pages=8)]}


def parity_overload(dev):
    """Phase 4, overload: `overload_protocols` on the CPU (plain versions)
    and on the card (kernels), the smoke model in float32. Tokens and pool
    reports must be identical, and each protocol must do what it claims:
    the fast resume gives the unpressured streams, the recompute resume
    keeps the prefix and the pending token, the faults fire and change no
    token."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    base = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                               dtype="float32")
    params = T.init_params(base, torch.Generator().manual_seed(0),
                           device="cpu")
    runs = {"cpu": overload_protocols(params, base, "cpu"),
            "card": overload_protocols(_to(params, dev), base, dev)}
    for name, cpu in runs["cpu"].items():
        card = runs["card"][name]
        if card != cpu:
            raise AssertionError(f"smoke f32 overload {name}: card != cpu: "
                                 f"cpu {cpu} card {card}")
    r = runs["card"]
    base_run, pressured = r["fast resume"]
    rep = pressured["report"]
    if base_run["report"]["preemptions"] or rep["preemptions"] < 1 \
            or rep["preempt_fast_resumes"] < 1 \
            or pressured["tokens"] != base_run["tokens"]:
        raise AssertionError(f"smoke f32 fast resume: {r['fast resume']}")
    (rec,) = r["recompute resume"]
    uid, full, pending = rec["snapshot"]
    S = (9, 11)[uid]
    got = rec["tokens"][uid]
    n = len(full) - S
    if rec["report"]["preempt_recompute_resumes"] < 1 \
            or got[:n] != full[S:] or got[n] != pending or len(got) != 20:
        raise AssertionError(f"smoke f32 recompute resume: {rec}")
    for name, key in (("transient alloc faults",
                       "injected_alloc_fault_ticks"),
                      ("delayed reclaim", "injected_delayed_releases")):
        clean, faulty = r[name]
        if faulty["tokens"] != clean["tokens"] or faulty["report"][key] < 1:
            raise AssertionError(f"smoke f32 {name}: {r[name]}")
    log(f"[parity] smoke f32 overload: fast resume (= unpressured, greedy "
        f"and seeded; {rep['preemptions']} preemption(s)), recompute resume "
        f"(prefix and pending token kept), transient alloc faults "
        f"({r['transient alloc faults'][1]['report']['injected_alloc_fault_ticks']} blocked "
        f"ticks) and delayed reclaim, tokens and pool reports identical on "
        f"cpu and card")


def tiering_protocols(params, cfg, d) -> dict:
    """The tier protocols of tests/test_tiering.py on device ``d`` (the
    smoke model, host tier of 32 pages): hit == miss (three shared
    prefixes revisited through a pool of 9 pages, with the "lru" and the
    "freq" evictor and with a 3-page tier whose capacity LRU drops records
    and reuses their host slots, against a run without the tier); the
    forced swap restore (a greedy and a seeded row preempted after 10
    tokens, every cached page then reclaimed: with the tier, without it,
    and with every swap lost, against the unpressured run); swap_delay 3
    riding the in-flight population; a demote / promote interleaving; and
    the dtype flip (int8 -> fp8_e4m3 idle, against an engine built on
    fp8_e4m3; the error of a flip with a row resident). Returns tokens and
    reports."""
    import numpy as np
    from repro_torch.core.paging import PoolFaultInjector
    from repro_torch.serving import (ContinuousBatcher, EngineConfig,
                                     Request, SamplingParams)
    greedy = SamplingParams.greedy

    def batcher(**kw):
        return ContinuousBatcher(params, cfg, EngineConfig(
            batch=2, max_len=64, paged=True, chunk=1, **kw), device=d)

    def population(a):
        return [sorted(a.free), sorted(a.lru), sorted(a.inflight),
                sorted(a.ref), sorted(a.deferred)]

    def grouped(host_pages, evictor="lru", b=None):
        b = b or batcher(n_pages=10, prefix_cache=True, prefill_chunk=8,
                         watermark=1, host_pages=host_pages, evictor=evictor)
        rng = np.random.RandomState(0)
        shared = [rng.randint(0, cfg.vocab, (24,)).astype(np.int32)
                  for _ in range(3)]
        outs, uid = {}, 0
        for _ in range(2):
            for g in shared:
                p = np.concatenate([g, rng.randint(0, cfg.vocab, (4,))
                                    .astype(np.int32)])
                b.submit(Request(uid=uid, prompt=p,
                                 sampling=greedy(max_new_tokens=4)))
                uid += 1
                for _t in range(300):
                    for r in b.step():
                        outs[r.uid] = list(r.generated)
                    if uid == len(outs):
                        break
        return outs, b

    def submit_pair(b, n=(17, 19)):
        rng = np.random.RandomState(3)
        p0 = rng.randint(0, cfg.vocab, (n[0],)).astype(np.int32)
        p1 = rng.randint(0, cfg.vocab, (n[1],)).astype(np.int32)
        b.submit(Request(uid=0, prompt=p0, sampling=greedy(max_new_tokens=16)))
        b.submit(Request(uid=1, prompt=p1, sampling=SamplingParams(
            temperature=0.9, seed=7, max_new_tokens=16)))

    def drain(b, outs):
        for _ in range(400):
            for r in b.step():
                outs[r.uid] = list(r.generated)
            if len(outs) == 2:
                return outs
        raise AssertionError(f"tier protocol on {d}: requests did not "
                             f"complete")

    def forced(inj=None, host_pages=32):
        b = batcher(n_pages=24, prefix_cache=True, watermark=1,
                    host_pages=host_pages, fault_injector=inj)
        submit_pair(b)
        outs = {}
        for _ in range(200):
            for r in b.step():
                outs[r.uid] = list(r.generated)
            rows = [r for r in b.rows if r is not None]
            if len(rows) == 2 and not b.prefilling \
                    and all(len(r.generated) >= 10 for r in rows):
                break
        for i in (0, 1):
            b._preempt_row(i)
        a = b.allocator
        a.release(a.alloc(len(a.free) + len(a.lru)))
        return {"tokens": drain(b, outs),
                "report": _overload_report(b.pool_report())}

    base = batcher(n_pages=24, prefix_cache=True, watermark=1)
    submit_pair(base)
    base = drain(base, {})
    b = batcher(n_pages=24, prefix_cache=True, watermark=1, host_pages=32,
                fault_injector=PoolFaultInjector(5, swap_delay=3))
    b.submit(Request(uid=0, prompt=np.random.RandomState(3).randint(
        0, cfg.vocab, (17,)).astype(np.int32),
        sampling=greedy(max_new_tokens=16)))
    for _ in range(200):
        b.step()
        if b.rows[0] is not None and 0 not in b.prefilling \
                and len(b.rows[0].generated) >= 10:
            break
    b._preempt_row(0)
    a = b.allocator
    a.release(a.alloc(len(a.free) + len(a.lru)))
    waits, delayed = [], {}
    for _ in range(400):
        for r in b.step():
            delayed[r.uid] = list(r.generated)
        if a.inflight:
            waits.append(b._stuck_report())
        if delayed:
            break
    _, g = grouped(32)
    a, tier = g.allocator, g._tiering
    a.injector = PoolFaultInjector(9, swap_delay=2)
    trace = []
    for step in range(12):
        if step % 3 == 0 and len(a.lru):
            page = next(iter(a.lru))
            trace.append(g._demote_to_host(page, a.hash_of[page]))
        elif step % 3 == 1:
            for h in list(tier.pages):
                if h not in a.index and h not in a.inflight_digests \
                        and a.available > 0:
                    trace.append(g._issue_prefetch([h], 0, 1))
                    break
        else:
            a.tick()
        trace.append(population(a))
    for _ in range(6):
        a.tick()
    trace.append(population(a))
    flip = batcher(n_pages=24, prefill_chunk=8)
    submit_pair(flip, (11, 11))
    first = drain(flip, {})
    flip.config.kv_cache_dtype = "fp8_e4m3"
    submit_pair(flip, (11, 11))
    flipped = drain(flip, {})
    fresh = batcher(n_pages=24, prefill_chunk=8, kv_cache_dtype="fp8_e4m3")
    submit_pair(fresh, (11, 11))
    resident = batcher(n_pages=24)
    submit_pair(resident)
    resident.step()
    resident.config.kv_cache_dtype = "int4"
    try:
        resident.step()
        flip_error = None
    except RuntimeError as e:
        flip_error = str(e)
    return {
        "hit == miss": [grouped(None)[0]] + [
            {"tokens": o, "report": _overload_report(gb.pool_report())}
            for o, gb in (grouped(n, ev) for n, ev in (
                (32, "lru"), (32, "freq"), (3, "lru")))],
        "swap restore": [base, forced(), forced(host_pages=None)],
        "swap fault": [forced(PoolFaultInjector(5, p_swap_fail=1.0))],
        "swap delay": [delayed, waits, _overload_report(b.pool_report())],
        "interleaving": [trace, _overload_report(g.pool_report())],
        "dtype flip": [first, flipped, drain(fresh, {}), flip_error]}


def parity_tiering(dev):
    """Phase 4, the tiered cache: `tiering_protocols` on the CPU (plain
    versions) and on the card (kernels, pinned host tier, stream-ordered
    copies), the smoke model in float32. Tokens, reports, stuck reports
    and populations must be identical, and each protocol must do what it
    claims: the tier's runs give the runs without it, the swap restores
    give the unpressured streams, a lost swap recomputes, a delayed swap
    swap-waits, the idle flip serves the fresh engine's tokens."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    base = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                               dtype="float32")
    params = T.init_params(base, torch.Generator().manual_seed(0),
                           device="cpu")
    runs = {"cpu": tiering_protocols(params, base, "cpu"),
            "card": tiering_protocols(_to(params, dev), base, dev)}
    for name, cpu in runs["cpu"].items():
        if runs["card"][name] != cpu:
            raise AssertionError(f"smoke f32 tier {name}: card != cpu: cpu "
                                 f"{cpu} card {runs['card'][name]}")
    r = runs["card"]
    plain, lru, freq, small = r["hit == miss"]
    if any(x["tokens"] != plain for x in (lru, freq, small)) or any(
            x["report"][k] < 1 for x in (lru, freq, small)
            for k in ("demotions", "promotions", "prefetch_page_hits")) \
            or small["report"]["host_evictions"] < 1:
        raise AssertionError(f"smoke f32 tier hit == miss: {r['hit == miss']}")
    base, swapped, recomputed = r["swap restore"]
    if swapped["tokens"] != base or recomputed["tokens"] != base \
            or swapped["report"]["preempt_swap_restores"] != 2 \
            or swapped["report"]["preempt_recompute_resumes"] \
            or recomputed["report"]["preempt_recompute_resumes"] < 1:
        raise AssertionError(f"smoke f32 swap restore: {r['swap restore']}")
    (faulted,) = r["swap fault"]
    if faulted["tokens"] != swapped["tokens"] \
            or faulted["report"]["injected_swap_faults"] < 1 \
            or faulted["report"]["preempt_swap_restores"]:
        raise AssertionError(f"smoke f32 swap fault: {faulted}")
    delayed, waits, rep = r["swap delay"]
    if delayed.get(0) != base[0] or not waits \
            or not all("swap-wait" in w for w in waits) \
            or rep["pages_inflight"]:
        raise AssertionError(f"smoke f32 swap delay: {r['swap delay']}")
    trace, rep = r["interleaving"]
    if trace[-1][2] or rep["prefetch_issued"] < 1:
        raise AssertionError(f"smoke f32 interleaving: {r['interleaving']}")
    first, flipped, fresh, err = r["dtype flip"]
    if flipped != fresh or not err or "resident" not in err:
        raise AssertionError(f"smoke f32 dtype flip: {r['dtype flip']}")
    log(f"[parity] smoke f32 tiered cache: hit == miss through the host "
        f"tier (lru, freq, a 3-page tier: {lru['report']['promotions']} / "
        f"{freq['report']['promotions']} / {small['report']['promotions']} "
        f"promotions, {small['report']['host_evictions']} host evictions), "
        f"swap restore of a "
        f"greedy and a seeded row (= unpressured, 2 swap restores), swap "
        f"fault -> recompute, swap_delay in flight ({len(waits)} swap-wait "
        f"ticks), demote/promote interleaving, dtype flip int8 -> fp8_e4m3 "
        f"(= fresh engine; resident flip raises): tokens, reports and "
        f"populations identical on cpu and card")


P24_DTYPES = ("int8", "fp8_e4m3", "int4") * 8   # serve paged mixed's plan


def mixed_protocols(params, cfg, d, plan) -> dict:
    """Mixed-plan protocols on device ``d`` (the smoke model at
    len(plan) layers): five prompts on 2 rows with the prefix cache
    (tokens, report), prefix hit == miss, the submit contract (a request
    naming a dtype is rejected), the idle flips int8 -> plan -> int8
    (against a fresh plan engine and the first int8 run), and the grouped
    revisit through a 6-page host tier with host_tier_dtype None and int4
    (tokens, reports, the first record's per-layer dtypes and bytes)."""
    import numpy as np
    from repro_torch.serving import (ContinuousBatcher, EngineConfig,
                                     Request, SamplingParams)
    greedy = SamplingParams.greedy

    def batcher(**kw):
        kw.setdefault("max_len", 128)
        return ContinuousBatcher(params, cfg, EngineConfig(
            batch=2, paged=True, **kw), device=d)

    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 70, 5, 40, 21)]

    def serve(b, uid0=0, ps=prompts, max_new=6):
        for i, p in enumerate(ps):
            b.submit(Request(uid=uid0 + i, prompt=p,
                             sampling=greedy(max_new_tokens=max_new)))
        return {r.uid - uid0: list(r.generated)
                for r in b.run_to_completion(600)}

    out = {}
    b = batcher(prefix_cache=True, prefill_chunk=16, kv_cache_dtype=plan)
    out["serve"] = [serve(b), _overload_report(b.pool_report())]
    miss = serve(b, 10, prompts[1:2])
    out["hit == miss"] = [miss, serve(b, 20, prompts[1:2]),
                          _overload_report(b.pool_report())]
    try:
        b.submit(Request(uid=99, prompt=prompts[0],
                         sampling=greedy(kv_cache_dtype="int8")))
        out["submit"] = None
    except ValueError as e:
        out["submit"] = [str(e), len(b.queue)]
    f = batcher(prefill_chunk=16)
    first = serve(f, 0, prompts[:2])
    f.config.kv_cache_dtype = plan
    flipped = serve(f, 10, prompts[:2])
    fresh = serve(batcher(prefill_chunk=16, kv_cache_dtype=plan), 10,
                  prompts[:2])
    f.config.kv_cache_dtype = "int8"
    out["flips"] = [first, flipped, fresh, serve(f, 20, prompts[:2])]
    for htd in (None, "int4"):
        g = batcher(max_len=64, n_pages=10, chunk=1, prefix_cache=True,
                    prefill_chunk=8, watermark=1, host_pages=6,
                    host_tier_dtype=htd, kv_cache_dtype=plan)
        shared = [rng.randint(0, cfg.vocab, (24,)).astype(np.int32)
                  for _ in range(3)]
        toks = {}
        for r_ in range(2):
            for j, s in enumerate(shared):
                p = np.concatenate([s, rng.randint(0, cfg.vocab, (4,))
                                    .astype(np.int32)])
                toks.update(serve(g, 100 * r_ + 10 * j, [p], 4))
        rec = next(iter(g._tiering.pages.values()))
        out[f"tier {htd}"] = [toks, _overload_report(g.pool_report()),
                              list(rec.dtypes), rec.nbytes]
    return out


def parity_mixed(dev):
    """Phase 4, mixed per-layer precision plans: `mixed_protocols` on the
    CPU (plain versions) and on the card (kernels) for PLAN2 ("int8",
    "int4") on the 2-layer smoke model and ("int8", "fp8_e4m3", "int4")
    on a 3-layer one, float32: tokens, reports and error texts identical,
    and each protocol doing what it claims (hit == miss, the flips serve
    the fresh plan engine's and the first run's tokens, a dtype request
    rejected before queueing, the tier promoting with per-layer records)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    for plan in (("int8", "int4"), ("int8", "fp8_e4m3", "int4")):
        base = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                                   dtype="float32", n_layers=len(plan))
        params = T.init_params(base, torch.Generator().manual_seed(0),
                               device="cpu")
        runs = {"cpu": mixed_protocols(params, base, "cpu", plan),
                "card": mixed_protocols(_to(params, dev), base, dev, plan)}
        for name, cpu in runs["cpu"].items():
            if runs["card"][name] != cpu:
                raise AssertionError(
                    f"smoke f32 mixed {plan} {name}: card != cpu: cpu {cpu} "
                    f"card {runs['card'][name]}")
        r = runs["card"]
        toks, rep = r["serve"]
        miss, hit, hrep = r["hit == miss"]
        first, flipped, fresh, back = r["flips"]
        if rep["kv_cache_dtype"] != "mixed" \
                or rep["kv_cache_layer_dtypes"] != list(plan) \
                or any(len(t) != 6 for t in toks.values()) \
                or miss != hit or hrep["page_hits"] < 1 \
                or flipped != fresh or back != first \
                or not r["submit"] or "plan" not in r["submit"][0] \
                or r["submit"][1]:
            raise AssertionError(f"smoke f32 mixed {plan}: {r}")
        for htd in (None, "int4"):
            _, trep, dtypes, _ = r[f"tier {htd}"]
            if trep["promotions"] < 1 or dtypes != [htd or dt
                                                    for dt in plan]:
                raise AssertionError(f"smoke f32 mixed {plan} tier {htd}: "
                                     f"{r[f'tier {htd}']}")
        log(f"[parity] smoke f32 mixed plan {'/'.join(plan)}: served (5 "
            f"requests, pool_report 'mixed'), hit == miss, flips int8 -> "
            f"plan -> int8 (= fresh plan engine, = first run), a dtype "
            f"request rejected, host tier {r['tier None'][1]['promotions']} / "
            f"{r['tier int4'][1]['promotions']} promotions (records "
            f"{r['tier None'][3]} / {r['tier int4'][3]} bytes): tokens, "
            f"reports and errors identical on cpu and card")


# -- the other served architectures ------------------------------------------

SERVED = ("llama3_2_3b", "codeqwen1_5_7b", "qwen2_5_32b", "qwen2_moe_a2_7b",
          "qwen2_vl_2b")
BIAS_STD = 0.5                 # the seeded QKV biases (init draws zeros)


def seeded_biases(params, cfg, seed: int):
    """QKV biases drawn N(0, BIAS_STD^2) from a numpy seed in place of
    init's zeros, so a path that dropped a bias would show."""
    import numpy as np
    import torch
    if cfg.qkv_bias:
        rng = np.random.RandomState(seed)
        for layer in params["layers"]:
            for n in ("bq", "bk", "bv"):
                b = layer["attn"][n]
                b.copy_(torch.from_numpy(BIAS_STD * rng.randn(
                    *b.shape).astype(np.float32)).to(b.dtype))
    return params


def parity_archs(dev):
    """The five other served decoder-only architectures' smoke configs
    (qwen2_vl_2b: M-RoPE in text mode) in float32 with seeded QKV biases:
    the paged and the contiguous LLMEngine give the same
    greedy tokens on the card (kernels, graphed paged steps) and on the
    CPU (plain versions)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    for arch in SERVED:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        params = seeded_biases(T.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), cfg, 1)
        rng = np.random.RandomState(7)
        prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
                   for n in (13, 70, 5, 40, 21)]
        sps = [SamplingParams.greedy(max_new_tokens=n)
               for n in (8, 9, 5, 7, 8)]
        for paged in (True, False):
            streams = {}
            for d in ("cpu", dev):
                eng = LLMEngine(_to(params, d), cfg, EngineConfig(
                    batch=2, max_len=128, paged=paged), device=d)
                streams[str(d)] = [o.token_ids
                                   for o in eng.generate(prompts, sps)]
            label = f"{arch} smoke f32 {'paged' if paged else 'contiguous'}"
            if streams["cpu"] != streams[str(dev)]:
                raise AssertionError(f"{label}: greedy tokens differ: cpu "
                                     f"{streams['cpu']} vs card "
                                     f"{streams[str(dev)]}")
            log(f"[parity] {label}: {sum(map(len, streams['cpu']))} greedy "
                f"tokens identical on cpu (plain versions) and card "
                f"(kernels)")


# the RG-LRU gate vectors: (mean, std) of each channel's draw, in place of
# init's constants (lam 2, w_a = w_x = 0.5, b_a = b_x = 0), under which a
# per-channel permutation would pass
RGLRU_GATES = {"lam": (2.0, 0.5), "w_a": (0.5, 0.25), "w_x": (0.5, 0.25),
               "b_a": (0.0, 0.25), "b_x": (0.0, 0.25)}
RECURRENT = ("recurrentgemma_9b", "xlstm_350m", "mixtral_8x22b")


def seeded_gates(params, seed: int):
    """Every RG-LRU layer's gate vectors drawn N(mean, std^2) per channel
    from a numpy seed (float32, as the reference keeps them)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    for layer in params["layers"]:
        g = layer.get("rglru")
        if g is None:
            continue
        for name, (mean, std) in RGLRU_GATES.items():
            g[name].copy_(torch.from_numpy((mean + std * rng.randn(
                g[name].shape[0])).astype(np.float32)))
    return params


def parity_recurrent(dev):
    """The smoke configs of recurrentgemma_9b, xlstm_350m and mixtral_8x22b
    in float32 (RG-LRU gate vectors seeded per channel): the contiguous
    LLMEngine gives the same greedy tokens on the card (kernels) and on
    the CPU (plain versions), prompts longer than the window of 16 (the
    ring wraps); a paged engine raises the reference's ValueError."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    for arch in RECURRENT:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        params = seeded_gates(T.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), 1)
        rng = np.random.RandomState(7)
        prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
                   for n in (13, 70, 5, 40, 21)]
        sps = [SamplingParams.greedy(max_new_tokens=n)
               for n in (8, 9, 5, 7, 8)]
        streams = {}
        for d in ("cpu", dev):
            eng = LLMEngine(_to(params, d), cfg, EngineConfig(
                batch=2, max_len=128), device=d)
            streams[str(d)] = [o.token_ids for o in eng.generate(prompts, sps)]
        if streams["cpu"] != streams[str(dev)]:
            raise AssertionError(f"{arch} smoke f32 contiguous: greedy tokens "
                                 f"differ: cpu {streams['cpu']} vs card "
                                 f"{streams[str(dev)]}")
        try:
            LLMEngine(_to(params, dev), cfg, EngineConfig(
                batch=2, max_len=128, paged=True), device=dev).generate(
                prompts[:1], sps[0])
        except ValueError as e:
            refusal = str(e)
        else:
            raise AssertionError(f"{arch}: the paged engine served")
        if not refusal.startswith("paged serving supports full-attention "
                                  "stacks only"):
            raise AssertionError(f"{arch}: paged refusal {refusal!r}")
        log(f"[parity] {arch} smoke f32 contiguous: "
            f"{sum(map(len, streams['cpu']))} greedy tokens identical on cpu "
            f"(plain versions) and card (kernels); paged refused: "
            f"{refusal}")


WHISPER = "whisper_small"
WHISPER_PROMPT, WHISPER_MAX_LEN, WHISPER_STEPS = 256, 512, 48


def whisper_serve(params, cfg, frames, tokens, steps: int, max_len: int,
                  device, events: bool = False) -> dict:
    """`make_serve_fns` on an encoder-decoder: the prefill with the
    reference's {"frames", "tokens"} batch, then ``steps`` greedy decode
    steps. Returns the tokens (rows x steps), the final state, the host
    seconds to the first token (the prefill and its argmax) and, with
    ``events``, each decode step's CUDA-event ms."""
    import torch
    from repro_torch.serving.engine import make_serve_fns
    B, S = tokens.shape
    init, prefill, decode = make_serve_fns(cfg, max_len=max_len,
                                           device=device)
    state = init(B)
    t0 = time.perf_counter()
    logits, state = prefill(params, {"frames": frames, "tokens": tokens},
                            state)
    tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
    out = [tok]
    if device != "cpu":
        torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    pos = torch.full((B,), S, dtype=torch.int32, device=device)
    times = []
    for _ in range(steps):
        if events:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
        logits, state = decode(params, tok[:, None], state, pos)
        if events:
            e1.record()
            times.append((e0, e1))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: a non-finite decode logit")
        tok = logits[:, :cfg.vocab].argmax(-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return {"tokens": torch.stack(out, 1).tolist(), "state": state,
            "ttft_s": ttft,
            "step_ms": [a.elapsed_time(b) for a, b in times]}


def parity_whisper(dev):
    """whisper_small's smoke config in float32 through `make_serve_fns`:
    `make_frames` frames, 16-token prompts and 12 greedy decode steps (a
    block flush in the self caches) give the same tokens on the card
    (kernels) and on the CPU (plain versions), the cross caches' lengths
    equal; the paged backend, a non-int8 dtype, chunk prefill and the
    batcher are refused (the reference's errors; the batcher's named)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_frames
    from repro_torch.models import encdec
    from repro_torch.serving import EngineConfig, LLMEngine
    from repro_torch.serving.engine import (make_chunk_prefill_fn,
                                            make_serve_fns)
    cfg = dataclasses.replace(get_config(WHISPER, smoke=True),
                              dtype="float32")
    params = encdec.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    frames = torch.from_numpy(make_frames(DataConfig(
        seq_len=16, global_batch=2, vocab=cfg.vocab), cfg.d_model,
        cfg.encoder_seq))
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    runs = {str(d): whisper_serve(_to(params, d), cfg, frames.to(d),
                                  toks.to(d), 12, 32, d)
            for d in ("cpu", dev)}
    cpu, card = runs["cpu"], runs[str(dev)]
    if cpu["tokens"] != card["tokens"]:
        raise AssertionError(f"{WHISPER} smoke f32 make_serve_fns: greedy "
                             f"tokens differ: cpu {cpu['tokens']} vs card "
                             f"{card['tokens']}")
    if any(c.length != cfg.encoder_seq for c in
           cpu["state"]["cross"] + card["state"]["cross"]):
        raise AssertionError(f"{WHISPER}: cross-cache lengths differ")
    refusals = []
    for name, fn in (
            ("paged", lambda: make_serve_fns(cfg, max_len=32, paged=True,
                                             device=dev)),
            ("int4", lambda: make_serve_fns(cfg, max_len=32,
                                            kv_cache_dtype="int4",
                                            device=dev)),
            ("chunk prefill", lambda: make_chunk_prefill_fn(cfg)),
            ("batcher", lambda: LLMEngine(_to(params, dev), cfg, EngineConfig(
                batch=2, max_len=32), device=dev)),
            ("paged batcher", lambda: LLMEngine(
                _to(params, dev), cfg, EngineConfig(batch=2, max_len=32,
                                                    paged=True),
                device=dev))):
        try:
            fn()
        except ValueError as e:
            refusals.append(f"{name}: {e}")
        else:
            raise AssertionError(f"{WHISPER}: {name} was not refused")
    want = ("paged serving is decoder-only", "a paged-backend feature",
            "chunked prefill is decoder-only", "is an encoder-decoder model",
            "paged serving is decoder-only")
    if not all(w in r for w, r in zip(want, refusals)):
        raise AssertionError(f"{WHISPER}: refusals {refusals}")
    log(f"[parity] {WHISPER} smoke f32 make_serve_fns: "
        f"{sum(map(len, cpu['tokens']))} greedy tokens identical on cpu "
        f"(plain versions) and card (kernels), a block flushed; refused: "
        + "; ".join(refusals))


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
        for k in getattr(c, "launches_by_dtype", {}):
            c.launches_by_dtype[k] = 0
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c.launches for k, c in counters.items()}
    if any(counts[k] < 1 for k in needs):
        raise AssertionError(f"{label}: the path skipped a kernel: {counts}")
    return res, wall, counts, torch.cuda.max_memory_allocated(dev)


def serve_full_width(dev, params, cfg, paged: bool, eager: bool = False,
                     tag: str = ""):
    """Phase 5's five greedy requests through the paged (captured graphs,
    or with ``eager`` every step dispatched eagerly) or the contiguous
    LLMEngine (``tag`` names the model in the log). Returns (launch
    counts, tokens, layer 0's prompt pages)."""
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    label = ("paged eager" if eager else "paged") if paged else "contiguous"
    label = f"{tag} {label}" if tag else label
    needs = (("paged_decode", "paged_prefill") if paged
             else ("flat_decode", "quantize_blocked", "flash_fwd"))
    eng = LLMEngine(params, cfg, EngineConfig(batch=4, max_len=2048,
                                              paged=paged), device=dev)
    if eager:
        eng.batcher._dispatch.enabled = False
    owner = track_pages(eng.batcher) if paged else None
    prompts = serve_prompts(cfg)
    lens = tuple(len(p) for p in prompts)
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
    if paged:
        res["graphs"] = graph_report(eng.batcher)
    log(f"[serve {label}] 5/5 requests finished by length: {gen_tokens} "
        f"tokens in {wall:.3f} s ({res['tokens_per_s']:.2f} tok/s), TTFT p50 "
        f"{rep['ttft_s_p50'] * 1e3:.1f} ms, {rep['ticks']} ticks, launches "
        f"{counts}, max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[serve {label}] " + json.dumps(res))
    return counts, [o.token_ids for o in outs], (
        layer0_prompt_pages(eng.batcher, owner) if paged else None)


def graph_report(b) -> dict:
    """What the batcher's dispatch captured and replayed: each graph's
    step, argument shapes and warm-up / capture ms, the totals, and the
    bytes its generation's graph pool holds."""
    d = b._dispatch
    return {"enabled": d.enabled, "captures": d.captures,
            "capture_ms": d.capture_s * 1e3, "replays": d.replays,
            "graph_pool_bytes": d.pool_bytes() if d.enabled else 0,
            "captured": [{"step": c["step"], "shapes": c["shapes"],
                          "warm_ms": c["warm_s"] * 1e3,
                          "capture_ms": c["capture_s"] * 1e3}
                         for c in d.captured]}


def track_pages(b) -> dict:
    """Record after every tick of batcher ``b`` which row holds each page:
    page -> (uid, index in the row's pages, prompt length); the last entry
    is the page's last holder."""
    owner = {}
    step = b.step

    def tracked():
        done = step()
        for i, r in enumerate(b.rows):
            if r is not None:
                for j, p in enumerate(b.row_pages[i]):
                    owner[p] = (r.uid, j, len(r.prompt))
        return done
    b.step = tracked
    return owner


def layer0_prompt_pages(b, owner) -> dict:
    """Layer 0's pages that hold prompt tokens only (a full page of its
    last holder's prompt), copied to the host: their holders and their
    values and scales as raw bits."""
    import torch
    from repro_torch.core.paging import _as_bytes
    pages = sorted(p for p, (_, j, S) in owner.items()
                   if j < S // b.page_size)
    pool = b.state[0].pool
    ids = torch.tensor(pages, device=pool.k_q.device)
    return {"holders": {p: owner[p][:2] for p in pages},
            **{n: _as_bytes(getattr(pool, n)).index_select(0, ids).cpu()
               for n in ("k_q", "v_q")},
            **{n: getattr(pool, n).index_select(0, ids).view(
                torch.int32).cpu() for n in ("k_s", "v_s")}}


def serve_prompts(cfg):
    """Phase 5's five prompts (1500/900/300/37/1100 tokens)."""
    import numpy as np
    rng = np.random.RandomState(0)
    return [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
            for n in (1500, 900, 300, 37, 1100)]


def sampled_serve_full_width(dev, params, cfg, greedy_tokens, card: str):
    """The paged LLMEngine at full width serving phase 5's prompts with
    requests 0 and 2 greedy and 1, 3, 4 sampled (SAMPLED_MIX's settings;
    request 4 seeded from its uid): every request finishes by length, the
    greedy rows equal the greedy paged run's tokens, each sampled row
    differs from its greedy stream; then one sampled decode step over 4
    rows at the served lengths runs with any host sync an error."""
    import numpy as np
    import torch
    from repro_torch.models import sampling as SMP
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    from repro_torch.serving.params import sampling_arrays
    mix = [SAMPLED_MIX[0], SAMPLED_MIX[1], SAMPLED_MIX[0], SAMPLED_MIX[2],
           SAMPLED_MIX[3]]
    sps = [SamplingParams(max_new_tokens=48, **kw) for kw in mix]
    prompts = serve_prompts(cfg)
    eng = LLMEngine(params, cfg, EngineConfig(batch=4, max_len=2048,
                                              paged=True), device=dev)
    outs, wall, counts, peak = _run_path(
        dev, "serve paged sampled", ("paged_decode", "paged_prefill"),
        lambda: eng.generate(prompts, sps))
    toks = [o.token_ids for o in outs]
    if [o.finish_reason for o in outs] != ["length"] * 5 \
            or any(len(t) != 48 for t in toks):
        raise AssertionError("sampled paged requests did not all finish by "
                             "length")
    if toks[0] != greedy_tokens[0] or toks[2] != greedy_tokens[2]:
        raise AssertionError("a greedy row beside sampled rows differs from "
                             "the greedy paged run")
    same = [i for i in (1, 3, 4) if toks[i] == greedy_tokens[i]]
    if same:
        raise AssertionError(f"sampled requests {same} reproduced their "
                             f"greedy streams: sampling is inert")
    if not all(0 <= t < cfg.vocab for t in sum(toks, [])):
        raise AssertionError("a sampled token lies outside the vocabulary")
    # one sampled decode step at the served lengths, inputs on the card
    # first (a host-to-device copy is itself a sync)
    B, ps = 4, cfg.quant.block_size
    state = eng.batcher._init_state(B)
    nt = 2048 // ps
    table = torch.arange(1, 1 + B * nt, dtype=torch.int32,
                         device=dev).reshape(B, nt)
    lengths = torch.tensor([1548, 948, 348, 85], dtype=torch.int32,
                           device=dev)
    for c in state:             # a step advances each layer's own length
        c.page_table = table
        c.length.copy_(lengths)
    samp = SMP.device_arrays(sampling_arrays(
        [sps[i] for i in (1, 0, 3, 4)], uids=[1, 0, 3, 4],
        steps=[48] * B), dev)
    tok = torch.tensor([[t[-1]] for t in toks[:B]], dtype=torch.int32,
                       device=dev)
    mask = torch.ones((B,), dtype=torch.bool, device=dev)
    T.decode_scan(params, tok, cfg, state, lengths, steps=1, row_mask=mask,
                  sampling=samp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T.decode_scan(params, tok, cfg, state, lengths + 1, steps=2,
                      row_mask=mask, sampling=samp)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # what one draw costs a decode step: the sampler against the greedy
    # argmax on the head's logits, wall time per call (host enqueue
    # included, as the step pays it)
    logits = torch.randn((B, T.padded_vocab(cfg)), device=dev,
                         dtype=torch.bfloat16,
                         generator=torch.Generator(device=dev).manual_seed(1))
    draw_ms = {}
    for name, fn in (("sample_at_step", lambda: SMP.sample_at_step(
            logits, samp["temperature"], samp["top_k"], samp["top_p"],
            samp["key"], samp["step"], vocab=cfg.vocab)),
                     ("greedy", lambda: SMP.greedy(logits, cfg.vocab))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        draw_ms[name] = (time.perf_counter() - t0) / 20 * 1e3
    rep = eng.pool_report()
    gen_tokens = sum(map(len, toks))
    res = {"backend": "paged sampled", "requests": 5,
           "sampling": [{k: v for k, v in kw.items()} for kw in mix],
           "generated_tokens": gen_tokens, "wall_s": wall,
           "tokens_per_s": gen_tokens / wall, "ttft_s_p50": rep["ttft_s_p50"],
           "ticks": rep["ticks"], "launches": counts,
           "draw_ms_per_call": draw_ms,
           "max_memory_allocated_bytes": peak, "card": card}
    log(f"[serve paged sampled] 5/5 requests finished by length (0 and 2 "
        f"greedy = the greedy run's tokens; 1, 3, 4 sampled, each off its "
        f"greedy stream): {gen_tokens} tokens in {wall:.3f} s "
        f"({res['tokens_per_s']:.2f} tok/s), TTFT p50 "
        f"{rep['ttft_s_p50'] * 1e3:.1f} ms, {rep['ticks']} ticks, launches "
        f"{counts}; a sampled decode step with no host sync under "
        f"set_sync_debug_mode('error'); one draw at ({B}, {cfg.vocab}) "
        f"{draw_ms['sample_at_step']:.3f} ms a call against the greedy "
        f"argmax's {draw_ms['greedy']:.3f} ms (wall, enqueue included); "
        f"{card}")
    log("[serve paged sampled] " + json.dumps(res))
    return counts


def prefix_serve_full_width(dev, params, cfg, card: str):
    """The paged LLMEngine at full width with the prefix cache
    (prefill_chunk 512): a 1536-token shared prefix (6 pages). Request A
    (prefix + 200 tokens) cold, then again: the warm run adopts 6 pages,
    computes 1536 prefill tokens fewer and gives the cold run's tokens.
    Then three requests (prefix + 37 / 300 / 400) together: each adopts 6
    pages and gives its cold solo run's tokens on an engine without the
    prefix cache. The counters are the reference's logic for this
    sequence; at drain every page is cached or free."""
    import numpy as np
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, cfg.vocab, (1536,)).astype(np.int32)
    tail = lambda n: np.concatenate(
        [prefix, rng.randint(0, cfg.vocab, (n,))]).astype(np.int32)
    a, three = tail(200), [tail(n) for n in (37, 300, 400)]
    sp = SamplingParams.greedy(max_new_tokens=48)
    config = EngineConfig(batch=4, max_len=2048, paged=True,
                          prefill_chunk=512)
    miss = LLMEngine(params, cfg, config, device=dev)
    solo = []
    for p in three:
        before = miss.pool_report()["prefill_tokens_computed"]
        solo.append(miss.generate([p], sp)[0].token_ids)
        if miss.pool_report()["prefill_tokens_computed"] - before != len(p):
            raise AssertionError("a miss run skipped prefill tokens")
    eng = LLMEngine(params, cfg, EngineConfig(
        batch=4, max_len=2048, paged=True, prefix_cache=True,
        prefill_chunk=512), device=dev)
    steps = []

    def path():
        for label, ps in (("cold", [a]), ("warm", [a]), ("three", three)):
            before = eng.pool_report()
            outs = eng.generate(ps, sp)
            steps.append((label, before, eng.pool_report(), outs))

    _, wall, counts, peak = _run_path(
        dev, "serve paged prefix", ("paged_decode", "paged_prefill"), path)
    delta = {label: {k: after[k] - before[k] for k in
                     ("page_hits", "page_misses", "reclaims",
                      "cow_retargets", "prefill_tokens_computed")}
             for label, before, after, _ in steps}
    want = {"cold": {"page_hits": 0, "page_misses": 6, "reclaims": 0,
                     "cow_retargets": 0, "prefill_tokens_computed": 1736},
            "warm": {"page_hits": 6, "page_misses": 0, "reclaims": 0,
                     "cow_retargets": 0, "prefill_tokens_computed": 200},
            "three": {"page_hits": 18, "page_misses": 2, "reclaims": 0,
                      "cow_retargets": 0,
                      "prefill_tokens_computed": 37 + 300 + 400}}
    if delta != want:
        raise AssertionError(f"prefix counters {delta}, want {want}")
    outs = {label: o for label, _, _, o in steps}
    if outs["warm"][0].token_ids != outs["cold"][0].token_ids:
        raise AssertionError("the warm (hit) run's tokens differ from the "
                             "cold run's")
    got = [o.token_ids for o in outs["three"]]
    if got != solo:
        raise AssertionError(f"hit runs differ from their cold solo runs: "
                             f"{[g == s for g, s in zip(got, solo)]}")
    if any(o.finish_reason != "length" for o in outs["three"]):
        raise AssertionError("a prefix-cached request did not finish by "
                             "length")
    rep = eng.pool_report()
    if rep["pages_cached"] + rep["pages_free"] != rep["pages_total"] or \
            rep["pages_allocated"] != 0:
        raise AssertionError(f"pages leaked at drain: {rep}")
    ttft = {k: outs[k][0].metrics["ttft_s"] for k in ("cold", "warm")}
    res = {"backend": "paged prefix", "prefix_tokens": 1536,
           "prefill_chunk": 512, "counters": delta, "ttft_s": ttft,
           "pages_cached": rep["pages_cached"], "wall_s": wall,
           "launches": counts, "max_memory_allocated_bytes": peak,
           "card": card}
    log(f"[serve paged prefix] warm rerun adopts 6 pages, 1536 prefill "
        f"tokens fewer, tokens = cold; three requests adopt 6 pages each, "
        f"tokens = their cold solo runs; counters {delta}; TTFT cold "
        f"{ttft['cold'] * 1e3:.1f} ms warm {ttft['warm'] * 1e3:.1f} ms; "
        f"{rep['pages_cached']} pages cached at drain; launches {counts}; "
        f"{card}")
    log("[serve paged prefix] " + json.dumps(res))
    return counts


def _overload_engine(params, cfg, dev, **kw):
    from repro_torch.serving import EngineConfig, LLMEngine
    return LLMEngine(params, cfg, EngineConfig(
        batch=4, max_len=2048, paged=True, prefix_cache=True,
        prefill_chunk=512, chunk=1, watermark=0, n_pages=8, **kw),
        device=dev)


def overload_pair(params, cfg, dev, mode: str):
    """Run (a) or (b) of `overload_serve_full_width`: request 0 (prompt
    250, greedy) and request 1 (prompt 506, temperature 0.9, seed 7), 24
    tokens each, on a pool of 7 pages. ``mode`` "base": no pressure;
    "fast": the injector holds the whole pool from the first tick both
    rows decode until 2 ticks after the first preemption (request 0's
    growth past its page preempts request 1, whose pages stay indexed);
    "recompute": as "fast", and when the pressure lifts the suspended
    row's cached pages are reclaimed (allocated and released), so its
    resume prefills prompt + generated again. Returns (tokens by uid,
    pool report, the snapshot [uid, generated, pending] at reclaim)."""
    import numpy as np
    from repro_torch.core.paging import PoolFaultInjector
    from repro_torch.serving import SamplingParams
    inj = PoolFaultInjector(seed=1)
    eng = _overload_engine(params, cfg, dev, fault_injector=inj)
    b = eng.batcher
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (250, 506)]
    eng.add_request(prompts[0], SamplingParams.greedy(max_new_tokens=24))
    eng.add_request(prompts[1], SamplingParams(temperature=0.9, seed=7,
                                               max_new_tokens=24))
    outs, snap, lift_at = {}, None, None
    for _ in range(400):
        decoding = [r for i, r in enumerate(b.rows)
                    if r is not None and i not in b.prefilling]
        if mode != "base" and lift_at is None and len(decoding) == 2 \
                and not inj.hold_pages:
            inj.hold_pages = b.n_pages - 1
        if lift_at is None and b.preemptions:
            lift_at = b.ticks + 2
        if lift_at is not None and b.ticks == lift_at and inj.hold_pages:
            inj.hold_pages = 0
            if mode == "recompute":
                uid = next(iter(b._suspended))
                s = b._suspended[uid]
                snap = [uid, [int(t) for t in s["full_toks"][
                    len(prompts[uid]):]], s["pending"]]
                b.allocator.release(b.allocator.alloc(b.allocator.available))
        for o in eng.step():
            if o.finished:
                outs[o.uid] = o.token_ids
        if len(outs) == 2:
            return outs, eng.pool_report(), snap
    raise AssertionError(f"serve paged overload ({mode}): requests did not "
                         f"complete")


def overload_burst(params, cfg, dev):
    """(c) of `overload_serve_full_width`: 8 requests at once on a pool of
    7 pages (half the 14 the four largest concurrent worst cases need),
    prompts 250/500/760/1010, budgets 8/32/16/24 and priorities 1/0/0/0
    cycled, aging every 4 ticks. Returns (outputs, pool report, the
    prompts' total length)."""
    import numpy as np
    from repro_torch.serving import SamplingParams
    eng = _overload_engine(params, cfg, dev, aging_ticks=4)
    rng = np.random.RandomState(6)
    lens, news, prios = (250, 500, 760, 1010), (8, 32, 16, 24), (1, 0, 0, 0)
    uids = []
    for k in range(8):
        uids.append(eng.add_request(
            rng.randint(0, cfg.vocab, (lens[k % 4],)).astype(np.int32),
            SamplingParams.greedy(max_new_tokens=news[k % 4]),
            priority=prios[k % 4]))
    outs = {}
    for _ in range(4000):
        for o in eng.step():
            if o.finished:
                outs[o.uid] = o
        if len(outs) == len(uids):
            break
    else:
        raise AssertionError("serve paged overload (c): the burst did not "
                             "drain")
    for k, u in enumerate(uids):
        o = outs[u]
        if o.finish_reason != "length" or len(o.token_ids) != news[k % 4]:
            raise AssertionError(f"burst request {u} ended {o.finish_reason} "
                                 f"after {len(o.token_ids)} tokens")
    return [outs[u] for u in uids], eng.pool_report(), 2 * sum(lens), eng


def watermark_decode_without_sync(eng, cfg, dev):
    """The growth pass and a decode step of a batcher with a watermark set,
    each with any host sync an error: 2 requests (prompts 250) decode to
    their first page boundary, where the pass grows both rows by a page
    (no preemption: 4 of 7 pages) before the step, replayed from the
    engine's graph on the card (`probe_decode`)."""
    import numpy as np
    import torch
    from repro_torch.serving import SamplingParams
    b = eng.batcher
    rng = np.random.RandomState(7)
    for _ in range(2):
        eng.add_request(rng.randint(0, cfg.vocab, (250,)).astype(np.int32),
                        SamplingParams.greedy(max_new_tokens=16))
    for _ in range(16):
        rows = [i for i, r in enumerate(b.rows) if r is not None]
        if len(rows) == 2 and not b.prefilling and \
                all(b.pos[i] == 256 for i in rows):
            break
        eng.step()
    else:
        raise AssertionError("watermark sync check: the rows did not reach "
                             "their page boundary")
    preemptions = b.preemptions
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        active, n, grew = b._ensure_decode_pages(rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if active != rows or not grew or b.preemptions != preemptions:
        raise AssertionError(f"watermark sync check: the growth pass gave "
                             f"rows {active} (grew {grew}), preemptions "
                             f"{preemptions} -> {b.preemptions}")
    probe_decode(b, active, n)


def overload_serve_full_width(dev, params, cfg, card: str) -> dict:
    """Phase 5, serve paged overload: internlm2_1_8b at full width, paged
    int8 with the prefix cache (page 256, prefill_chunk 512, chunk 1),
    watermark 0, a pool of 7 pages. (a) fast resume: the pressured run's
    greedy and sampled streams equal the unpressured run's, bit for bit;
    (b) recompute resume: the tokens before the preemption and the pending
    token kept, 24 tokens in all (later tokens may differ at quantization
    noise: the count is printed, not gated); (c) a 2x oversubscribed burst
    of 8 requests drains with every budget met, then a watermark decode
    step runs with any host sync an error. Paged decode and prefill launch
    in each run. Returns each run's launch counts by path name."""
    needs = ("paged_decode", "paged_prefill")
    label = "serve paged overload"
    (base, brep, _), _, c0, _ = _run_path(
        dev, f"{label} (a) unpressured", needs,
        lambda: overload_pair(params, cfg, dev, "base"))
    (fast, frep, _), wall_a, c1, _ = _run_path(
        dev, f"{label} (a) fast resume", needs,
        lambda: overload_pair(params, cfg, dev, "fast"))
    if brep["preemptions"] or frep["preemptions"] < 1 \
            or frep["preempt_fast_resumes"] < 1:
        raise AssertionError(f"{label} (a): preemptions {brep['preemptions']}"
                             f" unpressured, {frep['preemptions']} pressured "
                             f"with {frep['preempt_fast_resumes']} fast "
                             f"resumes")
    if fast != base:
        raise AssertionError(f"{label} (a): the fast resume's tokens differ "
                             f"from the unpressured run's: {fast} vs {base}")
    (rec, rrep, snap), wall_b, c2, _ = _run_path(
        dev, f"{label} (b) recompute resume", needs,
        lambda: overload_pair(params, cfg, dev, "recompute"))
    uid, gen, pending = snap
    got = rec[uid]
    if rrep["preempt_recompute_resumes"] < 1 or got[:len(gen)] != gen \
            or got[len(gen)] != pending or len(got) != 24:
        raise AssertionError(f"{label} (b): recompute resumes "
                             f"{rrep['preempt_recompute_resumes']}, tokens "
                             f"{got}, kept {gen} + pending {pending}")
    later = sum(x != y for x, y in zip(got[len(gen) + 1:],
                                       base[uid][len(gen) + 1:]))
    (outs, crep, prompt_tokens, eng), wall_c, c3, peak = _run_path(
        dev, f"{label} (c) 2x burst", needs,
        lambda: overload_burst(params, cfg, dev))
    watermark_decode_without_sync(eng, cfg, dev)
    useful = prompt_tokens + sum(len(o.token_ids) for o in outs)
    computed = crep["prefill_tokens_computed"] + \
        crep["decode_tokens_computed"]
    keys = ("preemptions", "preempt_fast_resumes",
            "preempt_recompute_resumes", "decode_stall_ticks",
            "prefill_tokens_computed", "decode_tokens_computed", "ticks")
    res = {"backend": "paged overload", "page": cfg.quant.block_size,
           "pages_usable": 7, "watermark": 0,
           "a_fast_resume": {"tokens_equal": True, "wall_s": wall_a,
                             **{k: frep[k] for k in keys}},
           "b_recompute_resume": {"later_tokens_differing": later,
                                  "kept_tokens": len(gen), "wall_s": wall_b,
                                  **{k: rrep[k] for k in keys}},
           "c_burst": {"requests": len(outs), "wall_s": wall_c,
                       "goodput_frac": useful / computed,
                       "ttft_s_p50": crep["ttft_s_p50"],
                       "ttft_s_p99": crep["ttft_s_p99"],
                       "max_memory_allocated_bytes": peak,
                       **{k: crep[k] for k in keys}},
           "launches": {"a": {k: c0[k] + c1[k] for k in c0}, "b": c2,
                        "c": c3},
           "card": card}
    log(f"[{label}] (a) {frep['preemptions']} preemption(s), "
        f"{frep['preempt_fast_resumes']} fast resume(s), greedy and sampled "
        f"streams = the unpressured run's bit for bit; (b) "
        f"{rrep['preempt_recompute_resumes']} recompute resume(s), "
        f"{len(gen)} tokens and the pending token kept, {later} of "
        f"{24 - len(gen) - 1} later tokens differ from the unpressured run "
        f"(not gated); (c) 8/8 requests drained with full budgets: "
        f"{crep['preemptions']} preemptions ({crep['preempt_fast_resumes']} "
        f"fast / {crep['preempt_recompute_resumes']} recompute), "
        f"{crep['decode_stall_ticks']} stalled row-ticks, goodput "
        f"{useful / computed:.4f}, TTFT p50 {crep['ttft_s_p50'] * 1e3:.1f} "
        f"ms p99 {crep['ttft_s_p99'] * 1e3:.1f} ms, {crep['ticks']} ticks "
        f"in {wall_c:.3f} s; the growth pass (2 rows grown) and a watermark "
        f"decode step with no host sync under set_sync_debug_mode('error'); "
        f"{card}")
    log(f"[{label}] " + json.dumps(res))
    return {f"{label} (a) fast resume": res["launches"]["a"],
            f"{label} (b) recompute resume": c2,
            f"{label} (c) 2x burst": c3}


def _tier_engine(params, cfg, dev, **kw):
    from repro_torch.serving import EngineConfig, LLMEngine
    return LLMEngine(params, cfg, EngineConfig(
        max_len=2048, paged=True, prefix_cache=True, prefill_chunk=512,
        chunk=1, **kw), device=dev)


def _no_sync(fn):
    """Run ``fn`` with any host sync an error (on the card)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _kept(b):
    """The residuals and lengths a decode step advances, copied."""
    return [(c.resid_k.clone(), c.resid_v.clone(), c.length.clone())
            for c in b.state]


def _put_back(b, kept):
    for c, (rk, rv, ln) in zip(b.state, kept):
        c.resid_k.copy_(rk)
        c.resid_v.copy_(rv)
        c.length.copy_(ln)


def probe_decode(b, rows, n: int = 1) -> int:
    """One decode dispatch of ``rows`` (a list, or one row; ``n`` steps) on
    the batcher's live state, as a tick runs it up to its read of the
    tokens, with any host sync an error: the tables and lengths pushed
    (`_sync_device`), the inputs uploaded (pinned, non-blocking), the
    sampling arrays where a row samples, and the dispatch
    (`_launch_decode`): replays of the graphs the engine's own ticks
    captured, or the eager steps where its dispatch is disabled. The
    residuals and lengths it advances are put back after, so the engine's
    next step computes the same tokens again (a page it may flush gets the
    same bytes). Returns the replays made."""
    import numpy as np
    import torch
    rows = [rows] if isinstance(rows, int) else list(rows)
    mask = np.zeros((b.batch,), bool)
    mask[rows] = True
    d = b._dispatch
    kept, captures, replays = _kept(b), d.captures, d.replays

    def launch():
        b._sync_device()
        b._launch_decode(rows, mask, n)
    _no_sync(launch)
    torch.cuda.synchronize()
    _put_back(b, kept)
    made = d.replays - replays
    want = 0 if not d.enabled else n if n > 1 else \
        1 + b._needs_sampling(rows)
    fresh = d.captures - captures
    if fresh or made != want:
        raise AssertionError(f"decode probe ({n} steps): {fresh} graphs "
                             f"captured and {made} replays, want 0 and "
                             f"{want}")
    return made


def tier_pair(params, cfg, dev, mode: str):
    """(a) and (d) of `tiered_serve_full_width`: request 0 (prompt 520,
    greedy) and request 1 (prompt 780, temperature 0.9, seed 7), 24 tokens
    each, batch 2, watermark 1, a pool of 15 pages. ``mode`` "base": no
    tier, no pressure; "swap": host tier of 32 pages, both rows preempted
    once each has decoded 8 tokens, then every cached device page
    reclaimed, so both resume from the host tier; "delay": the injector's
    swap_delay 2, row 1 preempted (the preemption pass with any host sync
    an error), the cached pages reclaimed, row 1's promotion issued and a
    decode step of row 0 run while it is in flight, both with any host
    sync an error. Returns (tokens by uid, pool report)."""
    import numpy as np
    from repro_torch.core.paging import PoolFaultInjector
    from repro_torch.serving import SamplingParams
    kw = {} if mode == "base" else dict(host_pages=32)
    if mode == "delay":
        kw["fault_injector"] = PoolFaultInjector(5, swap_delay=2)
    eng = _tier_engine(params, cfg, dev, batch=2, watermark=1, n_pages=16,
                       **kw)
    b = eng.batcher
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (520, 780)]
    eng.add_request(prompts[0], SamplingParams.greedy(max_new_tokens=24))
    eng.add_request(prompts[1], SamplingParams(temperature=0.9, seed=7,
                                               max_new_tokens=24))
    outs, forced = {}, mode == "base"
    for _ in range(400):
        rows = [r for r in b.rows if r is not None]
        if not forced and len(rows) == 2 and not b.prefilling \
                and all(len(r.generated) >= 8 for r in rows):
            forced = True
            a = b.allocator
            if mode == "swap":
                for i in (0, 1):
                    b._preempt_row(i)
                a.release(a.alloc(len(a.free) + len(a.lru)))
            else:
                _no_sync(lambda: b._preempt_row(1))
                a.release(a.alloc(len(a.free) + len(a.lru)))
                chain = b._suspended[1]["full_chain"]
                issued = _no_sync(
                    lambda: b._issue_prefetch(chain, 0, len(chain)))
                if not issued or len(a.inflight) != issued:
                    raise AssertionError(f"serve paged tiered (d): "
                                         f"{issued} promotions issued, "
                                         f"{len(a.inflight)} in flight")
                probe_decode(b, 0)
        for o in eng.step():
            if o.finished:
                outs[o.uid] = o.token_ids
        if len(outs) == 2:
            return outs, eng.pool_report()
    raise AssertionError(f"serve paged tiered ({mode}): requests did not "
                         f"complete")


def tier_revisit(params, cfg, dev, host_tier_dtype=None,
                 kv_cache_dtype="int8"):
    """(b) and (c): batch 1, a pool of 8 usable pages, host tier of 32.
    Request A (chip_smoke's 1536-token prefix + 200 tokens, 16 new) cold,
    again at once (device-warm: adopts 6 pages; skipped for (c)), then two
    1700-token fillers (2 new: they only need the pages) that reclaim, and
    so demote, every page of A's prefix, then A again (host-warm: its 6
    pages promoted and adopted).
    Returns {label: (report before, report after, output)} (with the
    engine's construction time, its host slab allocated, under "built_s")
    and the engine."""
    import numpy as np
    from repro_torch.core.paging import chain_hashes
    from repro_torch.serving import SamplingParams
    t0 = time.perf_counter()
    eng = _tier_engine(params, cfg, dev, batch=1, n_pages=9, host_pages=32,
                       host_tier_dtype=host_tier_dtype,
                       kv_cache_dtype=kv_cache_dtype)
    steps = {"built_s": time.perf_counter() - t0}
    rng = np.random.RandomState(3)
    prefix = rng.randint(0, cfg.vocab, (1536,)).astype(np.int32)
    a = np.concatenate([prefix, rng.randint(0, cfg.vocab, (200,))]
                       ).astype(np.int32)
    fillers = [rng.randint(0, cfg.vocab, (1700,)).astype(np.int32)
               for _ in range(2)]
    sp = {"filler": SamplingParams.greedy(max_new_tokens=2)}
    plan = [("cold", a)] + ([("device warm", a)] if host_tier_dtype is None
                            else []) \
        + [("filler", f) for f in fillers] + [("host warm", a)]
    for label, p in plan:
        before = eng.pool_report()
        if label == "host warm":
            chain = chain_hashes(prefix, cfg.quant.block_size)
            dev_pages = eng.batcher.allocator.match(chain)
            hosted = eng.batcher._tiering.run_length(chain)
            if dev_pages or hosted != len(chain):
                raise AssertionError(f"serve paged tiered: before the host-"
                                     f"warm run {dev_pages} prefix pages are "
                                     f"on the device, {hosted} on the host")
        out = eng.generate([p], sp.get(label, SamplingParams.greedy(
            max_new_tokens=16)))[0]
        steps[label] = (before, eng.pool_report(), out)
    return steps, eng


def _delta(steps, label, keys):
    before, after, _ = steps[label]
    return {k: after[k] - before[k] for k in keys}


def tier_copy_times(b, cfg, dev, card: str) -> dict:
    """One full-width page (every layer's K, V and scale rows) out to
    pinned host memory and back, timed with CUDA events (20 each after a
    warm-up; the L2 holds the page, the link is the limit): the bare
    copies, and the scheduler's demote (gather + copy) and promote (copy +
    scatter on the side stream) of one page on the host clock. Beside
    them the link's bound, the rate of a 256 MiB pinned copy, and the
    re-prefill of one page (256 tokens at positions 0 and 1280) on the
    host clock, against its bound at the bf16 peak."""
    import numpy as np
    import torch
    from repro_torch.core.paging import page_bytes_for
    L, ps, H, D = cfg.n_layers, cfg.quant.block_size, cfg.n_kv_heads, \
        cfg.head_dim
    nbytes = page_bytes_for(ps, H, D, "int8") * L
    q = torch.randint(-127, 128, (1, L, 2, ps, H, D), dtype=torch.int8,
                      device=dev)
    s = torch.rand((1, L, 2, H, D), device=dev)
    hq = torch.empty(q.shape, dtype=q.dtype, pin_memory=True)
    hs = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)

    def events(fn, n=20):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n

    out_ms = events(lambda: (hq.copy_(q, non_blocking=True),
                             hs.copy_(s, non_blocking=True)))
    in_ms = events(lambda: (q.copy_(hq, non_blocking=True),
                            s.copy_(hs, non_blocking=True)))
    big = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    hbig = torch.empty(big.shape, dtype=big.dtype, pin_memory=True)
    rate_out = big.numel() / events(lambda: hbig.copy_(big, non_blocking=True),
                                    5) / 1e6
    rate_in = big.numel() / events(lambda: big.copy_(hbig, non_blocking=True),
                                   5) / 1e6
    del big, hbig

    def wall(fn, n=10):
        fn()
        torch.cuda.synchronize()
        t = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(t))

    a, tier = b.allocator, b._tiering
    page = a.free[-1] if a.free else next(iter(a.lru))
    fake = iter(range(1 << 30))

    def demote():
        b._demote_queue.append((page, b"timing-%d" % next(fake)))
        b._flush_demotions()
    demote_ms = wall(demote)
    rec = next(iter(tier.pages.values())).wait()
    promote_ms = wall(lambda: b._write_host_pages([page], [rec]))
    fn0, fnd = b._chunk_prefill_fn(0), b._chunk_prefill_fn(1280)
    on = lambda a: torch.as_tensor(a, device=dev)
    tok = on(np.random.RandomState(0).randint(
        0, cfg.vocab, (b.batch, ps)).astype(np.int32))
    valid = on(np.full((b.batch,), ps, np.int32))
    mask = on(np.ones((b.batch,), bool))

    def prefill(fn, start):
        st = on(np.full((b.batch,), start, np.int32))
        return lambda: fn(b.params, tok, b.state, st, valid, mask)
    reprefill0 = wall(prefill(fn0, 0))
    reprefill_deep = wall(prefill(fnd, 1280))
    n_params = sum(p.numel() for p in _leaves(b.params["layers"]))
    res = {"page_bytes": nbytes, "link_bound_ms":
           nbytes / PCIE_BYTES_PER_S * 1e3,
           "copy_out_ms": out_ms, "copy_in_ms": in_ms,
           "link_GBps_out_256MiB": rate_out, "link_GBps_in_256MiB": rate_in,
           "scheduler_demote_ms": demote_ms,
           "scheduler_promote_ms": promote_ms,
           "reprefill_ms_pos0": reprefill0,
           "reprefill_ms_pos1280": reprefill_deep,
           "reprefill_bound_ms": 2 * ps * n_params / BF16_FLOP_PER_S * 1e3,
           "non_embedding_params": n_params,
           "copy_cost_tokens": (out_ms + in_ms) / (reprefill0 / ps),
           "card": card}
    log(f"[serve paged tiered] one page ({nbytes} bytes, {L} layers): out "
        f"{out_ms:.4f} ms, in {in_ms:.4f} ms (events; the link's bound "
        f"{res['link_bound_ms']:.4f} ms at {PCIE_BYTES_PER_S / 1e9:.0f} GB/s "
        f"each way, PCIe Gen5 x16; 256 MiB copies ran at {rate_out:.1f} / "
        f"{rate_in:.1f} GB/s out / in); the scheduler's demote "
        f"{demote_ms:.3f} ms and promote {promote_ms:.3f} ms (host clock); "
        f"re-prefill of one page {reprefill0:.3f} ms at position 0, "
        f"{reprefill_deep:.3f} ms at 1280 (bound {res['reprefill_bound_ms']:.3f}"
        f" ms: 256 tokens x {n_params / 1e9:.3f} G params at the bf16 peak); a "
        f"round trip costs {res['copy_cost_tokens']:.2f} prefill tokens "
        f"(SwapCostModel: 1); {card}")
    return res


def tier_flip(params, cfg, dev) -> dict:
    """(e): the paged int8 engine serves two requests (300 and 500
    tokens, 16 new), is flipped to fp8_e4m3 while idle, and serves them
    again: tokens equal to an engine built on fp8_e4m3; right after the
    flip the old pools are gone (memory_allocated back at its level before
    the engine was built)."""
    import numpy as np
    import torch
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (300, 500)]
    sp = SamplingParams.greedy(max_new_tokens=16)
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated(dev)
    eng = LLMEngine(params, cfg, EngineConfig(batch=2, max_len=1024,
                                              paged=True), device=dev)
    eng.generate(prompts, sp)
    torch.cuda.synchronize()
    serving = torch.cuda.memory_allocated(dev)
    eng.batcher.config.kv_cache_dtype = "fp8_e4m3"
    eng.batcher._ensure_backend_dtype()
    torch.cuda.synchronize()
    flipped = torch.cuda.memory_allocated(dev)
    toks = [o.token_ids for o in eng.generate(prompts, sp)]
    fresh = LLMEngine(params, cfg, EngineConfig(
        batch=2, max_len=1024, paged=True, kv_cache_dtype="fp8_e4m3"),
        device=dev)
    want = [o.token_ids for o in fresh.generate(prompts, sp)]
    if toks != want or eng.pool_report()["kv_cache_dtype"] != "fp8_e4m3":
        raise AssertionError("serve paged tiered (e): the flipped engine's "
                             "tokens differ from a fresh fp8_e4m3 engine's")
    if flipped > level:
        raise AssertionError(f"serve paged tiered (e): memory_allocated "
                             f"{flipped} after the flip, {level} before the "
                             f"engine: the old pools were not freed")
    return {"allocated_before_engine": level, "allocated_serving": serving,
            "allocated_after_flip": flipped}


def tiered_serve_full_width(dev, params, cfg, card: str) -> dict:
    """Phase 5, serve paged tiered: internlm2_1_8b at full width, paged
    int8 with the prefix cache (page 256, prefill_chunk 512, chunk 1) and
    a host tier (pinned, the copies stream-ordered). (a) a forced swap
    restore of a greedy and a seeded row equals the unpressured run bit
    for bit, 2 swap restores and no recompute; (b) a 1536-token prefix
    demoted by fillers and served again promotes and adopts its 6 pages,
    computes 1536 prefill tokens fewer and gives its cold tokens (TTFT
    cold, device-warm, host-warm); (c) int4 at rest completes; (d) under
    swap_delay 2, the preemption pass, the promotion and a decode step
    with it in flight make no host sync, and the streams stay the
    unpressured run's; (e) the idle dtype flip int8 -> fp8_e4m3 serves a
    fresh fp8 engine's tokens and frees the old pools. Then the copy and
    re-prefill times of one page. Returns each run's launch counts."""
    needs = ("paged_decode", "paged_prefill")
    label = "serve paged tiered"
    (base, _), _, c0, _ = _run_path(
        dev, f"{label} (a) unpressured", needs,
        lambda: tier_pair(params, cfg, dev, "base"))
    (swap, srep), wall_a, c1, peak_a = _run_path(
        dev, f"{label} (a) swap restore", needs,
        lambda: tier_pair(params, cfg, dev, "swap"))
    if swap != base or srep["preempt_swap_restores"] != 2 \
            or srep["preempt_recompute_resumes"] \
            or srep["preempt_by_swap"] != 2:
        raise AssertionError(f"{label} (a): tokens equal {swap == base}, "
                             f"report {srep}")
    (steps, eng), wall_b, c2, peak_b = _run_path(
        dev, f"{label} (b) host-warm revisit", needs,
        lambda: tier_revisit(params, cfg, dev))
    keys = ("promotions", "prefetch_page_hits", "page_hits",
            "prefill_tokens_computed")
    warm = _delta(steps, "host warm", keys)
    dwarm = _delta(steps, "device warm", keys)
    want = {"promotions": 6, "prefetch_page_hits": 6, "page_hits": 6,
            "prefill_tokens_computed": 200}
    cold_tokens = steps["cold"][2].token_ids
    if warm != want or dwarm != dict(want, promotions=0,
                                     prefetch_page_hits=0) \
            or steps["host warm"][2].token_ids != cold_tokens \
            or steps["device warm"][2].token_ids != cold_tokens:
        raise AssertionError(f"{label} (b): host warm {warm}, device warm "
                             f"{dwarm}, want {want}; tokens equal "
                             f"{steps['host warm'][2].token_ids == cold_tokens}")
    brep = steps["host warm"][1]
    ttft = {k: steps[k][2].metrics["ttft_s"]
            for k in ("cold", "device warm", "host warm")}
    host_bytes = brep["host_bytes"]
    slab = eng.batcher._host_slab
    slab_bytes = sum(t.nbytes for t in slab.q + slab.s)
    copies = tier_copy_times(eng.batcher, cfg, dev, card)
    del eng
    (steps4, _), wall_c, c3, _ = _run_path(
        dev, f"{label} (c) int4 at rest", needs,
        lambda: tier_revisit(params, cfg, dev, host_tier_dtype="int4"))
    crep = steps4["host warm"][1]
    (delay, drep), wall_d, c4, _ = _run_path(
        dev, f"{label} (d) swap_delay 2", needs,
        lambda: tier_pair(params, cfg, dev, "delay"))
    if delay != base or drep["preempt_swap_restores"] != 1 \
            or drep["pages_inflight"]:
        raise AssertionError(f"{label} (d): tokens equal {delay == base}, "
                             f"report {drep}")
    flip, wall_e, c5, _ = _run_path(dev, f"{label} (e) dtype flip", needs,
                                    lambda: tier_flip(params, cfg, dev))
    rkeys = ("preemptions", "preempt_by_swap", "preempt_swap_restores",
             "preempt_fast_resumes", "preempt_recompute_resumes",
             "demotions", "promotions", "prefetch_issued",
             "prefetch_page_hits", "host_pages_used", "host_bytes")
    res = {"backend": "paged tiered", "page": cfg.quant.block_size,
           "a_swap_restore": {"tokens_equal": True, "wall_s": wall_a,
                              "max_memory_allocated_bytes": peak_a,
                              **{k: srep[k] for k in rkeys}},
           "b_host_warm": {"counters": warm, "device_warm": dwarm,
                           "ttft_s": ttft, "wall_s": wall_b,
                           "host_bytes": host_bytes,
                           "pinned_slab_bytes": slab_bytes,
                           "engine_built_s": steps["built_s"],
                           "max_memory_allocated_bytes": peak_b,
                           **{k: brep[k] for k in rkeys}},
           "c_int4_at_rest": {"wall_s": wall_c,
                              **{k: crep[k] for k in rkeys}},
           "d_swap_delay": {"tokens_equal": True, "no_host_sync": True,
                            "wall_s": wall_d,
                            **{k: drep[k] for k in rkeys}},
           "e_dtype_flip": {"tokens_equal_fresh_fp8": True,
                            "wall_s": wall_e, **flip},
           "copy": copies,
           "launches": {"a": {k: c0[k] + c1[k] for k in c0}, "b": c2,
                        "c": c3, "d": c4, "e": c5},
           "card": card}
    log(f"[{label}] (a) {srep['preempt_by_swap']} preempt-by-swap, "
        f"{srep['preempt_swap_restores']} swap restores, 0 recompute: greedy "
        f"and sampled streams = the unpressured run's bit for bit; (b) "
        f"host-warm revisit promotes and adopts 6 pages, 1536 prefill tokens "
        f"fewer, tokens = cold; TTFT cold {ttft['cold'] * 1e3:.1f} ms, "
        f"device-warm {ttft['device warm'] * 1e3:.1f} ms, host-warm "
        f"{ttft['host warm'] * 1e3:.1f} ms; host tier {brep['host_pages_used']}"
        f" pages, {host_bytes} bytes held in a pinned slab of {slab_bytes} "
        f"(engine built in {steps['built_s']:.3f} s); (c) int4 at rest: "
        f"{crep['demotions']} demotions, {crep['promotions']} promotions "
        f"(tokens not gated); (d) swap_delay 2: preemption pass, promotion "
        f"and a decode step in flight with no host sync, streams = "
        f"unpressured; (e) int8 -> fp8_e4m3 flip: tokens = fresh fp8 "
        f"engine, memory_allocated {flip['allocated_serving']} serving -> "
        f"{flip['allocated_after_flip']} after the flip (before the engine "
        f"{flip['allocated_before_engine']}); {card}")
    log(f"[{label}] " + json.dumps(res))
    return {f"{label} (a) swap restore": res["launches"]["a"],
            f"{label} (b) host-warm revisit": c2,
            f"{label} (c) int4 at rest": c3,
            f"{label} (d) swap_delay 2": c4, f"{label} (e) dtype flip": c5}


# serve paged mixed at page 256, H_kv 8, D 128 (the predictions of PERF.md,
# from `page_bytes_for`): one page of one layer, the P24 stack's page, the
# 33 pages of phase 5's pools, a demoted page on the host (as the device
# holds it, and all int4)
MIXED_PRED = {"page_int8": 532_480, "page_fp8_e4m3": 532_480,
              "page_int4": 270_336, "stack": 10_682_368,
              "stack_int8": 12_779_520, "pools": 352_518_144,
              "host_page": 10_682_368, "host_page_int4": 6_488_064}


def _by_dtype() -> dict:
    """The paged kernels' launches by page dtype since the last reset."""
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quant_prefill as QP
    return {"paged_decode": dict(QA.paged_decode_partials_cuda
                                 .launches_by_dtype),
            "paged_prefill": dict(QP.paged_prefill_cuda.launches_by_dtype)}


def _even_by_dtype(label, by, counts, n_layers):
    """A stack of 8 layers of each dtype: per kernel, each dtype launched
    equally often, the sum the kernel's launches, a multiple of the layer
    count (one launch per layer per step or chunk)."""
    for k, d in by.items():
        if len(set(d.values())) != 1 or sum(d.values()) != counts[k] \
                or counts[k] % n_layers or not counts[k]:
            raise AssertionError(f"{label}: {k} launches by dtype {d}, "
                                 f"{counts[k]} in all")


def mixed_flips(params, cfg, dev, plan_path) -> dict:
    """(f): a paged int8 engine serves two requests (300 and 500 tokens,
    16 new), is flipped while idle to P24 and back to int8, serving them
    after each flip: after P24 the tokens of an engine built on P24, after
    int8 again its first tokens; right after each flip memory_allocated is
    back at its level before the engine (the old pools freed, the new ones
    built at the next tick)."""
    import numpy as np
    import torch
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (300, 500)]
    sp = SamplingParams.greedy(max_new_tokens=16)
    torch.cuda.synchronize()
    level = torch.cuda.memory_allocated(dev)
    eng = LLMEngine(params, cfg, EngineConfig(batch=2, max_len=1024,
                                              paged=True), device=dev)
    serve = lambda e: [o.token_ids for o in e.generate(prompts, sp)]
    first = serve(eng)
    res = {"allocated_before_engine": level}
    runs = {}
    for label, spec in (("P24", plan_path), ("int8", "int8")):
        eng.batcher.config.kv_cache_dtype = spec
        eng.batcher._ensure_backend_dtype()
        torch.cuda.synchronize()
        res[f"allocated_after_flip_to_{label}"] = \
            torch.cuda.memory_allocated(dev)
        runs[label] = serve(eng)
        if res[f"allocated_after_flip_to_{label}"] > level:
            raise AssertionError(f"serve paged mixed (f): memory_allocated "
                                 f"{res} after the flip to {label}: the "
                                 f"old pools were not freed")
    fresh = serve(LLMEngine(params, cfg, EngineConfig(
        batch=2, max_len=1024, paged=True, kv_cache_dtype=plan_path),
        device=dev))
    if runs["P24"] != fresh or runs["int8"] != first:
        raise AssertionError("serve paged mixed (f): flipped tokens differ "
                             "from a fresh P24 engine's or the first run's")
    return res


def mixed_serve_full_width(dev, params, cfg, card: str, uniform_tokens,
                           uniform_layer0) -> dict:
    """Phase 5, serve paged mixed: internlm2_1_8b at full width, paged,
    with the plan P24 = ("int8", "fp8_e4m3", "int4") x 8, written to a
    JSON file in a temporary directory and passed by path. (a) phase 5's
    five greedy prompts: each layer's pool at its dtype and shape, the
    pools' bytes and `pool_report` ("mixed", the 24 dtypes, the capacity
    ratio and saved fraction) against MIXED_PRED, layer 0's prompt pages
    byte for byte the uniform int8 run's, each dtype's paged decode and
    prefill launches 8 per step or chunk; (b) an all-int8 `PrecisionPlan`
    serves the uniform run's tokens; (c) the prefix cell's 1736-token
    prompt cold then warm (decode chunk 1): 6 hits, 200 prefill tokens,
    the same tokens; (d) the tier revisit (host tier of 32 pages, the
    prefix demoted by two fillers and promoted back) with host_tier_dtype
    None and int4: host bytes per record against MIXED_PRED, host-warm
    tokens = cold, a demotion and a promotion of one page with any host
    sync an error; (e) on (c)'s engine, a decode step of a resident row
    with any host sync an error; (f) `mixed_flips`. Returns each run's
    launch counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.paging import page_bytes_for
    from repro_torch.core.quantization import (PrecisionPlan, kv_storage_dtype,
                                               packed_tokens)
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    label, needs = "serve paged mixed", ("paged_decode", "paged_prefill")
    L, ps, H, D = cfg.n_layers, cfg.quant.block_size, cfg.n_kv_heads, \
        cfg.head_dim
    if L != len(P24_DTYPES):
        raise AssertionError(f"{label}: P24 covers {len(P24_DTYPES)} layers, "
                             f"the model has {L}")
    pb = {dt: page_bytes_for(ps, H, D, dt) for dt in DTYPES}
    got = {**{f"page_{dt}": pb[dt] for dt in DTYPES},
           "stack": sum(pb[dt] for dt in P24_DTYPES),
           "stack_int8": pb["int8"] * L}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_plan_"))
    try:
        plan_path = str(tmp / "P24.json")
        Path(plan_path).write_text(json.dumps(
            PrecisionPlan(P24_DTYPES).to_json()))
        config = dict(batch=4, max_len=2048, paged=True)
        prompts = serve_prompts(cfg)
        sp = SamplingParams.greedy(max_new_tokens=48)

        # (a) serve
        eng = LLMEngine(params, cfg, EngineConfig(
            **config, kv_cache_dtype=plan_path), device=dev)
        owner = track_pages(eng.batcher)
        outs, wall_a, c_a, peak_a = _run_path(
            dev, f"{label} (a)", needs, lambda: eng.generate(prompts, sp))
        by_a = _by_dtype()
        _even_by_dtype(f"{label} (a)", by_a, c_a, L)
        b = eng.batcher
        if [o.finish_reason for o in outs] != ["length"] * 5 \
                or any(len(o.token_ids) != 48 for o in outs) \
                or not all(0 <= t < cfg.vocab for o in outs
                           for t in o.token_ids):
            raise AssertionError(f"{label} (a): requests did not all finish "
                                 f"by length with in-vocabulary tokens")
        for layer, (c, dt) in enumerate(zip(b.state, P24_DTYPES)):
            want = (b.n_pages, packed_tokens(ps, dt), H, D)
            if c.pool.kv_dtype != dt or tuple(c.pool.k_q.shape) != want \
                    or c.pool.k_q.dtype != kv_storage_dtype(dt):
                raise AssertionError(f"{label} (a): layer {layer} pool "
                                     f"{c.pool.kv_dtype} {c.pool.k_q.dtype} "
                                     f"{tuple(c.pool.k_q.shape)}, want {dt} "
                                     f"{want}")
        got["pools"] = sum(t.numel() * t.element_size() for c in b.state
                           for t in (c.pool.k_q, c.pool.v_q, c.pool.k_s,
                                     c.pool.v_s))
        rep = eng.pool_report()
        ratio, saved = rep["pages_vs_int8_equal_hbm"], \
            rep["kv_page_bytes_saved_vs_int8_frac"]
        if rep["kv_cache_dtype"] != "mixed" \
                or rep["kv_cache_layer_dtypes"] != list(P24_DTYPES) \
                or ratio != got["stack_int8"] / got["stack"] \
                or saved != 1 - got["stack"] / got["stack_int8"] \
                or b.n_pages != 33:
            raise AssertionError(f"{label} (a): pool_report {rep}")
        layer0 = layer0_prompt_pages(b, owner)
        if layer0["holders"] != uniform_layer0["holders"] or any(
                not torch.equal(layer0[n], uniform_layer0[n])
                for n in ("k_q", "v_q", "k_s", "v_s")):
            raise AssertionError(f"{label} (a): layer 0's prompt pages "
                                 f"differ from the uniform int8 run's")
        tokens = [o.token_ids for o in outs]
        del eng, b

        # (b) an all-int8 plan is the uniform engine
        eng = LLMEngine(params, cfg, EngineConfig(
            **config, kv_cache_dtype=PrecisionPlan(("int8",) * L)),
            device=dev)
        outs_b, wall_b, c_b, _ = _run_path(
            dev, f"{label} (b)", needs, lambda: eng.generate(prompts, sp))
        if eng.batcher.kv_cache_dtype != "int8" \
                or [o.token_ids for o in outs_b] != uniform_tokens:
            raise AssertionError(f"{label} (b): the all-int8 plan's tokens "
                                 f"differ from the uniform paged run's")
        del eng

        # (c) prefix cache, then (e) a decode step without host sync
        rng = np.random.RandomState(3)
        prefix = rng.randint(0, cfg.vocab, (1536,)).astype(np.int32)
        a = np.concatenate([prefix, rng.randint(0, cfg.vocab, (200,))]
                           ).astype(np.int32)
        eng = LLMEngine(params, cfg, EngineConfig(
            **config, prefix_cache=True, prefill_chunk=512, chunk=1,
            kv_cache_dtype=plan_path), device=dev)
        steps = []

        def prefix_path():
            for run in ("cold", "warm"):
                before = eng.pool_report()
                out = eng.generate([a], sp)[0]
                steps.append((run, before, eng.pool_report(), out))
        _, wall_c, c_c, _ = _run_path(dev, f"{label} (c)", needs,
                                      prefix_path)
        delta = {run: {k: after[k] - before[k] for k in (
            "page_hits", "page_misses", "prefill_tokens_computed")}
            for run, before, after, _ in steps}
        want = {"cold": {"page_hits": 0, "page_misses": 6,
                         "prefill_tokens_computed": 1736},
                "warm": {"page_hits": 6, "page_misses": 0,
                         "prefill_tokens_computed": 200}}
        same = steps[0][3].token_ids == steps[1][3].token_ids
        if delta != want or not same:
            raise AssertionError(f"{label} (c): counters {delta}, want "
                                 f"{want}; tokens equal {same}")
        ttft_c = {run: out.metrics["ttft_s"] for run, _, _, out in steps}
        b = eng.batcher
        uid = eng.add_request(prompts[2], SamplingParams.greedy(
            max_new_tokens=8))
        for _ in range(50):
            eng.step()
            row = next((i for i, r in enumerate(b.rows)
                        if r is not None and r.uid == uid), None)
            if row is not None and row not in b.prefilling \
                    and b.rows[row].generated:
                break
        else:
            raise AssertionError(f"{label} (e): the request never decoded")
        probe_decode(b, row)
        while eng.has_unfinished():
            eng.step()
        del eng, b

        # (d) host tier, device dtypes and int4 at rest
        tiers, c_d = {}, {}
        for htd in (None, "int4"):
            key = "int4" if htd else "verbatim"
            (tsteps, teng), wall, c_d[key], _ = _run_path(
                dev, f"{label} (d) {key}", needs,
                lambda: tier_revisit(params, cfg, dev, host_tier_dtype=htd,
                                     kv_cache_dtype=plan_path))
            warm = _delta(tsteps, "host warm", (
                "promotions", "prefetch_page_hits", "page_hits",
                "prefill_tokens_computed"))
            trep = tsteps["host warm"][1]
            tb = teng.batcher
            rec = next(iter(tb._tiering.pages.values()))
            per_page = trep["host_bytes"] / max(trep["host_pages_used"], 1)
            if warm != {"promotions": 6, "prefetch_page_hits": 6,
                        "page_hits": 6, "prefill_tokens_computed": 200} \
                    or rec.nbytes != per_page \
                    or rec.dtypes != [htd or dt for dt in P24_DTYPES] \
                    or (htd is None and tsteps["host warm"][2].token_ids
                        != tsteps["cold"][2].token_ids):
                raise AssertionError(f"{label} (d) {key}: host warm {warm}, "
                                     f"{per_page} host bytes a page, record "
                                     f"dtypes {rec.dtypes}")
            got["host_page" + ("_int4" if htd else "")] = rec.nbytes
            a_ = tb.allocator
            page = a_.free[-1] if a_.free else next(iter(a_.lru))

            def demote():
                tb._demote_queue.append((page, b"no-sync-" + key.encode()))
                tb._flush_demotions()
            _no_sync(demote)
            fresh_rec = tb._tiering.pages[b"no-sync-" + key.encode()]
            _no_sync(lambda: tb._write_host_pages([page], [fresh_rec]))
            torch.cuda.synchronize()
            tiers[key] = {"host_warm": warm, "wall_s": wall,
                          "ttft_s": {k: tsteps[k][2].metrics["ttft_s"]
                                     for k in ("cold", "host warm")},
                          **{k: trep[k] for k in (
                              "demotions", "promotions", "host_pages_used",
                              "host_bytes")},
                          "host_bytes_per_page": rec.nbytes}
            del teng, tb

        # (f) flips
        flips, wall_f, c_f, _ = _run_path(
            dev, f"{label} (f)", needs,
            lambda: mixed_flips(params, cfg, dev, plan_path))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if got != MIXED_PRED:
        raise AssertionError(f"{label}: measured {got}, predicted "
                             f"{MIXED_PRED}")
    res = {"backend": "paged mixed", "plan": "(int8, fp8_e4m3, int4) x 8",
           "bytes": got, "pages_vs_int8_equal_hbm": ratio,
           "kv_page_bytes_saved_vs_int8_frac": saved,
           "a_serve": {"wall_s": wall_a, "tokens_per_s":
                       sum(map(len, tokens)) / wall_a,
                       "max_memory_allocated_bytes": peak_a,
                       "launches_by_dtype": by_a,
                       "decode_launches_per_step": L,
                       "layer0_prompt_pages_equal_uniform": len(
                           layer0["holders"])},
           "b_all_int8_plan": {"tokens_equal_uniform": True,
                               "wall_s": wall_b},
           "c_prefix": {"counters": delta, "ttft_s": ttft_c,
                        "wall_s": wall_c},
           "d_tier": tiers, "e_decode_no_host_sync": True,
           "f_flips": {"wall_s": wall_f, **flips},
           "launches": {"a": c_a, "b": c_b, "c": c_c, **c_d, "f": c_f},
           "card": card}
    log(f"[{label}] (a) 24 pools at their dtypes, {got['pools']} bytes at "
        f"33 pages ({got['stack']} a page of the stack against "
        f"{got['stack_int8']} for int8; predicted {MIXED_PRED['pools']}), "
        f"pages_vs_int8_equal_hbm {ratio:.4f}, saved {saved:.4f}; layer 0's "
        f"{len(layer0['holders'])} prompt pages = the uniform int8 run's bit "
        f"for bit; launches by dtype {by_a}; {sum(map(len, tokens))} tokens "
        f"in {wall_a:.3f} s; (b) all-int8 plan = uniform tokens; (c) warm "
        f"run 6 hits, 200 prefill tokens, tokens = cold, TTFT "
        f"{ttft_c['cold'] * 1e3:.1f} / {ttft_c['warm'] * 1e3:.1f} ms; (d) "
        f"host bytes a page {got['host_page']} / {got['host_page_int4']} "
        f"(int4 at rest), host-warm = cold, demote and promote with no host "
        f"sync; (e) a mixed decode step with no host sync; (f) flips int8 -> "
        f"P24 -> int8, memory_allocated {flips}; {card}")
    log(f"[{label}] " + json.dumps(res))
    return {f"{label} (a)": c_a, f"{label} (b) all-int8 plan": c_b,
            f"{label} (c) prefix": c_c,
            f"{label} (d) tier": {k: c_d["verbatim"][k] + c_d["int4"][k]
                                  for k in c_a},
            f"{label} (f) flips": c_f}


def same_pools(b1, b2) -> bool:
    """Every layer's pool pages and scale rows the same bits in two
    batchers (page 0, the sentinel, is garbage by design)."""
    return all(same_bits(getattr(c1.pool, n)[1:], getattr(c2.pool, n)[1:])
               for c1, c2 in zip(b1.state, b2.state)
               for n in ("k_q", "v_q", "k_s", "v_s"))


def graph_cell(dev, params, cfg, sps, label: str, eager: bool = False,
               eng=None, prompts=None, chunk=None):
    """Phase 5's five prompts (or ``prompts``) through a fresh paged
    LLMEngine (batch 4, max_len 2048, ``chunk``; ``eager``: every step
    dispatched eagerly), or again through ``eng`` with the same uids (the
    seeded streams repeat). Returns (engine, tokens, record)."""
    from repro_torch.serving import EngineConfig, LLMEngine
    if eng is None:
        eng = LLMEngine(params, cfg, EngineConfig(
            batch=4, max_len=2048, paged=True, chunk=chunk), device=dev)
        eng.batcher._dispatch.enabled = not eager
    else:
        eng._next_uid = 0
        eng.batcher._ttfts.clear()
    outs, wall, counts, peak = _run_path(
        dev, label, ("paged_decode", "paged_prefill"),
        lambda: eng.generate(prompts or serve_prompts(cfg), sps))
    toks = [o.token_ids for o in outs]
    n = sum(map(len, toks))
    return eng, toks, {
        "wall_s": wall, "generated_tokens": n, "tokens_per_s": n / wall,
        "ttft_s_p50": eng.pool_report()["ttft_s_p50"],
        "max_memory_allocated_bytes": peak, "launches": counts,
        "launches_by_dtype": _by_dtype()}


def _traced(prof, name: str) -> int:
    """Launches of the CUDA kernels named ``name`` in a profiler trace."""
    return sum(e.count for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")
               and name in e.key)


def _trace_counts(windows: list, label: str) -> list:
    """(counted, traced) launches of windows that ran the same dispatch:
    the profiler may lose a device record at a window's edge (one in 24
    seen) but never invents one, while a graph that dropped or repeated a
    kernel would do so in every window. So no window traces more than it
    counted, and one traces exactly what it counted."""
    if not windows or any(t > c for c, t in windows) \
            or all(t != c for c, t in windows):
        raise AssertionError(f"{label}: launches (counted, traced) "
                             f"{windows}")
    return windows


@contextlib.contextmanager
def _cuda_trace():
    """torch.profiler's CUDA activity, the window padded by 50 ms of idle
    on each side."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        yield prof
        torch.cuda.synchronize()
        time.sleep(0.05)


def decode_chunk_probe(eng, cfg, sps) -> dict:
    """On a served graphed engine: the five prompts again. The first tick
    that replays a chunk prefill (and captures nothing) is profiled
    (`torch.profiler`, CUDA activity): the ``paged_prefill_kernel``
    launches in the trace are what the replays added to the counter
    (`_trace_counts`, over each such tick before two rows decode).
    Once two rows decode, their next decode chunk (the length the
    scheduler would take) is dispatched as a tick would (`probe_decode`,
    no host sync), then profiled once graphed and once eager on the same
    live state: the CUDA kernels' self time over the call's wall time,
    which ends in a synchronize, and the device span between CUDA events
    around it; and a 4-step chunk profiled three times each way, whose
    ``paged_decode_split_kernel`` launches in the trace are the counter's
    advance (steps x layers; `_trace_counts`). The residuals and lengths
    are put back after each. The requests then drain."""
    import numpy as np
    import torch
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quant_prefill as QP
    b, d = eng.batcher, eng.batcher._dispatch
    for p, sp in zip(serve_prompts(cfg), sps):
        eng.add_request(p, sp)
    prefill = []
    for _ in range(200):
        active = [i for i, r in enumerate(b.rows)
                  if r is not None and i not in b.prefilling]
        if len(active) >= 2:
            break
        c0, captures = QP.paged_prefill_cuda.launches, d.captures
        with _cuda_trace() as prof:
            eng.step()
        counted = QP.paged_prefill_cuda.launches - c0
        if counted and d.captures == captures:
            prefill.append((counted, _traced(prof, "paged_prefill_kernel")))
    else:
        raise AssertionError("serve paged graphs: two rows never decoded")
    _trace_counts(prefill, "serve paged graphs: replayed prefill ticks")
    n = b._chunk_len(active)
    mask = np.zeros((b.batch,), bool)
    mask[active] = True
    kept = _kept(b)                 # its graph captured, if it is not yet
    b._launch_decode(active, mask, n)
    torch.cuda.synchronize()
    _put_back(b, kept)
    probe_decode(b, active, n)
    out = {"chunk_steps": n, "sampled": b._needs_sampling(active),
           "rows": len(active), "prefill_ticks_counted_traced": prefill}
    k = min(n, 4)
    for mode in ("graphed", "eager"):
        d.enabled = mode == "graphed"
        kept = _kept(b)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        with _cuda_trace() as prof:
            t0 = time.perf_counter()
            e0.record()
            b._launch_decode(active, mask, n)
            e1.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _put_back(b, kept)
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        windows = []
        for _ in range(3):
            kept, c0 = _kept(b), QA.paged_decode_partials_cuda.launches
            with _cuda_trace() as prof:
                b._launch_decode(active, mask, k)
            _put_back(b, kept)
            windows.append((QA.paged_decode_partials_cuda.launches - c0,
                            _traced(prof, "paged_decode_split_kernel")))
        if any(c != k * cfg.n_layers for c, _ in windows):
            raise AssertionError(f"serve paged graphs ({mode}): {k} steps "
                                 f"counted {windows}")
        _trace_counts(windows, f"serve paged graphs ({mode}): {k}-step "
                               f"decode chunks")
        out[mode] = {"wall_ms": wall * 1e3, "device_kernel_ms": busy * 1e3,
                     "busy_share": busy / wall,
                     "event_span_ms": e0.elapsed_time(e1),
                     "kernel_launches_traced": sum(e.count for e in kernels),
                     f"paged_decode_{k}_steps_counted_traced": windows}
    d.enabled = True
    while eng.has_unfinished():
        eng.step()
    return out


def graphs_serve_full_width(dev, params, cfg, card: str,
                            greedy_tokens) -> dict:
    """Phase 5, serve paged graphs: the paged cell (five greedy requests)
    and the sampled cell (requests 1, 3, 4 sampled as in `serve paged
    sampled`), each served on the card graphed (a fresh engine: its
    captures included), eager (a fresh engine, every step dispatched
    eagerly) and graphed again (the first engine, replays only). Graphed
    tokens equal eager tokens, the paged cell's equal `serve paged`'s;
    every layer's pool pages and scales are the same bits graphed and
    eager; the launch counters, advanced through replays, equal the eager
    launches (in all and by page dtype). Prints tok/s, TTFT p50 and
    max_memory_allocated each way, the graphs (steps, shapes, warm-up and
    capture ms) and the graph pool's bytes, and per cell one decode chunk
    replayed with no host sync and its device busy share graphed against
    eager (`decode_chunk_probe`); then the long cell (`long_generation`).
    Returns each run's launch counts."""
    from repro_torch.serving import SamplingParams
    label = "serve paged graphs"
    mix = [SAMPLED_MIX[0], SAMPLED_MIX[1], SAMPLED_MIX[0], SAMPLED_MIX[2],
           SAMPLED_MIX[3]]
    cells = {"paged": [SamplingParams.greedy(max_new_tokens=48)] * 5,
             "sampled": [SamplingParams(max_new_tokens=48, **kw)
                         for kw in mix]}
    res, counts = {"card": card}, {}
    for cell, sps in cells.items():
        geng, gtoks, graphed = graph_cell(dev, params, cfg, sps,
                                          f"{label} {cell} graphed")
        eeng, etoks, eager = graph_cell(dev, params, cfg, sps,
                                        f"{label} {cell} eager", eager=True)
        pools_equal = same_pools(geng.batcher, eeng.batcher)
        del eeng
        if gtoks != etoks or (cell == "paged" and gtoks != greedy_tokens):
            raise AssertionError(f"{label} {cell}: graphed tokens differ "
                                 f"from the eager (or the served) tokens")
        if not pools_equal:
            raise AssertionError(f"{label} {cell}: graphed and eager pools "
                                 f"differ in their pages or scales")
        for k in ("launches", "launches_by_dtype"):
            if graphed[k] != eager[k]:
                raise AssertionError(f"{label} {cell}: {k} graphed "
                                     f"{graphed[k]}, eager {eager[k]}")
        _, wtoks, warm = graph_cell(dev, params, cfg, sps,
                                    f"{label} {cell} graphed warm", eng=geng)
        if wtoks != gtoks:
            raise AssertionError(f"{label} {cell}: the warm rerun's tokens "
                                 f"differ")
        graphs = graph_report(geng.batcher)
        chunk = decode_chunk_probe(geng, cfg, sps)
        del geng
        res[cell] = {"graphed": graphed, "eager": eager,
                     "graphed_warm": warm, "graphs": graphs,
                     "decode_chunk": chunk, "tokens_equal": True,
                     "pools_equal": True}
        counts[f"{label} {cell}"] = graphed["launches"]
        log(f"[{label}] {cell}: tokens graphed = eager"
            f"{' = serve paged' if cell == 'paged' else ''}, pools the "
            f"same bits, launches {graphed['launches']} both ways; "
            f"graphed (captures included) {graphed['tokens_per_s']:.2f} "
            f"tok/s, TTFT p50 {graphed['ttft_s_p50'] * 1e3:.1f} ms; graphed "
            f"warm {warm['tokens_per_s']:.2f} tok/s, TTFT p50 "
            f"{warm['ttft_s_p50'] * 1e3:.1f} ms; eager "
            f"{eager['tokens_per_s']:.2f} tok/s, TTFT p50 "
            f"{eager['ttft_s_p50'] * 1e3:.1f} ms; max_memory_allocated "
            f"{graphed['max_memory_allocated_bytes']} / "
            f"{eager['max_memory_allocated_bytes']} bytes; "
            f"{graphs['captures']} graphs captured in "
            f"{graphs['capture_ms']:.1f} ms, {graphs['replays']} replays, "
            f"graph pool {graphs['graph_pool_bytes']} bytes; one "
            f"{chunk['chunk_steps']}-step decode chunk replayed with no host "
            f"sync, busy share graphed {chunk['graphed']['busy_share']:.4f} "
            f"({chunk['graphed']['wall_ms']:.2f} ms) against eager "
            f"{chunk['eager']['busy_share']:.4f} "
            f"({chunk['eager']['wall_ms']:.2f} ms); {card}")
    res["long"], counts[f"{label} long"] = long_generation(dev, params, cfg,
                                                          card)
    log(f"[{label}] " + json.dumps(res))
    return counts


def long_generation(dev, params, cfg, card: str, against: str = "tick"):
    """Two requests of 512 new tokens (prompts 300 and 37; one greedy,
    one sampled as SAMPLED_MIX[1]) under the default chunk (no stop
    condition: a row decoding alone takes its whole budget as one
    512-step chunk), graphed on a fresh engine. A chunk of any length
    replays the one decode-scan step graph of its shape key, so what is
    captured does not grow with the chunk. Held against a fresh engine
    that decodes one token a tick (``against`` "tick": chunk 1, the
    decode and sampler graphs, the draws' steps uploaded each tick) or
    dispatches every step eagerly ("eager", chip_ab's: ~1000 eager steps,
    minutes): the same tokens and pools, and against eager the same
    launch counts (ticks of one token decode both rows in each step, so
    fewer). Returns (record, the graphed run's launch counts)."""
    from repro_torch.serving import SamplingParams
    label = "serve paged graphs long"
    prompts = serve_prompts(cfg)[2:4]
    sps = [SamplingParams.greedy(max_new_tokens=512),
           SamplingParams(max_new_tokens=512, **SAMPLED_MIX[1])]
    geng, gtoks, graphed = graph_cell(dev, params, cfg, sps,
                                      f"{label} graphed", prompts=prompts)
    oeng, otoks, other = graph_cell(
        dev, params, cfg, sps, f"{label} {against}", prompts=prompts,
        eager=against == "eager", chunk=1 if against == "tick" else None)
    if gtoks != otoks or list(map(len, gtoks)) != [512, 512]:
        raise AssertionError(f"{label}: graphed scan tokens differ from the "
                             f"{against} run's (lengths "
                             f"{list(map(len, gtoks))})")
    if not same_pools(geng.batcher, oeng.batcher):
        raise AssertionError(f"{label}: the pools differ from the "
                             f"{against} run's")
    if against == "eager" and graphed["launches"] != other["launches"]:
        raise AssertionError(f"{label}: launches graphed "
                             f"{graphed['launches']}, {against} "
                             f"{other['launches']}")
    graphs = graph_report(geng.batcher)
    chunks = sorted(n for n, _ in geng.batcher._chunk_fns)
    scans = [c for c in graphs["captured"] if c["step"] == "decode_scan_step"]
    if max(chunks) < 256 or not 1 <= len(scans) <= 2:
        raise AssertionError(f"{label}: chunk lengths {chunks}, "
                             f"{len(scans)} decode-scan step graphs")
    other["graphs"] = graph_report(oeng.batcher)
    del geng, oeng
    res = {"chunk_lengths": chunks, "graphed": graphed, against: other,
           "graphs": graphs, "tokens_equal": True, "pools_equal": True}
    log(f"[{label}] 2 x 512 tokens, chunks {chunks}: tokens graphed = "
        f"{against}, pools the same bits, launches {graphed['launches']} / "
        f"{other['launches']}; graphed (captures included) "
        f"{graphed['wall_s']:.3f} s, "
        f"{graphed['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{graphed['ttft_s_p50'] * 1e3:.1f} ms; {against} "
        f"{other['wall_s']:.3f} s, {other['tokens_per_s']:.2f} tok/s, TTFT "
        f"p50 {other['ttft_s_p50'] * 1e3:.1f} ms; {graphs['captures']} graphs "
        f"({len(scans)} decode-scan step) captured in "
        f"{graphs['capture_ms']:.1f} ms, {graphs['replays']} replays; "
        f"{card}")
    log(f"[{label}] " + json.dumps(res))
    return res, graphed["launches"]


def weight_bytes(params, cfg) -> dict:
    """Bytes of the parameters: all of them; what a decode step streams
    (all but the embedding table, of which it gathers B rows: an MoE's
    dispatch runs every expert over its capacity slots, so every expert's
    weights); and, for an MoE, what one token's route needs (the k experts
    it picks in each layer, not the other E - k)."""
    total = sum(t.numel() * t.element_size() for t in _leaves(params))
    emb = params["embed"]
    out = {"params": sum(t.numel() for t in _leaves(params)), "total": total,
           "decode_step": total - emb.numel() * emb.element_size()}
    if cfg.n_experts:
        m = params["layers"][0]["moe"]
        expert = sum(m[n][0].numel() * m[n].element_size()
                     for n in ("w_gate", "w_up", "w_down"))
        out["routed_per_token"] = total - cfg.n_layers * (
            cfg.n_experts - cfg.top_k) * expert
    return out


def decode_step_time(eng, cfg, sps, probe: bool = False) -> dict:
    """On a served graphed engine: the five prompts again, stepped until
    two rows decode; then one decode step of those rows (n = 1: the
    decode graph and the draw's) once to capture what it needs, and
    timed five times by CUDA events around the dispatch, the rows'
    residuals and lengths put back after each: the least. With ``probe``
    the dispatch of one step and of the scheduler's next chunk then run
    with any host sync an error (`probe_decode`). The requests then
    drain."""
    import numpy as np
    import torch
    b = eng.batcher
    for p, sp in zip(serve_prompts(cfg), sps):
        eng.add_request(p, sp)
    for _ in range(200):
        active = [i for i, r in enumerate(b.rows)
                  if r is not None and i not in b.prefilling]
        if len(active) >= 2:
            break
        eng.step()
    else:
        raise AssertionError(f"{cfg.name}: two rows never decoded")
    mask = np.zeros((b.batch,), bool)
    mask[active] = True
    n = b._chunk_len(active)
    for steps in sorted({1, n}):        # capture what the probes replay
        kept = _kept(b)
        b._launch_decode(active, mask, steps)
        torch.cuda.synchronize()
        _put_back(b, kept)
    times = []
    for _ in range(5):
        kept = _kept(b)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        e0.record()
        b._launch_decode(active, mask, 1)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        _put_back(b, kept)
    out = {"rows": len(active), "step_ms": min(times), "step_ms_all": times}
    if probe:
        out["probe_replays"] = {1: probe_decode(b, active, 1),
                                n: probe_decode(b, active, n)}
    while eng.has_unfinished():
        eng.step()
    return out


def arch_full_width(dev, arch: str, card: str) -> dict:
    """Phase 5 for one of the other served architectures, at full width
    with random bf16 weights from a seeded torch.Generator (QKV biases
    seeded non-zero): the five greedy prompts through the paged LLMEngine
    graphed on a fresh engine (captures included) and graphed again on
    it (replays only: the same tokens), every request 48 tokens inside
    the vocabulary; paged decode launched n_layers times a decode step and
    paged prefill n_layers times a chunk; one replayed decode step's
    device time against the weights it streams at 3.35 TB/s. The MoE
    also runs the prompts eager (tokens, pool bits and launches equal to
    graphed), the sampled mix (requests 1, 3 and 4 sampled) graphed and
    eager, and a decode step and chunk probed for host syncs; it and
    llama3_2_3b also serve the contiguous backend. Returns the launch
    counts by path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import SamplingParams
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = seeded_biases(T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev), cfg, 0)
    torch.cuda.synchronize()
    wb = weight_bytes(params, cfg)
    log(f"[{arch}] {wb['params']} params, {wb['total']} bytes (bf16; "
        f"norms, router and gate float32) on the card in "
        f"{time.perf_counter() - t0:.2f} s ({cfg.n_layers} layers, H/H_kv "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, d {cfg.d_model}); "
        f"memory_allocated {torch.cuda.memory_allocated(dev)}; {card}")
    label = f"serve {arch} paged"
    greedy = [SamplingParams.greedy(max_new_tokens=48)] * 5
    geng, toks, graphed = graph_cell(dev, params, cfg, greedy,
                                     f"{label} graphed")
    if list(map(len, toks)) != [48] * 5 or not all(
            0 <= t < cfg.vocab for ts in toks for t in ts):
        raise AssertionError(f"{label}: token budgets {list(map(len, toks))}"
                             f" or a token outside the vocabulary")
    if cfg.n_experts:                   # eager beside the first graphed run
        eeng, etoks, eager = graph_cell(dev, params, cfg, greedy,
                                        f"{label} eager", eager=True)
        if etoks != toks or not same_pools(geng.batcher, eeng.batcher) \
                or eager["launches"] != graphed["launches"]:
            raise AssertionError(f"{label}: eager tokens, pools or "
                                 f"launches differ from graphed")
        del eeng
    _, wtoks, warm = graph_cell(dev, params, cfg, greedy,
                                f"{label} graphed again", eng=geng)
    if wtoks != toks:
        raise AssertionError(f"{label}: graphed again gives other tokens")
    L, counts = cfg.n_layers, graphed["launches"]
    if counts["paged_decode"] % L or counts["paged_prefill"] % L:
        raise AssertionError(f"{label}: launches {counts} are not whole "
                             f"steps of {L} layers")
    graphs = graph_report(geng.batcher)
    steps = {c["step"].split("[")[0] for c in graphs["captured"]}
    if not {"decode_scan_step", "chunk_prefill"} <= steps:
        raise AssertionError(f"{label}: captured {sorted(steps)}")
    step = decode_step_time(geng, cfg, greedy, probe=bool(cfg.n_experts))
    bound_ms = wb["decode_step"] / HBM_BYTES_PER_S * 1e3
    res = {"arch": arch, "card": card, "weight_bytes": wb,
           "graphed": graphed, "graphed_again": warm, "graphs": graphs,
           "decode_step": step, "decode_step_bound_ms": bound_ms,
           "decode_steps": counts["paged_decode"] // L,
           "prefill_chunks": counts["paged_prefill"] // L}
    out = {f"{label} graphed": counts}
    log(f"[{label}] 5/5 requests, 240 tokens: graphed (captures included) "
        f"{graphed['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{graphed['ttft_s_p50'] * 1e3:.1f} ms; graphed again "
        f"{warm['tokens_per_s']:.2f} tok/s, TTFT p50 "
        f"{warm['ttft_s_p50'] * 1e3:.1f} ms, same tokens; "
        f"max_memory_allocated {graphed['max_memory_allocated_bytes']} "
        f"bytes; {graphs['captures']} graphs captured in "
        f"{graphs['capture_ms']:.1f} ms; paged_decode {counts['paged_decode']}"
        f" launches = {L} layers x {res['decode_steps']} steps, "
        f"paged_prefill {counts['paged_prefill']} = {L} x "
        f"{res['prefill_chunks']} chunks; one replayed decode step "
        f"{step['step_ms']:.3f} ms on the device against "
        f"{bound_ms:.3f} ms to stream {wb['decode_step']} weight bytes at "
        f"3.35 TB/s ({bound_ms / step['step_ms']:.3f} of the bound)"
        + (f"; one token's route needs {wb['routed_per_token']} of them"
           if cfg.n_experts else "") + f"; {card}")
    if cfg.n_experts:
        mix = [SAMPLED_MIX[0], SAMPLED_MIX[1], SAMPLED_MIX[0],
               SAMPLED_MIX[2], SAMPLED_MIX[3]]
        sps = [SamplingParams(max_new_tokens=48, **kw) for kw in mix]
        seng, stoks, sgraphed = graph_cell(dev, params, cfg, sps,
                                           f"{label} sampled graphed")
        teng, ttoks, seager = graph_cell(dev, params, cfg, sps,
                                         f"{label} sampled eager",
                                         eager=True)
        if stoks != ttoks or not same_pools(seng.batcher, teng.batcher):
            raise AssertionError(f"{label} sampled: graphed and eager "
                                 f"tokens or pools differ")
        if [stoks[i] for i in (0, 2)] != [toks[i] for i in (0, 2)] or \
                any(stoks[i] == toks[i] for i in (1, 3)):
            raise AssertionError(f"{label} sampled: greedy rows differ "
                                 f"from the greedy run or sampled rows "
                                 f"equal it")
        del seng, teng
        res.update({"eager": eager, "sampled_graphed": sgraphed,
                    "sampled_eager": seager})
        out[f"{label} sampled graphed"] = sgraphed["launches"]
        log(f"[{label}] eager: tokens, pool bits and launches equal "
            f"graphed; {eager['tokens_per_s']:.2f} tok/s, TTFT p50 "
            f"{eager['ttft_s_p50'] * 1e3:.1f} ms; sampled (requests 1, 3, 4"
            f") graphed = eager tokens and pools, greedy rows = the greedy "
            f"run's; graphed {sgraphed['tokens_per_s']:.2f} tok/s, eager "
            f"{seager['tokens_per_s']:.2f} tok/s; decode step and a "
            f"{max(step['probe_replays'])}-step chunk replayed with no host "
            f"sync; {card}")
    del geng
    if arch in ("llama3_2_3b", "qwen2_moe_a2_7b", "qwen2_vl_2b"):
        out[f"serve {arch} contiguous"] = serve_full_width(
            dev, params, cfg, paged=False, tag=arch)[0]
    log(f"[{label}] " + json.dumps(res))
    del params
    torch.cuda.empty_cache()
    return out


# phase 5's recurrent and sliding-window models: the five prompts and two
# past recurrentgemma_9b's 2048 window; mixtral_8x22b cut to 4 of its 56
# layers (full width; ~20.8 GB) with a prompt past its 4096 window
RECURRENT_LONG = (2500, 3000)
MIXTRAL_LAYERS = 4
MIXTRAL_LONG = 4500


def _instrument_steps(b, cfg) -> dict:
    """Wrap a contiguous batcher's prefill, decode and decode-scan step to
    count rebuild prefills, decode steps and block flushes (a step that
    fills the attention caches' current block) and to bracket each decode
    step by CUDA events (the host's enqueue included: the card waits on
    it) and the host clock (the enqueue alone)."""
    import torch
    attn = [i for i in range(cfg.n_layers)
            if cfg.block_kind(i) in ("attn", "local_attn", "moe")]
    rec = {"prefills": 0, "steps": 0, "flushes": 0, "events": [],
           "host_s": [], "n_attn": len(attn)}

    def step(fn, state_arg):
        def run(*a, **kw):
            if attn:
                c = a[state_arg][attn[0]]
                rec["flushes"] += c.length % c.block_size == c.block_size - 1
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            rec["host_s"].append(time.perf_counter() - t0)
            rec["events"].append((e0, e1))
            rec["steps"] += 1
            return out
        return run

    def prefill(fn):
        def run(*a, **kw):
            rec["prefills"] += 1
            return fn(*a, **kw)
        return run

    b._prefill = prefill(b._prefill)
    b._decode = step(b._decode, 2)
    b._scan_step = step(b._scan_step, 1)
    return rec


def _serve_as_predicted(dev, params, cfg, max_len, prompts, max_new: int,
                        label: str) -> dict:
    """``prompts`` through a fresh contiguous LLMEngine (batch 4), greedy,
    ``max_new`` tokens each, every request finishing by length inside the
    vocabulary; the launches must be those predicted from the scheduler's
    own calls (`_instrument_steps`): flash forward n_attn a rebuild
    prefill, flat decode n_attn a decode step, quantize_blocked 2 n_attn a
    prefill and a block flush (K and V). Returns the record."""
    import numpy as np
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    eng = LLMEngine(params, cfg, EngineConfig(batch=4, max_len=max_len),
                    device=dev)
    rec = _instrument_steps(eng.batcher, cfg)
    n = rec["n_attn"]
    needs = ("flash_fwd", "flat_decode", "quantize_blocked") if n else ()
    sp = SamplingParams.greedy(max_new_tokens=max_new)
    outs, wall, counts, peak = _run_path(
        dev, label, needs, lambda: eng.generate(prompts, sp))
    if [o.finish_reason for o in outs] != ["length"] * len(prompts) or any(
            len(o.token_ids) != max_new for o in outs) or not all(
            0 <= t < cfg.vocab for o in outs for t in o.token_ids):
        raise AssertionError(f"{label}: a request did not finish by length "
                             f"with {max_new} tokens inside the vocabulary")
    want = {"flash_fwd": n * rec["prefills"], "flat_decode": n * rec["steps"],
            "quantize_blocked": 2 * n * (rec["prefills"] + rec["flushes"])}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: launches {counts} differ from the "
                             f"predicted {want} ({rec['prefills']} prefills, "
                             f"{rec['steps']} decode steps, "
                             f"{rec['flushes']} flushes, {n} attention "
                             f"layers)")
    steps_ms = [a.elapsed_time(b) for a, b in rec["events"]]
    rep = eng.pool_report()
    gen_tokens = sum(len(o.token_ids) for o in outs)
    return {"prompt_lens": [len(p) for p in prompts], "max_len": max_len,
            "max_new": max_new, "generated_tokens": gen_tokens,
            "wall_s": wall, "tokens_per_s": gen_tokens / wall,
            "ttft_s_p50": rep["ttft_s_p50"], "ttft_s_p90": rep["ttft_s_p90"],
            "ticks": rep["ticks"], "launches": counts,
            "predicted_launches": want, "n_attn": n,
            "prefills": rec["prefills"], "decode_steps": rec["steps"],
            "flushes": rec["flushes"], "max_memory_allocated_bytes": peak,
            "decode_step_ms_min": min(steps_ms),
            "decode_step_ms_median": float(np.median(steps_ms)),
            "decode_step_host_ms_median": 1e3 * float(np.median(
                rec["host_s"]))}


def _launch_text(r: dict) -> str:
    n, c = r["n_attn"], r["launches"]
    if not n:
        return ("no attention layer, so the path runs no attention kernel "
                "and needs none (launches all 0)")
    return (f"flash_fwd {c['flash_fwd']} = {n} x {r['prefills']} prefills, "
            f"flat_decode {c['flat_decode']} = {n} x {r['decode_steps']} "
            f"steps, quantize_blocked {c['quantize_blocked']} = 2 x {n} x "
            f"({r['prefills']} prefills + {r['flushes']} flushes), as "
            f"predicted")


def recurrent_serve_full_width(dev, arch: str, card: str) -> dict:
    """One of recurrentgemma_9b (38 layers), xlstm_350m (24) or
    mixtral_8x22b (4 of 56 layers) at full width, bf16 weights from a
    seeded generator (RG-LRU gate vectors seeded per channel), through the
    contiguous LLMEngine (`_serve_as_predicted`): the five prompts and
    prompts past the window (2500 and 3000; mixtral 4500), 48 tokens
    each; then, with attention layers, one prompt of the window's length
    (the ring full at prefill) and 264 tokens, which flush a block into
    the wrapped ring. Reports tok/s, TTFT p50, peak memory, weight bytes
    and the least event-timed decode step against the bytes it
    streams."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    cut = None
    long = RECURRENT_LONG
    if arch == "mixtral_8x22b":
        cut = f"{MIXTRAL_LAYERS} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=MIXTRAL_LAYERS)
        long = (MIXTRAL_LONG,)
    t0 = time.perf_counter()
    params = seeded_gates(T.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev), 0)
    torch.cuda.synchronize()
    wb = weight_bytes(params, cfg)
    init_s = time.perf_counter() - t0
    rng = np.random.RandomState(1)
    prompts = serve_prompts(cfg) + [
        rng.randint(0, cfg.vocab, (n,)).astype(np.int32) for n in long]
    max_len = 8192 if arch == "mixtral_8x22b" else 4096
    label = f"serve {arch} contiguous"
    r = _serve_as_predicted(dev, params, cfg, max_len, prompts, 48, label)
    bound_ms = wb["decode_step"] / HBM_BYTES_PER_S * 1e3
    res = {"arch": arch, "card": card, "cut": cut, "layers": cfg.n_layers,
           "weight_bytes": wb, "init_s": init_s, **r,
           "decode_step_bound_ms": bound_ms}
    out = {label: r["launches"]}
    log(f"[{label}] {cfg.n_layers} layers" + (f" ({cut})" if cut else "")
        + f", {wb['params']} params, {wb['total']} weight bytes; "
        f"{len(prompts)}/{len(prompts)} requests (prompts "
        f"{r['prompt_lens']}) finished by length: {r['generated_tokens']} "
        f"tokens in {r['wall_s']:.3f} s ({r['tokens_per_s']:.2f} tok/s), "
        f"TTFT p50 {r['ttft_s_p50'] * 1e3:.1f} ms, max_memory_allocated "
        f"{r['max_memory_allocated_bytes']} bytes; {_launch_text(r)}; a "
        f"decode step {r['decode_step_ms_min']:.3f} ms least, "
        f"{r['decode_step_ms_median']:.3f} ms median by CUDA events (host "
        f"enqueue {r['decode_step_host_ms_median']:.3f} ms median) against "
        f"{bound_ms:.3f} ms to stream {wb['decode_step']} weight bytes at "
        f"3.35 TB/s; {card}")
    if r["n_attn"]:
        flush = _serve_as_predicted(
            dev, params, cfg, max_len, [rng.randint(
                0, cfg.vocab, (cfg.sliding_window,)).astype(np.int32)], 264,
            f"{label} flush")
        if flush["flushes"] < 1:
            raise AssertionError(f"{label} flush: no block flushed")
        res["flush_cell"] = flush
        out[f"{label} flush"] = flush["launches"]
        log(f"[{label} flush] a {cfg.sliding_window}-token prompt (the ring "
            f"full) and 264 tokens: {_launch_text(flush)}; "
            f"{flush['tokens_per_s']:.2f} tok/s; {card}")
    log(f"[{label}] " + json.dumps(res))
    del params
    return out, res

def whisper_weight_bytes(params) -> dict:
    """Parameter bytes of an encoder-decoder: all; what one decode step
    reads (every decoder layer's weights but the cross-attention K / V
    projections, which run at prefill only, and the tied embedding as the
    head)."""
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    step = [t for layer in params["dec_layers"]
            for name, sub in layer.items() for k, t in sub.items()
            if not (name == "cross_attn" and k in ("wk", "wv"))]
    return {"params": sum(t.numel() for t in _leaves(params)),
            "total": nbytes(_leaves(params)),
            "decode_step": nbytes(step) + nbytes([params["embed"]])}


def whisper_full_width(dev, card: str) -> dict:
    """whisper_small at full width (12 + 12 layers, bf16 weights from a
    seeded generator) through `make_serve_fns`: `make_frames` frames (4,
    1500, 768) at seed 0, 256-token prompts (a block multiple, as the
    per-block self cache takes), max_len 512, then 48 greedy decode steps.
    The launches must be those predicted: at the prefill flash forward 36
    (12 encoder layers, 12 self, 12 cross), quantize_blocked 24 (self K
    and V), absmax and quantize_with_scales 24 each (the cross caches' K
    and V per channel over 1504 slots); flat decode 24 a decode step (self
    and cross); no flush (256 + 48 < 512). Reports the encoder's time
    (CUDA events), TTFT, tok/s, peak memory and the least event-timed
    decode step against its weight and cross-cache bytes."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_frames
    from repro_torch.models import encdec
    cfg = get_config(WHISPER)
    B, S, steps = 4, WHISPER_PROMPT, WHISPER_STEPS
    t0 = time.perf_counter()
    params = encdec.init_params(cfg, torch.Generator(device=dev).manual_seed(
        0), device=dev)
    torch.cuda.synchronize()
    wb = whisper_weight_bytes(params)
    init_s = time.perf_counter() - t0
    frames = torch.from_numpy(make_frames(DataConfig(
        seq_len=S, global_batch=B, vocab=cfg.vocab, seed=0), cfg.d_model,
        cfg.encoder_seq)).to(dev)
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    # the encoder alone, warm, by CUDA events
    encdec.encode(params, frames, cfg)
    enc_ms = []
    for _ in range(3):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        encdec.encode(params, frames, cfg)
        e1.record()
        torch.cuda.synchronize()
        enc_ms.append(e0.elapsed_time(e1))
    L, E = cfg.n_layers, cfg.n_encoder_layers
    want = {"flash_fwd": E + 2 * L, "quantize_blocked": 2 * L,
            "absmax": 2 * L, "quantize_with_scales": 2 * L,
            "flat_decode": 2 * L * steps, "paged_decode": 0,
            "paged_prefill": 0, "seed_decode": 0, "dequantize": 0}
    label = f"serve {WHISPER} make_serve_fns"
    r, wall, counts, peak = _run_path(
        dev, label, ("flash_fwd", "quantize_blocked", "absmax",
                     "quantize_with_scales", "flat_decode"),
        lambda: whisper_serve(params, cfg, frames, tokens, steps,
                              WHISPER_MAX_LEN, dev, events=True))
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} differ from the "
                             f"predicted {want}")
    toks = r["tokens"]
    if len(toks) != B or any(len(t) != steps + 1 for t in toks) or not all(
            0 <= t < cfg.vocab for ts in toks for t in ts):
        raise AssertionError(f"{label}: token budgets or a token outside "
                             f"the vocabulary")
    cross = r["state"]["cross"]
    if any(c.length != cfg.encoder_seq or c.max_len != 1504 for c in cross):
        raise AssertionError(f"{label}: cross caches not at 1500 of 1504")
    cross_bytes = sum(t.numel() * t.element_size() for c in cross
                      for t in (c.k_q, c.v_q, c.k_s, c.v_s)) \
        * cfg.encoder_seq // 1504
    step_bytes = wb["decode_step"] + cross_bytes
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    gen_tokens = B * (steps + 1)
    res = {"arch": WHISPER, "card": card, "weight_bytes": wb,
           "init_s": init_s, "encoder_ms": enc_ms, "ttft_s": r["ttft_s"],
           "wall_s": wall, "generated_tokens": gen_tokens,
           "tokens_per_s": gen_tokens / wall, "launches": counts,
           "predicted_launches": want, "max_memory_allocated_bytes": peak,
           "decode_step_ms_min": min(r["step_ms"]),
           "decode_step_ms_median": float(np.median(r["step_ms"])),
           "cross_cache_bytes_read": cross_bytes,
           "decode_step_bound_ms": bound_ms}
    log(f"[{label}] 12 + 12 layers, {wb['params']} params, {wb['total']} "
        f"weight bytes; frames ({B}, {cfg.encoder_seq}, {cfg.d_model}), "
        f"prompts {B} x {S}: the encoder {min(enc_ms):.3f} ms (least of 3, "
        f"CUDA events); TTFT {r['ttft_s'] * 1e3:.1f} ms; {gen_tokens} tokens "
        f"in {wall:.3f} s ({res['tokens_per_s']:.2f} tok/s); "
        f"max_memory_allocated {peak} bytes; launches as predicted (flash "
        f"{counts['flash_fwd']} = {E} + 2 x {L}, quantize_blocked "
        f"{counts['quantize_blocked']}, absmax + quantize_with_scales "
        f"{counts['absmax']} + {counts['quantize_with_scales']}, flat decode "
        f"{counts['flat_decode']} = 2 x {L} x {steps}); a decode step "
        f"{res['decode_step_ms_min']:.3f} ms least, "
        f"{res['decode_step_ms_median']:.3f} ms median (CUDA events) against "
        f"{bound_ms:.3f} ms to read {wb['decode_step']} weight bytes and "
        f"{cross_bytes} cross-cache bytes at 3.35 TB/s; {card}")
    log(f"[{label}] " + json.dumps(res))
    del params, r
    return {label: counts}


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


def _init_model(cfg, dev):
    """The train CLI's weights: seed 0 on the card, by family."""
    import torch
    from repro_torch.models import encdec
    from repro_torch.models import transformer as T
    init = encdec.init_params if cfg.family == "encdec" else T.init_params
    return init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def _train_batch(cfg, B: int, S: int, dev) -> dict:
    """The train CLI's batch of step 0 (SyntheticLM seed 0; make_frames
    frames for an encoder-decoder)."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM, make_frames
    dcfg = DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab, seed=0)
    b = SyntheticLM(dcfg).batch_at(0)
    if cfg.family == "encdec":
        b["frames"] = make_frames(dcfg, cfg.d_model, cfg.encoder_seq, 0)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _plain_flash_loss(dev, cfg, batch):
    """Step 0's loss of the train CLI's model (seed 0 weights) with the
    forward's attention through the plain flash version on the card, and
    through the kernel, no gradients."""
    import torch
    from repro_torch.kernels import flash_fwd as FF
    from repro_torch.training.step import loss_fn
    params = _init_model(cfg, dev)
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


@contextlib.contextmanager
def _registry_config(cfg):
    """The config registry answering ``cfg`` (a depth cut of a registered
    model) for its name: the train CLI's `main` then trains the cut model
    through its own code, no flag added."""
    import repro_torch.configs as C
    orig = C.get_config

    def get_config(name, smoke=False):
        if name.replace("-", "_") == cfg.name and not smoke:
            return cfg
        return orig(name, smoke=smoke)
    C.get_config = get_config
    try:
        yield
    finally:
        C.get_config = orig


def _n_attn(cfg) -> int:
    """Flash forward calls in one forward: an attention block's one; an
    encoder-decoder's encoder, self and cross attention."""
    from repro_torch.models import transformer as T
    if cfg.family == "encdec":
        return cfg.n_encoder_layers + 2 * cfg.n_layers
    return sum(cfg.block_kind(i) in T.ATTN_KINDS for i in range(cfg.n_layers))


def _train_runs(dev, cfg, B: int, S: int, runs: tuple, tag: str) -> dict:
    """`launch.train.main` on ``cfg`` (through `_registry_config`), one
    run of each (label, extra argv, steps), each freed before the next:
    finite losses and grad norms, and flash launches of at least 2 (the
    forward and the recompute) x `_n_attn` x steps (none without
    attention). Returns {label: {steps, wall_s, launches, peak}}."""
    import torch
    from repro_torch.launch import train as train_cli
    argv = ["--arch", cfg.name, "--batch", str(B), "--seq", str(S),
            "--log-every", "1"]
    n_attn = _n_attn(cfg)
    out = {}
    for label, extra, steps in runs:
        needs = (("flash_fwd",) if n_attn else ()) + (
            ("absmax", "quantize_with_scales", "dequantize")
            if "--grad-compression" in extra else ())
        rows = []
        with _registry_config(cfg):
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
        if counts["flash_fwd"] < 2 * n_attn * steps or (
                not n_attn and counts["flash_fwd"]):
            raise AssertionError(f"{label}: {counts['flash_fwd']} flash "
                                 f"launches against 2 x {n_attn} x {steps}")
        out[label] = {"steps": rows, "wall_s": wall, "launches": counts,
                      "max_memory_allocated_bytes": peak}
        SINGLE[label] = out[label]
        for r in rows:
            log(f"[{label}] step {r['step']}: loss {r['loss']:.5f} aux "
                f"{r['aux_loss']:.5f} grad_norm {r['grad_norm']:.4f} lr "
                f"{r['lr']:.3e} step {r['step_ms']:.1f} ms "
                f"({r['tokens_per_s']:.0f} tok/s){tag}")
        log(f"[{label}] {steps} steps in {wall:.2f} s, launches {counts}, "
            f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB){tag}")
    return out


def _step0_check(dev, cfg, B: int, S: int, cli0: float, label: str) -> dict:
    """Step 0's loss of the CLI run (the kernel) against the same forward
    through the plain flash version on the card: within LOSS_RTOL."""
    import torch
    losses = _plain_flash_loss(dev, cfg, _train_batch(cfg, B, S, dev))
    rel = abs(cli0 - losses["plain"]) / abs(losses["plain"])
    SINGLE[label]["plain_flash_loss"] = losses["plain"]
    if rel > LOSS_RTOL:
        raise AssertionError(f"{label}: step-0 loss through the kernel "
                             f"{cli0} vs plain flash {losses['plain']}: "
                             f"{rel:.2e} > {LOSS_RTOL:g}")
    log(f"[{label}] step-0 loss: CLI (kernel) {cli0:.6f}, forward with "
        f"kernel {losses['kernel']:.6f}, with plain flash "
        f"{losses['plain']:.6f} (rel diff {rel:.2e} <= {LOSS_RTOL:g})")
    gc.collect()
    torch.cuda.empty_cache()
    return {"cli_kernel": cli0, **losses, "rel_diff": rel}


def train_full_width(dev):
    """`launch.train.main` at full width: 3 steps of internlm2_1_8b at
    batch 4 x 2048 (SyntheticLM seed 0, no checkpoint dir), then, after
    that run's state is freed, 1 step with --grad-compression. flash_fwd
    runs in each block's forward and again in its recompute: >= 2 x 24
    launches a step. Step 0's loss is held against the same forward
    through the plain flash version on the card."""
    from repro_torch.configs import get_config
    cfg = get_config("internlm2_1_8b")
    B, S = 4, 2048
    runs = _train_runs(dev, cfg, B, S, (
        ("train", [], 3), ("train compressed", ["--grad-compression"], 1)),
        "")
    runs["step0_loss"] = _step0_check(dev, cfg, B, S,
                                      runs["train"]["steps"][0]["loss"],
                                      "train")
    log("[train] " + json.dumps(runs))
    return {k: v["launches"] for k, v in runs.items() if "launches" in v}


# the other families through the train CLI, one model at a time: (arch,
# layers kept (None: uncut), batch, sequence, steps, compressed steps).
# recurrentgemma_9b's 5 layers are one group of its pattern and a tail of
# two RG-LRU layers, as its 38 = 12 x 3 + 2 (3.09 B params: 49.4 GB of
# bf16 weights and gradients and float32 m, v and master weights), over
# 4096 tokens past its 2048 window; qwen2_moe_a2_7b's 4 of 24 layers
# (2.90 B params); whisper_small's 448 is its text context
# (arXiv:2212.04356), its frames (4, 1500, 768)
TRAIN_FAMILIES = (
    ("qwen2_vl_2b", None, 4, 2048, 2, 0),
    ("xlstm_350m", None, 4, 2048, 2, 0),
    (WHISPER, None, 4, 448, 2, 0),
    ("recurrentgemma_9b", 5, 1, 4096, 2, 1),
    ("qwen2_moe_a2_7b", 4, 2, 2048, 2, 0),
)


def train_families_full_width(dev, card: str) -> dict:
    """Each model of TRAIN_FAMILIES trained through the CLI (`_train_runs`:
    step ms with step 0 apart, tokens/s, loss, aux, grad_norm, launches,
    peak memory), its parameters' bytes, and with attention step 0's loss
    against the plain flash forward's (`_step0_check`); freed before the
    next. Returns the launch counts by path."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models import transformer as T
    counts, report = {}, {}
    for arch, layers, B, S, steps, comp in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        init = encdec.init_params if cfg.family == "encdec" else \
            T.init_params
        meta = list(_leaves(init(cfg, torch.Generator(), device="meta")))
        size = {"params": sum(t.numel() for t in meta),
                "bytes": sum(t.numel() * t.element_size() for t in meta)}
        cut = f" ({layers} of {get_config(arch).n_layers} layers)" \
            if layers else ""
        runs = _train_runs(dev, cfg, B, S, (
            (f"train {arch}", [], steps),
            *(((f"train {arch} compressed", ["--grad-compression"],
                comp),) if comp else ())), f"; {card}")
        first = runs[f"train {arch}"]["steps"]
        res = {"layers": cfg.n_layers, "batch": B, "seq": S, **size,
               "step0_ms": first[0]["step_ms"],
               "step_ms": [r["step_ms"] for r in first[1:]],
               "tokens_per_s": [r["tokens_per_s"] for r in first[1:]],
               **runs}
        if _n_attn(cfg):
            res["step0_loss"] = _step0_check(dev, cfg, B, S, first[0]["loss"],
                                             f"train {arch}")
        report[arch] = res
        counts.update({k: v["launches"] for k, v in runs.items()})
        log(f"[train {arch}]{cut} {size['params']} params, {size['bytes']} "
            f"B; step 0 {res['step0_ms']:.1f} ms, then "
            f"{res['step_ms']} ms, {res['tokens_per_s']} tok/s; phase "
            f"{time.perf_counter() - t0:.1f} s; {card}")
    log("[train families] " + json.dumps(report))
    return counts


# -- sharded training: ranks of a mesh sharing the card over gloo ------------

# the single-process train runs of this call, by label (`_train_runs`):
# what the sharded runs are held against
SINGLE: dict = {}
SHARDED_MESH = ((2, 2), ("data", "model"))
# (arch, layers kept (None: uncut), batch, sequence, steps, compressed
# steps, the single-process run's label and its --steps (its schedule))
SHARDED_RUNS = (
    ("internlm2_1_8b", None, 4, 2048, 2, 1, "train", 3),
    ("qwen2_moe_a2_7b", 4, 2, 2048, 2, 0, "train qwen2_moe_a2_7b", 2),
)
SHARDED_TIMEOUT_S = 600


def _cut(arch: str, layers):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _sharded_run(mesh, dev, arch: str, layers, B: int, S: int, steps: int,
                 comp: bool, sched_steps: int) -> dict:
    """One sharded run on this rank: seed-0 weights, each part cut to this
    rank's shards as it is made (`launch.specs.init_shards`), then
    ``steps`` steps of the global
    SyntheticLM batches through `make_train_step` under `mesh_context`,
    with the train CLI's schedule for ``sched_steps`` steps. Launches,
    collective stats and peak memory from this run alone."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import specs as SP
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.shard import mesh_context
    from repro_torch.training.step import init_opt_state, make_train_step
    cfg = _cut(arch, layers)
    specs = SP.train_specs(cfg, mesh, comp)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = SP.init_shards(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, specs["params"], mesh)
    init_peak = torch.cuda.max_memory_allocated(dev)
    opt = init_opt_state(params, cfg, grad_compression=comp)
    step_fn = make_train_step(
        cfg, AdamWConfig(lr=3e-4, warmup_steps=min(20, sched_steps // 10
                                                   + 1),
                         total_steps=sched_steps), grad_compression=comp,
        specs=specs)
    data = SyntheticLM(DataConfig(seq_len=S, global_batch=B,
                                  vocab=cfg.vocab, seed=0))
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    rows = []
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(i).items()}
        torch.cuda.synchronize(dev)
        mesh.stats.clear()
        t0 = time.perf_counter()
        with mesh_context(mesh):
            params, opt, m = step_fn(params, opt, b)
        torch.cuda.synchronize(dev)
        rows.append({"step": i, **{k: float(v) for k, v in m.items()},
                     "step_ms": (time.perf_counter() - t0) * 1e3,
                     "collectives": {f"{op}:{'+'.join(ax)}": {
                         "calls": v[0], "bytes": v[1], "host_s": v[2]}
                         for (op, ax), v in mesh.stats.items()}})
    out = {"steps": rows,
           "launches": {k: c.launches for k, c in counters.items()},
           "collectives": rows[-1]["collectives"],
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "init_peak_bytes": init_peak,
           "state_bytes": sum(t.numel() * t.element_size()
                              for t in _leaves({"p": params, "o": opt}))}
    sent = [{k: v["bytes"] for k, v in r["collectives"].items()}
            for r in rows]
    if any(x != sent[0] for x in sent):
        raise AssertionError(f"{arch}: the steps sent other bytes: {sent}")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _sharded_rank(rank: int, world: int, rdzv: str, sizes, axes, runs,
                  out_dir: str):
    """A spawned rank on card rank % cards (one card: every rank on
    cuda:0, and the process group is gloo), the mesh, then each run of
    ``runs``; writes its report to out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.parallel.shard import Mesh, init_distributed
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    backend = init_distributed(dev, rank=rank, world=world,
                               init_method=rdzv, timeout_s=300)
    mesh = Mesh(sizes, axes, dev)
    report = {"rank": rank, "backend": backend, "coords": mesh.coords,
              "staged": mesh.staged, "runs": {}}
    for label, arch, layers, B, S, steps, comp, sched in runs:
        report["runs"][label] = _sharded_run(mesh, dev, arch, layers, B, S,
                                             steps, comp, sched)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()


def _spawn_ranks(world: int, sizes, axes, runs, label: str) -> list:
    """``world`` ranks of `_sharded_rank` (spawned, ``file://``
    rendezvous, SHARDED_TIMEOUT_S); their reports in rank order."""
    import tempfile

    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="sharded-")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_sharded_rank, args=(
        r, world, f"file://{tmp}/rdzv", sizes, axes, runs, tmp))
        for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + SHARDED_TIMEOUT_S
    for p in procs:
        p.join(max(end - time.monotonic(), 1))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"{label}: ranks exited {codes}")
    return [json.loads(Path(tmp, f"rank{r}.json").read_text())
            for r in range(world)]


def _hold_sharded(label: str, reps: list, single: dict, n_attn: int,
                  comp: bool):
    """The sharded run ``label``'s checks on every rank's report: losses
    within LOSS_RTOL and grad norms within GNORM_RTOL of the same model's
    single-process steps of this call, the metrics equal on every rank,
    flash launched >= 2 x n_attn x steps on each rank (forward and
    recompute), the pair and dequantize with compression."""
    rows = reps[0]["runs"][label]["steps"]
    for rep in reps[1:]:
        if [r["loss"] for r in rep["runs"][label]["steps"]] != \
                [r["loss"] for r in rows]:
            raise AssertionError(f"{label}: ranks disagree on the loss")
    for r, s in zip(rows, single["steps"]):
        for key, tol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL)):
            rel = abs(r[key] - s[key]) / abs(s[key])
            if not rel <= tol:
                raise AssertionError(
                    f"{label}: step {r['step']} {key} {r[key]} against "
                    f"the single process's {s[key]}: {rel:.2e} > {tol:g}")
    for rep in reps:
        got = rep["runs"][label]["launches"]
        if got["flash_fwd"] < 2 * n_attn * len(rows):
            raise AssertionError(f"{label}: rank {rep['rank']} launched "
                                 f"flash {got['flash_fwd']} times")
        if comp and min(got[k] for k in ("absmax", "quantize_with_scales",
                                         "dequantize")) < 1:
            raise AssertionError(f"{label}: rank {rep['rank']} skipped "
                                 f"the compression kernels: {got}")


def sharded_full_width(dev, card: str) -> dict:
    """Sharded training on the card (`SHARDED_RUNS`): the parent frees its
    card memory and spawns 4 ranks on cuda:0 over gloo, mesh (data 2,
    model 2): internlm2_1_8b uncut at 4 x 2048 (2 x 1024 a rank), 2
    steps, then a fresh run of 1 step with --grad-compression, and
    qwen2_moe_a2_7b at 4 of 24 layers, 2 x 2048, 2 steps; each held
    against the same model's single-process steps of this call and its
    step-0 loss against the plain flash forward's (`_hold_sharded`); per
    rank: peak memory (and the weights' init peak), step ms, bytes by
    collective and axes. Then one rank at (1, 1) over NCCL (the backend
    asserted) takes internlm2_1_8b's first step. Returns the launch
    counts by path, summed over ranks."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    sizes, axes = SHARDED_MESH
    world = math.prod(sizes)
    runs, checks = [], []
    for arch, layers, B, S, steps, comp, single, sched in SHARDED_RUNS:
        label = f"train sharded {arch}"
        runs.append((label, arch, layers, B, S, steps, False, sched))
        checks.append((label, arch, layers, B, S, single, False))
        if comp:
            runs.append((f"{label} compressed", arch, layers, B, S, comp,
                         True, comp))
            checks.append((f"{label} compressed", arch, layers, B, S,
                           f"{single} compressed", True))
    t0 = time.perf_counter()
    reps = _spawn_ranks(world, sizes, axes, tuple(runs), "sharded")
    wall = time.perf_counter() - t0
    if {r["backend"] for r in reps} != {"gloo"}:
        raise AssertionError(f"sharded: backends {[r['backend'] for r in reps]}")
    counts, report = {}, {"mesh": dict(zip(axes, sizes)), "wall_s": wall,
                          "card": card}
    for label, arch, layers, B, S, single, comp in checks:
        cfg = _cut(arch, layers)
        one = SINGLE[single]
        _hold_sharded(label, reps, one, _n_attn(cfg), comp)
        rows = reps[0]["runs"][label]["steps"]
        plain = SINGLE[single.replace(" compressed", "")].get(
            "plain_flash_loss")
        if plain is not None:
            rel = abs(rows[0]["loss"] - plain) / abs(plain)
            if rel > LOSS_RTOL:
                raise AssertionError(f"{label}: step-0 loss {rows[0]['loss']}"
                                     f" vs plain flash {plain}")
        per_rank = [r["runs"][label] for r in reps]
        counts[label] = {k: sum(p["launches"][k] for p in per_rank)
                         for k in per_rank[0]["launches"]}
        report[label] = {
            "loss": [r["loss"] for r in rows],
            "single_loss": [r["loss"] for r in one["steps"][:len(rows)]],
            "grad_norm": [r["grad_norm"] for r in rows],
            "single_grad_norm": [r["grad_norm"]
                                 for r in one["steps"][:len(rows)]],
            "step_ms": [[r["step_ms"] for r in p["steps"]]
                        for p in per_rank],
            "single_step_ms": [r["step_ms"]
                               for r in one["steps"][:len(rows)]],
            "peak_bytes": [p["peak_bytes"] for p in per_rank],
            "init_peak_bytes": [p["init_peak_bytes"] for p in per_rank],
            "state_bytes": [p["state_bytes"] for p in per_rank],
            "collectives": per_rank[0]["collectives"],
            "launches_per_rank": [p["launches"] for p in per_rank]}
        got = {k: v["bytes"] for k, v in per_rank[0]["collectives"].items()}
        log(f"[{label}] losses {report[label]['loss']} (single "
            f"{report[label]['single_loss']}), grad norms "
            f"{report[label]['grad_norm']} (single "
            f"{report[label]['single_grad_norm']}); step ms by rank "
            f"{report[label]['step_ms']} (single "
            f"{report[label]['single_step_ms']}); peak by rank "
            f"{report[label]['peak_bytes']} B (init "
            f"{report[label]['init_peak_bytes']} B), state "
            f"{report[label]['state_bytes']} B; bytes sent a rank {got}; "
            f"host s in collectives "
            f"{ {k: round(v['host_s'], 3) for k, v in per_rank[0]['collectives'].items()} }; "
            f"{card}")
    # one rank over NCCL: its own card
    t1 = time.perf_counter()
    arch, layers, B, S, _, _, single, sched = SHARDED_RUNS[0]
    label = f"train nccl {arch}"
    nccl = _spawn_ranks(1, (1, 1), ("data", "model"), (
        (label, arch, layers, B, S, 2, False, sched),), "nccl")
    if nccl[0]["backend"] != "nccl" or nccl[0]["staged"]:
        raise AssertionError(f"(1, 1): backend {nccl[0]['backend']}")
    _hold_sharded(label, nccl, SINGLE[single], _n_attn(_cut(arch, layers)),
                  False)
    run = nccl[0]["runs"][label]
    counts[label] = run["launches"]
    report[label] = run
    log(f"[{label}] backend nccl, losses "
        f"{[r['loss'] for r in run['steps']]} (single "
        f"{[r['loss'] for r in SINGLE[single]['steps'][:2]]}), step ms "
        f"{[r['step_ms'] for r in run['steps']]} (single "
        f"{[r['step_ms'] for r in SINGLE[single]['steps'][:2]]}), peak "
        f"{run['peak_bytes']} B, collectives {run['collectives']} in "
        f"{time.perf_counter() - t1:.1f} s; {card}")
    log("[train sharded] " + json.dumps(report))
    return counts


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, list):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


# each kernel's CUDA source and the Pallas kernel it replaces
KERNEL_SOURCES = {
    "paged_decode": ("paged_decode.cu", "quant_attention.py:396"),
    "paged_prefill": ("paged_prefill.cu", "quant_prefill.py:63"),
    "flat_decode": ("flat_decode.cu", "quant_attention.py:112"),
    "seed_decode": ("seed_decode.cu", "quant_attention.py:271"),
    "flash_fwd": ("flash_fwd.cu", "flash_fwd.py:37"),
    "absmax": ("quantize.cu", "quantize.py:35"),
    "quantize_with_scales": ("quantize.cu", "quantize.py:49"),
    "quantize_blocked": ("quantize.cu", "quantize.py:59"),
    "dequantize": ("quantize.cu", "quantize.py:67")}


def kernels_line(decode, prefill, flat, quant, paper, grad, flash, seed,
                 mma, path_counts, extras):
    """One entry per hand-written kernel: the keys of every entry of the
    kernels line, its launches summed over the main paths that ran it;
    then a row per kernel at another model's shapes, from each (rows,
    prefix) of ``extras`` (`check_d256`: recurrentgemma_9b's head width
    256; `check_g6_d64`: qwen2_vl_2b's GQA group 6 and whisper_small's
    head width 64), its launches those of the paths whose names start
    with ``prefix`` (that model served at full width)."""
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
    flash_tol = (f"out |a-b| <= {ATOL_BF16:g} + {RTOL_BF16:g}|b| (bf16), "
                 f"else and m, l: {ATOL:g} + {RTOL:g}|b|")
    for rows, prefix in extras:
        for name, r in rows.items():
            kernel = name.rsplit("_", 1)[0]
            src, replaces = KERNEL_SOURCES[kernel]
            by = {p: c[kernel] for p, c in path_counts.items()
                  if p.startswith(prefix) and c.get(kernel)}
            out.append({
                "name": name, "route": "cuda", "source": csrc + src,
                "replaces": ref + replaces, "kernel": kernel,
                "dtype": ("bfloat16 (float32 too)" if kernel == "flash_fwd"
                          else "int8"),
                "tol": (flash_tol if kernel == "flash_fwd" else "bitwise"
                        if kernel in QUANT_KERNELS else attn_tol),
                "launches": sum(by.values()), "launches_by_path": by,
                **{k: v for k, v in r.items() if k not in (
                    "bytes", "operations")}})
    for e in out:
        if "launches" not in e:
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
    d256 = check_d256(dev, gen)
    g6d64 = check_g6_d64(dev, gen)
    log(f"[kernels] checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paper = paper_phase(dev, gen)
    grad = grad_phase(dev, gen)
    log(f"[paper] phase in {time.perf_counter() - t0:.1f} s (gradient "
        f"shapes included)")
    t0 = time.perf_counter()
    parity_smoke(dev)
    parity_sampling(dev)
    parity_overload(dev)
    parity_tiering(dev)
    parity_mixed(dev)
    parity_archs(dev)
    parity_recurrent(dev)
    parity_whisper(dev)
    log(f"[parity] in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = get_config("internlm2_1_8b")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B params bf16 on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    paged_counts, greedy_tokens, layer0 = serve_full_width(dev, params, cfg,
                                                           paged=True)
    path_counts = {
        "serve paged": paged_counts,
        "serve contiguous": serve_full_width(dev, params, cfg,
                                             paged=False)[0],
        "serve paged sampled": sampled_serve_full_width(
            dev, params, cfg, greedy_tokens, card),
        **graphs_serve_full_width(dev, params, cfg, card, greedy_tokens),
        "serve paged prefix": prefix_serve_full_width(dev, params, cfg,
                                                      card),
        **overload_serve_full_width(dev, params, cfg, card),
        **tiered_serve_full_width(dev, params, cfg, card),
        **mixed_serve_full_width(dev, params, cfg, card, greedy_tokens,
                                 layer0),
        "greedy_generate per_block": generate_full_width(dev, params, cfg,
                                                         "per_block"),
        "greedy_generate per_channel": generate_full_width(dev, params, cfg,
                                                           "per_channel"),
        "paper": paper["launches"],
        "seed baseline": seed_path(dev, gen)}
    log(f"[serve] phase in {time.perf_counter() - t0:.1f} s")
    del params                     # the serving weights make way for the
    gc.collect()                   # other models, one at a time
    torch.cuda.empty_cache()
    for arch in SERVED:
        t0 = time.perf_counter()
        path_counts.update(arch_full_width(dev, arch, card))
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{arch}] phase in {time.perf_counter() - t0:.1f} s, "
            f"memory_allocated after {torch.cuda.memory_allocated(dev)}")
    t_rec = time.perf_counter()
    recurrent = {}
    for arch in RECURRENT:
        t0 = time.perf_counter()
        counts, recurrent[arch] = recurrent_serve_full_width(dev, arch, card)
        path_counts.update(counts)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{arch}] phase in {time.perf_counter() - t0:.1f} s, "
            f"memory_allocated after {torch.cuda.memory_allocated(dev)}")
    log(f"[recurrent] the three models in {time.perf_counter() - t_rec:.1f} "
        f"s")
    t0 = time.perf_counter()
    path_counts.update(whisper_full_width(dev, card))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{WHISPER}] phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path_counts.update(train_full_width(dev))
    log(f"[train] phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path_counts.update(train_families_full_width(dev, card))
    log(f"[train families] phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    path_counts.update(sharded_full_width(dev, card))
    log(f"[train sharded] phase in {time.perf_counter() - t0:.1f} s")

    prefill["sass_mma"] = pmma
    kernels = kernels_line(
        decode, prefill, flat, quant, paper, grad, flash, seed, mma,
        path_counts, [
            (d256, "serve recurrentgemma_9b contiguous"),
            ({k: r for k, r in g6d64.items() if k.endswith("_g6")},
             "serve qwen2_vl_2b"),
            ({k: r for k, r in g6d64.items() if k.endswith("_d64")},
             f"serve {WHISPER}")])
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
