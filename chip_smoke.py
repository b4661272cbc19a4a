#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each fatal on failure (no fallback anywhere):
  1. card and build: the card's name and power limit, torch/CUDA versions;
     both CUDA kernels built from csrc/ for sm_90a (ptxas register/spill
     summary printed; full logs in build/kernels/*.log); TF32 off.
  2. each kernel against its plain PyTorch version on the card, at the
     main path's full shapes (internlm2_1_8b: H 16, H_kv 8, D 128, page
     256), for int8, fp8_e4m3 and int4 pages; times from CUDA events.
  3. CPU <-> card parity: the smoke config in float32 through LLMEngine on
     the card (kernels) and on the CPU (plain versions): identical greedy
     tokens.
  4. the slice at full width: internlm2_1_8b with random bf16 weights from
     a seeded torch.Generator serves 5 greedy requests through LLMEngine
     (batch 4, max_len 2048, int8 pages); both kernels' launch counters
     are set to 0 just before and must be > 0 just after.
  5. a {"kernels": [...]} line, then the card line, then as the last line
     {"ok": true, "device": {...}}.
Exits non-zero without a CUDA device or without the repository's src/.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 peak outside the tensor cores
DTYPES = ("int8", "fp8_e4m3", "int4")
# kernel vs plain version, both float32 on the card; sums run in another
# order (tile-wise online softmax vs one softmax), so elementwise
# |a - b| <= ATOL + RTOL * |b|
ATOL, RTOL = 1e-5, 1e-4


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


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def excess(got, want) -> float:
    """max |got - want| / (ATOL + RTOL |want|): <= 1 passes."""
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


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
        ms = time_ms(lambda: QA.paged_decode_partials_cuda(*targs), 50)
        plain_ms = time_ms(lambda: QA.paged_decode_partials_plain(*targs), 5)
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
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qb, k, v, attn_mask=mask, enable_gqa=True), 50)
        row = {"dtype": kv_dtype, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
               >= flops / F32_FLOP_PER_S else "operations",
               "library_ms": lib_ms}
        out["per_dtype"].append(row)
        log(f"[decode] {kv_dtype}: max_abs_err {err:.3e} (tol {ATOL:g} + "
            f"{RTOL:g}|ref|, {ex:.3f}x) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms sdpa(bf16) {lib_ms:.4f} ms bound "
            f"{bound:.5f} ms ({row['bound_by']}: {nbytes / 1e6:.2f} MB at "
            f"3.35 TB/s, {flops / 1e9:.3f} GFLOP at 67 TFLOP/s f32)")
    out["check_shapes"] = (f"q ({B},{H},{D}) f32; pool ({B * NT + 1},ps_packed,"
                           f"{Hkv},{D}); page_table ({B},{NT}); lengths "
                           f"{lengths.tolist()}")
    out["timed_shapes"] = (f"q ({tB},{H},{D}); page {ps}; lengths {t_len}")
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
        row = {"dtype": kv_dtype, "max_abs_err": 0.0}
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
            for b in range(B):               # rows past `valid` are garbage
                g, w = got4[b, :, :vd[b]], want4[b, :, :vd[b]]
                err = float((g - w).abs().max())
                ex = excess(g, w)
                if ex > 1.0 or not bool(torch.isfinite(g).all()):
                    raise AssertionError(
                        f"paged prefill {kv_dtype} C={C} row {b}: kernel vs "
                        f"plain off by {err:.3e} ({ex:.2f}x tolerance)")
                row["max_abs_err"] = max(row["max_abs_err"], err)
            if di:
                continue
            # timing at the full chunk: the main path's dispatch shape
            ms = time_ms(lambda: QP.paged_prefill_cuda(*args), 10)
            plain_ms = time_ms(lambda: QP.paged_prefill_plain(*args), 3, 1)
            flops = nbytes = 0.0
            pages = 0
            for b in range(B):
                n = vd[b]                    # rows that matter: qpos < valid
                keys = n * hl[b] + n * (n + 1) // 2
                flops += 4 * D * H * keys
                pages += -(-hl[b] // ps)
                nbytes += kv_bytes(hl[b], Hkv, D, kv_dtype)
            nbytes += (q.numel() + k.numel() + v.numel()) * 4 \
                + 2 * pages * Hkv * D * 4 + pages * 4 + B * 8 \
                + q.numel() * 4
            bound = max(nbytes / HBM_BYTES_PER_S,
                        flops / F32_FLOP_PER_S) * 1e3
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
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qb, kall, vall, attn_mask=mask, enable_gqa=True), 10)
            row.update({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                        >= flops / F32_FLOP_PER_S else "operations",
                        "library_ms": lib_ms})
            log(f"[prefill] {kv_dtype} C={C}: kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms sdpa(bf16) {lib_ms:.4f} ms bound "
                f"{bound:.5f} ms ({row['bound_by']}: {flops / 1e9:.2f} "
                f"GFLOP at 67 TFLOP/s f32, {nbytes / 1e6:.1f} MB at "
                f"3.35 TB/s)")
        log(f"[prefill] {kv_dtype}: max_abs_err {row['max_abs_err']:.3e} "
            f"over both dispatches (tol {ATOL:g} + {RTOL:g}|ref|)")
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


# -- phase 3: CPU <-> card parity --------------------------------------------

def parity_smoke(dev):
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")

    def to(x, d):
        if isinstance(x, dict):
            return {k: to(v, d) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v, d) for v in x]
        return x.to(d)

    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 70, 5, 40, 21)]
    sps = [SamplingParams.greedy(max_new_tokens=n) for n in (8, 9, 5, 7, 8)]
    streams = {}
    for d in ("cpu", dev):
        eng = LLMEngine(to(params, d), cfg,
                        EngineConfig(batch=2, max_len=128), device=d)
        streams[str(d)] = [o.token_ids for o in eng.generate(prompts, sps)]
    if streams["cpu"] != streams[str(dev)]:
        raise AssertionError(f"smoke f32 greedy tokens differ: cpu "
                             f"{streams['cpu']} vs card {streams[str(dev)]}")
    log(f"[parity] smoke f32: {sum(map(len, streams['cpu']))} greedy tokens "
        f"identical on cpu (plain versions) and card (kernels)")


# -- phase 4: the slice at full width -----------------------------------------

def serve_full_width(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import quant_attention as QA
    from repro_torch.kernels import quant_prefill as QP
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    cfg = get_config("internlm2_1_8b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B params bf16 on the card "
        f"in {time.perf_counter() - t0:.2f} s")
    eng = LLMEngine(params, cfg, EngineConfig(batch=4, max_len=2048),
                    device=dev)
    rng = np.random.RandomState(0)
    lens = (1500, 900, 300, 37, 1100)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lens]
    sp = SamplingParams.greedy(max_new_tokens=48)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    QA.paged_decode_partials_cuda.launches = 0
    QP.paged_prefill_cuda.launches = 0
    t0 = time.perf_counter()
    outs = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_decode": QA.paged_decode_partials_cuda.launches,
                "paged_prefill": QP.paged_prefill_cuda.launches}
    reasons = [o.finish_reason for o in outs]
    if reasons != ["length"] * 5 or any(len(o.token_ids) != 48 for o in outs):
        raise AssertionError(f"full-width requests did not all finish by "
                             f"length: {reasons}")
    if not all(0 <= t < cfg.vocab for o in outs for t in o.token_ids):
        raise AssertionError("a generated token lies outside the vocabulary")
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    rep = eng.pool_report()
    gen_tokens = sum(len(o.token_ids) for o in outs)
    res = {"requests": len(outs), "prompt_lens": list(lens),
           "generated_tokens": gen_tokens, "wall_s": wall,
           "tokens_per_s": gen_tokens / wall, "ttft_s_p50": rep["ttft_s_p50"],
           "ticks": rep["ticks"], "launches": launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)}
    log(f"[serve] 5/5 requests finished by length: {gen_tokens} tokens in "
        f"{wall:.3f} s ({res['tokens_per_s']:.2f} tok/s), TTFT p50 "
        f"{rep['ttft_s_p50'] * 1e3:.1f} ms, {rep['ticks']} ticks, launches "
        f"{launches}, max_memory_allocated "
        f"{res['max_memory_allocated_bytes'] / 2**30:.2f} GiB")
    log("[serve] " + json.dumps(res))
    return launches


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, list):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


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
    from repro_torch.kernels import _build

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

    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    decode = check_decode(dev, gen)
    prefill = check_prefill(dev, gen)
    log(f"[kernels] checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parity_smoke(dev)
    log(f"[parity] in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = serve_full_width(dev)
    log(f"[serve] phase in {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name, res, src, replaces in (
            ("paged_decode", decode, "src/repro_torch/kernels/csrc/"
             "paged_decode.cu", "src/repro/kernels/quant_attention.py:396"),
            ("paged_prefill", prefill, "src/repro_torch/kernels/csrc/"
             "paged_prefill.cu", "src/repro/kernels/quant_prefill.py:63")):
        main_row = res["per_dtype"][0]          # int8: the main path's pages
        err = max(r["max_abs_err"] for r in res["per_dtype"])
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "dtype": main_row["dtype"],
            "launches": launches[name],
            # both key namings in use, same numbers: max_abs_err/max_err,
            # ms/kernel_ms
            "max_abs_err": err, "max_err": err,
            "tol": f"|a-b| <= {ATOL:g} + {RTOL:g}|b| (float32)",
            "ms": main_row["ms"], "kernel_ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "library": "torch.nn.functional.scaled_dot_product_attention "
                       "over pre-dequantized bf16 K/V",
            "shapes": {"checked": res["check_shapes"],
                       "timed": res["timed_shapes"]},
            "per_dtype": res["per_dtype"]})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
