#!/usr/bin/env python3
"""Time the port's full-width end-to-end paths of one checkout on one
NVIDIA GPU, for an A/B of two commits on the same card.

    python3 chip_ab.py [ROOT] [--pair]
                                   # ROOT: a checkout (default: this one)

A/B two commits in one machine session, in turns, e.g. with the parent
unpacked into a git-ignored directory (`git archive <parent> | tar -x -C
build/parent`):

    for r in p c c p p c; do
      python3 chip_ab.py $([ $r = p ] && echo build/parent || echo .)
    done

It builds ROOT's kernels, then runs ROOT's own `chip_smoke.py` path
functions at internlm2_1_8b's full width (random bf16 weights, seed 0):
contiguous and paged serving (5 greedy requests, batch 4, max_len 2048)
and `greedy_generate` per block and per channel (4 x 1000-token prompts,
32 steps); then one more per-channel generate under `torch.profiler`: the
device's busy time (the CUDA kernels' self time, summed) against the wall
time, and the kernels that took most of it; and one `--grad-compression`
train step (batch 4 x 2048) under `torch.profiler`. Both profiles also
give the per-channel pair's kernels (device ms and launches) as the real
paths run them. `--pair` runs only what measures the per-channel pair:
the two profiles, and ROOT's pair wrappers timed alone (bitwise first)
with this checkout's harness (`chip_smoke.time_cold_ms`, L2 flushed) at
the generate prefill's and the timed shape and at each compressed
gradient's (T, D). Prints one line `AB {json}`. Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
import time
from pathlib import Path


def _last_json(fn) -> dict:
    """Run a chip_smoke path function quietly; its last log line ends in
    the path's JSON record."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    line = [ln for ln in buf.getvalue().splitlines() if ln.endswith("}")][-1]
    return json.loads(line[line.index("{"):])


PAIR_KERNELS = ("absmax_kernel", "quantize_scales_kernel")


def _device_kernels(prof) -> list:
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def _pair_ms(kernels) -> dict:
    """{kernel: [device ms, launches]} of the per-channel pair, summed over
    its template instances."""
    out = {k: [0.0, 0] for k in PAIR_KERNELS}
    for e in kernels:
        for k in PAIR_KERNELS:
            if k in e.key:
                out[k][0] += e.self_device_time_total / 1e3
                out[k][1] += e.count
    return out


def _pair_kernels(here, dev) -> list:
    """ROOT's pair wrappers on seeded inputs, each bitwise against ROOT's
    plain version, then timed with ``here`` (this checkout's chip_smoke)."""
    import torch
    from repro_torch.kernels import quantize as QK
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape in [(4, 8, 1000, 128), (4, 8, 2048, 128),
                  *sorted(here.grad_shapes())]:
        x = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        am = QK.absmax_cuda(x)
        q, s = QK.quantize_with_scales_cuda(x, am)
        torch.cuda.synchronize()
        pq, ps = QK.quantize_with_scales_plain(x, am)
        if not (here.same_bits(am, QK.absmax_plain(x))
                and here.same_bits(q, pq) and here.same_bits(s, ps)):
            raise AssertionError(f"pair at {shape}: kernel and plain differ")
        it = 5 if x.numel() >= 1 << 26 else 30
        rows.append({
            "shape": list(shape),
            "absmax_ms": here.time_cold_ms(lambda: QK.absmax_cuda(x), it),
            "quantize_with_scales_ms": here.time_cold_ms(
                lambda: QK.quantize_with_scales_cuda(x, am), it),
            "pair_ms": here.time_cold_ms(
                lambda: QK.quantize_per_channel_cuda(x), it,
                spin=here.PAIR_SPIN)})
        del x, am, q, s, pq, ps
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: FAILED: no CUDA device", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if a != "--pair"]
    pair_only = len(args) < len(sys.argv) - 1
    root = Path(args[0] if args else ".").resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as CS
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.serving import greedy_generate
    from torch.profiler import ProfilerActivity, profile

    _build.build()
    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    out = {"root": str(root), "card": CS.card_line()}
    for name, fn in () if pair_only else (
            ("contiguous", lambda: CS.serve_full_width(dev, params, cfg,
                                                       paged=False)),
            ("paged", lambda: CS.serve_full_width(dev, params, cfg,
                                                  paged=True)),
            ("per_block", lambda: CS.generate_full_width(dev, params, cfg,
                                                         "per_block")),
            ("per_channel", lambda: CS.generate_full_width(dev, params, cfg,
                                                           "per_channel"))):
        out[name] = _last_json(fn)

    gc = dataclasses.replace(cfg, quant=QuantConfig("per_channel"))
    prompts = np.random.RandomState(1).randint(0, gc.vocab, (4, 1000))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        greedy_generate(params, gc, prompts.astype(np.int32), steps=32,
                        device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out["per_channel_profiled"] = {
        "wall_s": wall, "device_kernel_s": busy, "busy_share": busy / wall,
        "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                            e.count] for e in top],
        "pair_ms": _pair_ms(kernels)}
    del params
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        train_cli.main(["--arch", "internlm2_1_8b", "--batch", "4", "--seq",
                        "2048", "--steps", "1", "--grad-compression"])
        torch.cuda.synchronize()
    out["train_compressed_profiled"] = {"pair_ms": _pair_ms(
        _device_kernels(prof))}
    if pair_only:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_here", Path(__file__).with_name("chip_smoke.py"))
        here = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(here)
        out["pair_kernels"] = _pair_kernels(here, dev)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
