#!/usr/bin/env python3
"""Time the port's full-width end-to-end paths of one checkout on one
NVIDIA GPU, for an A/B of two commits on the same card.

    python3 chip_ab.py [ROOT]      # ROOT: a checkout (default: this one)

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
time, and the kernels that took most of it. Prints one line
`AB {json}`. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import contextlib
import dataclasses
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: FAILED: no CUDA device", file=sys.stderr)
        return 1
    root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as CS
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.kernels import _build
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
    for name, fn in (
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
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out["per_channel_profiled"] = {
        "wall_s": wall, "device_kernel_s": busy, "busy_share": busy / wall,
        "top_kernels_ms": [[e.key[:80], e.self_device_time_total / 1e3,
                            e.count] for e in top]}
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
