"""Serving launcher of the port: the LLMEngine over the quantized KV cache,
with random weights from a seeded `torch.Generator`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1_8b \
        --max-len 2048 --batch 4 --requests 5 --prompt-len 1000 --max-new 48

The contiguous cache by default; ``--paged`` serves from the page pool
(implied by ``--prefill-chunk`` and by a ``--kv-cache-dtype`` other than
int8). Runs on the card by default (``--device cuda``) and fails without
one.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    from repro_torch.core.quantization import KV_DTYPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the architecture's layer count")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache + page-budget admission over "
                         "unpadded prompts (varlen chunked prefill)")
    ap.add_argument("--pages", type=int, default=None,
                    help="pool size in pages (default: dense capacity)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="max decode tokens per dispatch (rounded down to a "
                         "power of two); default: to the next completion")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per prefill dispatch (rounded up to "
                         "a page multiple; default 4 pages; implies --paged)")
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=list(KV_DTYPES),
                    help="page storage format (default int8; another "
                         "implies --paged)")
    ap.add_argument("--stop", action="append", default=None,
                    help="stop string (repeatable); token id T renders as "
                         "'<T>'")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    kv_dtype = args.kv_cache_dtype or "int8"
    if args.prefill_chunk or kv_dtype != "int8":
        args.paged = True

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams,
                                     kv_cache_memory_report)

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = transformer.check_device(args.device)
    rep = kv_cache_memory_report(get_config(args.arch), 128, 32_768)
    print(f"[serve] {args.arch}: full-size cache at decode_32k "
          f"fp32={rep['fp32_bytes'] / 2**30:.0f}GiB "
          f"int8={rep['int8_bytes'] / 2**30:.0f}GiB (4x reduction)")
    gen = torch.Generator(device=device).manual_seed(0)
    params = transformer.init_params(cfg, gen, device=device)
    eng = LLMEngine(params, cfg, EngineConfig(
        batch=args.batch, max_len=args.max_len, paged=args.paged,
        n_pages=args.pages, chunk=args.chunk,
        prefill_chunk=args.prefill_chunk, kv_cache_dtype=kv_dtype),
        device=device)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, (args.prompt_len,)).astype(np.int32)
               for _ in range(args.requests)]
    sp = SamplingParams.greedy(stop=tuple(args.stop or ()),
                               max_new_tokens=args.max_new)
    t0 = time.perf_counter()
    outs = eng.generate(prompts, sp)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(o.token_ids) for o in outs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] completed {len(outs)}/{args.requests} requests (greedy), "
          f"{total} tokens in {dt:.3f}s on {where} "
          f"({total / dt:.1f} tok/s over {eng.ticks} ticks)")
    rep = eng.pool_report()
    print(f"[serve] TTFT p50/p90/p99 = {rep['ttft_s_p50'] * 1e3:.1f}/"
          f"{rep['ttft_s_p90'] * 1e3:.1f}/{rep['ttft_s_p99'] * 1e3:.1f} ms")
    if args.paged:
        print(f"[serve] page pool: {rep['pages_total']} pages "
              f"({rep['kv_cache_dtype']}), {rep['pages_free']} free after "
              f"drain")
    else:
        print(f"[serve] contiguous int8 cache ({cfg.quant.granularity})")
    for o in outs[:3]:
        print(f"  req {o.uid}: {o.token_ids} (finish={o.finish_reason})")
    return 0 if len(outs) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
