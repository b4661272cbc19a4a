"""Serving launcher of the port: the LLMEngine over the quantized KV cache,
with random weights from a seeded `torch.Generator`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1_8b \
        --max-len 2048 --batch 4 --requests 5 --prompt-len 1000 --max-new 48

The contiguous cache by default; ``--paged`` serves from the page pool
(implied by ``--prefix-cache``, ``--prefill-chunk``, a
``--kv-cache-dtype`` other than int8 and ``--kv-cache-plan``).
``--kv-cache-plan PLAN_JSON`` stores each layer at the dtype a per-layer
precision plan gives it (``PLAN_kv_mixed.json`` is one, for 4 layers:
``--smoke --layers 4``); it excludes ``--kv-cache-dtype``.
``--temperature`` / ``--top-k`` / ``--top-p`` / ``--seed`` sample every
request (greedy by default);
``--shared-prefix N`` gives every prompt the same first N tokens, which
``--prefix-cache`` then shares; ``--host-pages N`` adds a host swap tier
of N pages (implies ``--prefix-cache``), ``--evictor`` picks the device
eviction policy and ``--host-tier-dtype`` stores demoted pages in a
cheaper dtype. ``--watermark N`` admits optimistically
(implies ``--paged``) and preempts under pool pressure; ``--priority P``
raises every even-numbered request to priority P and ``--aging-ticks``
ages queued requests. Runs on the card by default (``--device
cuda``) and fails without one.
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
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="first N prompt tokens identical across requests "
                         "(a shared system prompt, for --prefix-cache)")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache + page-budget admission over "
                         "unpadded prompts (varlen chunked prefill)")
    ap.add_argument("--pages", type=int, default=None,
                    help="pool size in pages (default: dense capacity)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="max decode tokens per dispatch (rounded down to a "
                         "power of two); default: to the next completion")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="automatic prefix caching: a prompt's full pages "
                         "resolve from a content-hash index instead of being "
                         "computed again (implies --paged)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per prefill dispatch (rounded up to "
                         "a page multiple; default 4 pages; implies --paged)")
    ap.add_argument("--kv-cache-dtype", default=None,
                    choices=list(KV_DTYPES),
                    help="page storage format (default int8; another "
                         "implies --paged). Mutually exclusive with "
                         "--kv-cache-plan")
    ap.add_argument("--kv-cache-plan", default=None, metavar="PLAN_JSON",
                    help="per-layer mixed-precision plan: path to a plan "
                         "JSON (layer -> kv dtype). Implies --paged; "
                         "mutually exclusive with --kv-cache-dtype")
    ap.add_argument("--host-pages", type=int, default=None,
                    help="host-RAM swap tier capacity in pages: cold "
                         "prefix pages are copied to host memory on "
                         "reclaim instead of vanishing and promoted back "
                         "at hash-match time, a copy instead of a "
                         "re-prefill (implies --paged and --prefix-cache)")
    ap.add_argument("--evictor", default="lru", choices=["lru", "freq"],
                    help="device-pool eviction policy: 'lru' reclaims "
                         "oldest first, 'freq' the lowest hits-per-byte "
                         "page first")
    ap.add_argument("--host-tier-dtype", default=None,
                    choices=list(KV_DTYPES),
                    help="store demoted pages recompressed to this dtype "
                         "on the host tier (int4 halves host bytes; lossy; "
                         "default: the device dtype, bitwise restores)")
    ap.add_argument("--watermark", type=int, default=None,
                    help="optimistic admission: reserve the prompt's pages "
                         "plus this many pages of decode headroom instead "
                         "of the worst case; decode grows reservations and "
                         "preempts the lowest-priority row under pool "
                         "pressure (implies --paged)")
    ap.add_argument("--priority", type=int, default=0,
                    help="priority of every even-numbered request (odd "
                         "ones stay at 0): higher is admitted first and "
                         "preempted last")
    ap.add_argument("--aging-ticks", type=int, default=0,
                    help="a queued request gains +1 effective priority per "
                         "this many ticks waited (0 = off)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = exact greedy argmax, "
                         "the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k most likely tokens (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    ap.add_argument("--seed", type=int, default=None,
                    help="per-request PRNG seed base: request i uses seed+i "
                         "(default: derived from each request's uid)")
    ap.add_argument("--stop", action="append", default=None,
                    help="stop string (repeatable); token id T renders as "
                         "'<T>'")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.kv_cache_plan is not None and args.kv_cache_dtype is not None:
        ap.error("--kv-cache-plan and --kv-cache-dtype are mutually "
                 "exclusive: a plan assigns every layer's dtype itself "
                 "(DESIGN.md §10)")
    kv_spec = (args.kv_cache_plan if args.kv_cache_plan is not None
               else args.kv_cache_dtype or "int8")
    if args.host_pages is not None:
        args.prefix_cache = True     # the host tier keys on chain digests
    if (args.prefix_cache or args.prefill_chunk
            or args.watermark is not None or kv_spec != "int8"):
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
        n_pages=args.pages, chunk=args.chunk, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, watermark=args.watermark,
        aging_ticks=args.aging_ticks, kv_cache_dtype=kv_spec,
        host_pages=args.host_pages, evictor=args.evictor,
        host_tier_dtype=args.host_tier_dtype), device=device)
    rng = np.random.RandomState(0)
    shared_n = min(args.shared_prefix, args.prompt_len)
    shared = rng.randint(0, cfg.vocab, (shared_n,)).astype(np.int32)
    prompts = [np.concatenate([
        shared, rng.randint(0, cfg.vocab, (args.prompt_len - shared_n,))
        .astype(np.int32)]) for _ in range(args.requests)]
    sps = [SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=None if args.seed is None else args.seed + i,
        stop=tuple(args.stop or ()), max_new_tokens=args.max_new,
        priority=args.priority if i % 2 == 0 else 0)
        for i in range(args.requests)]
    t0 = time.perf_counter()
    outs = eng.generate(prompts, sps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total = sum(len(o.token_ids) for o in outs)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    mode = ("greedy" if args.temperature == 0 else
            f"T={args.temperature} top_k={args.top_k} top_p={args.top_p}")
    print(f"[serve] completed {len(outs)}/{args.requests} requests ({mode}), "
          f"{total} tokens in {dt:.3f}s on {where} "
          f"({total / dt:.1f} tok/s over {eng.ticks} ticks)")
    rep = eng.pool_report()
    print(f"[serve] TTFT p50/p90/p99 = {rep['ttft_s_p50'] * 1e3:.1f}/"
          f"{rep['ttft_s_p90'] * 1e3:.1f}/{rep['ttft_s_p99'] * 1e3:.1f} ms")
    if args.paged:
        print(f"[serve] page pool: {rep['pages_total']} pages "
              f"({rep['kv_cache_dtype']}, "
              f"{rep['pages_vs_int8_equal_hbm']:.2f}x pages vs int8 at "
              f"equal HBM), {rep['pages_free']} free after drain, "
              f"{rep['pages_cached']} cached")
        if "kv_cache_layer_dtypes" in rep:
            print(f"[serve] precision plan: "
                  f"{'/'.join(rep['kv_cache_layer_dtypes'])} "
                  f"({rep['kv_page_bytes_saved_vs_int8_frac']:.0%} page "
                  f"bytes saved vs uniform int8)")
        if args.watermark is not None:
            resumes = (rep['preempt_fast_resumes']
                       + rep['preempt_recompute_resumes'])
            print(f"[serve] overload: {rep['preemptions']} preemptions "
                  f"({rep['preempt_fast_resumes']} fast / "
                  f"{rep['preempt_recompute_resumes']} recompute of "
                  f"{resumes} resumes), "
                  f"{rep['decode_stall_ticks']} stalled row-ticks")
        if args.prefix_cache:
            print(f"[serve] prefix cache: hit rate "
                  f"{rep['page_hit_rate']:.2f} ({rep['page_hits']} hits / "
                  f"{rep['page_misses']} misses), {rep['reclaims']} "
                  f"reclaims")
        if args.host_pages is not None:
            print(f"[serve] host tier ({args.evictor} evictor, "
                  f"dtype={rep['host_tier_dtype'] or rep['kv_cache_dtype']}"
                  f"): {rep['host_pages_used']}/{rep['host_pages_capacity']} "
                  f"pages ({rep['host_bytes'] / 2**20:.2f} MiB), "
                  f"{rep['demotions']} demotions / "
                  f"{rep['promotions']} promotions, prefetch hit rate "
                  f"{rep['prefetch_hit_rate']:.2f}, "
                  f"{rep['preempt_by_swap']} preempt-by-swap / "
                  f"{rep['preempt_swap_restores']} swap-restores")
    else:
        print(f"[serve] contiguous int8 cache ({cfg.quant.granularity})")
    for o in outs[:3]:
        print(f"  req {o.uid}: {o.token_ids} (finish={o.finish_reason})")
    return 0 if len(outs) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
