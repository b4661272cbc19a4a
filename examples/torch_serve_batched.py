"""End-to-end serving with the PyTorch port: a small model serves batched
requests through the LLMEngine over the INT8-quantized KV cache (offline
generate, per-request sampling, online streaming with abort, a per-layer
precision plan) and reports the accuracy impact (greedy outputs with the
INT8 cache against a finer-grained cache with a float32 residual).

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH = "internlm2_1_8b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.quantization import QuantConfig
    from repro_torch.models import transformer as T
    from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams,
                                     greedy_generate)

    dev = T.check_device(args.device)
    cfg = get_config(ARCH, smoke=True)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.RandomState(0)
    n_req = 10
    prompts = [rng.randint(0, cfg.vocab, (8,)).astype(np.int32)
               for _ in range(n_req)]

    # --- offline generate through the paged engine (the production path) ----
    eng = LLMEngine(params, cfg, EngineConfig(batch=4, max_len=64,
                                              paged=True), device=dev)
    outs = eng.generate(prompts, SamplingParams.greedy(max_new_tokens=6))
    print(f"[serve_batched] {len(outs)}/{n_req} requests served greedy "
          f"(paged continuous batching, 4 rows)")

    # --- per-request sampling: sampled rows beside exact-greedy ones --------
    sps = [SamplingParams(temperature=0.8, top_p=0.9, seed=i,
                          max_new_tokens=6) if i % 2 else
           SamplingParams.greedy(max_new_tokens=6)
           for i in range(n_req)]
    eng2 = LLMEngine(params, cfg, EngineConfig(batch=4, max_len=64,
                                               paged=True), device=dev)
    outs2 = eng2.generate(prompts, sps)
    rep = eng2.pool_report()
    print(f"[serve_batched] {len(outs2)}/{n_req} served mixed "
          f"sampled/greedy, TTFT p50 {rep['ttft_s_p50'] * 1e3:.0f}ms")

    # --- online streaming + abort -------------------------------------------
    eng3 = LLMEngine(params, cfg, EngineConfig(batch=2, max_len=64,
                                               paged=True, chunk=1),
                     device=dev)
    eng3.add_request(prompts[0], SamplingParams.greedy(max_new_tokens=6))
    drop = eng3.add_request(prompts[1],
                            SamplingParams.greedy(max_new_tokens=12))
    streamed = 0
    for _ in range(3):
        streamed += sum(len(o.new_token_ids) for o in eng3.step())
    aborted = eng3.abort(drop)
    while eng3.has_unfinished():
        streamed += sum(len(o.new_token_ids) for o in eng3.step())
    print(f"[serve_batched] streamed {streamed} token deltas; aborted "
          f"req {aborted.uid} after {len(aborted.token_ids)} tokens "
          f"(finish={aborted.finish_reason}), pool balanced: "
          f"{eng3.pool_report()['pages_allocated'] == 0}")

    # --- a per-layer precision plan: layer 0 int8, layer 1 int4 -------------
    eng4 = LLMEngine(params, cfg, EngineConfig(
        batch=4, max_len=64, paged=True, kv_cache_dtype=("int8", "int4")),
        device=dev)
    outs4 = eng4.generate(prompts, SamplingParams.greedy(max_new_tokens=6))
    rep4 = eng4.pool_report()
    print(f"[serve_batched] {len(outs4)}/{n_req} served on the plan "
          f"{'/'.join(rep4['kv_cache_layer_dtypes'])}: "
          f"{rep4['kv_page_bytes_saved_vs_int8_frac']:.0%} page bytes "
          f"saved, {rep4['pages_vs_int8_equal_hbm']:.2f}x pages vs int8 at "
          f"equal memory")

    # --- INT8 cache vs a finer one: greedy-output agreement -----------------
    batch = torch.as_tensor(rng.randint(0, cfg.vocab, (4, 12)),
                            dtype=torch.int32, device=dev)
    out_int8 = greedy_generate(params, cfg, batch, steps=8, device=dev)
    cfg_fine = dataclasses.replace(
        cfg, quant=QuantConfig(granularity="per_block", block_size=8,
                               ref_dtype="float32"))
    out_fine = greedy_generate(params, cfg_fine, batch, steps=8, device=dev)
    agree = float((out_int8 == out_fine).float().mean())
    print(f"[serve_batched] greedy-token agreement int8-vs-int8(fp32-resid): "
          f"{agree:.2%}")
    print(f"[serve_batched] sample continuation: {out_int8[0].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
