"""Quickstart of the PyTorch port: the paper's technique in a page.

Per-channel INT8 KV-cache quantization (quantize -> 4x smaller cache ->
dequantize inside attention) and the error metrics the paper reports,
through the port's kernel entry points (`repro_torch.kernels.ops`): on
the card they launch the hand-written CUDA kernels, with ``--device cpu``
their plain PyTorch versions.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.kvcache import QuantizedKVCache
    from repro_torch.core.quantization import (QuantConfig,
                                               attention_score_error,
                                               l2_error, max_abs_error)
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import check_device

    dev = check_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 2 - 1

    T, D = 4096, 128
    # --- 1. the paper's Eq. 5-8 on a raw key matrix -------------------------
    K = uniform(T, D)
    K_q, scales = ops.quantize_per_channel(K)   # int8 + one scale a channel
    K_hat = ops.dequantize(K_q, scales)
    mib = lambda t: t.numel() * t.element_size() / 2**20
    print(f"memory:      {mib(K):.1f} MiB fp32 -> "
          f"{mib(K_q) + mib(scales):.1f} MiB int8 (4x)")
    print(f"max |err|:   {float(max_abs_error(K, K_hat)):.6f}   "
          f"(paper bound 1/(2*127) = {1 / 254:.6f})")
    print(f"L2 err:      {float(l2_error(K, K_hat)):.3f}")
    q = uniform(16, D)
    print(f"attn err:    {float(attention_score_error(q, K, K_hat)):.6f} "
          f"(logit-scaled)")

    # --- 2. the serving cache: prefill, a streamed token, fused attention ---
    B, Hkv, H, ML = 2, 2, 4, 4096
    cache = QuantizedKVCache.init(
        B, Hkv, max_len=ML, head_dim=D,
        cfg=QuantConfig(granularity="per_block", block_size=256), device=dev)
    k = torch.randn((B, Hkv, 2048, D), generator=gen, device=dev)
    cache.prefill(k, k)                              # prompt quantized once
    new = torch.randn((B, Hkv, 1, D), generator=gen, device=dev)
    cache.append(new, new)                           # a streamed token
    # one-token attention straight on the int8 cache (flat decode kernel)
    qv = torch.randn((B, H, D), generator=gen, device=dev)
    out = ops.quant_attention_decode(qv, cache.k_q, cache.k_s, cache.v_q,
                                     cache.v_s, cache.length)
    print(f"fused decode attention out: {tuple(out.shape)} on {dev.type}, "
          f"cache bytes {cache.memory_bytes / 2**20:.2f} MiB "
          f"(bf16 would be {2 * B * Hkv * ML * D * 2 / 2**20:.2f} MiB, "
          f"fp32 {2 * B * Hkv * ML * D * 4 / 2**20:.2f} MiB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
