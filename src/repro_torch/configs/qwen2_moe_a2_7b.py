"""Qwen1.5-MoE-A2.7B — fine-grained MoE [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (kv=16, MHA) moe_d_ff=1408 vocab=151936,
60 routed experts top-4 + 4 shared experts (shared intermediate 5632 =
4×1408), QKV bias.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_moe_a2_7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1408, vocab=151936, head_dim=128,
        qkv_bias=True,
        block_pattern=("moe",),
        n_experts=60, n_shared_experts=4, top_k=4, moe_d_ff=1408,
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2_moe_a2_7b_smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=32, vocab=256, head_dim=16,
        qkv_bias=True,
        block_pattern=("moe",),
        n_experts=8, n_shared_experts=2, top_k=4, moe_d_ff=32,
        capacity_factor=8.0,   # dropless in smoke tests (decode==train)
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
