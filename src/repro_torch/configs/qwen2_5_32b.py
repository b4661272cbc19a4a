"""Qwen2.5-32B — dense GQA with QKV bias [hf:Qwen/Qwen2.5-32B].

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_5_32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab=152064, head_dim=128,
        qkv_bias=True, rope_theta=1e6,
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="hf:Qwen/Qwen2.5-32B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2_5_32b_smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        qkv_bias=True,
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
