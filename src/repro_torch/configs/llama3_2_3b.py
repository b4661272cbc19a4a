"""Llama-3.2-3B — dense GQA [hf:meta-llama/Llama-3.2-3B].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, rope 500k.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3_2_3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=128,
        rope_theta=500000.0,
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="hf:meta-llama/Llama-3.2-3B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3_2_3b_smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        rope_theta=500000.0,
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
