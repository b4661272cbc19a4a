"""Mixtral-8x22B — sparse MoE [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, 8 experts top-2,
sliding-window attention (window 4096), served from the ring cache.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=32768, head_dim=128,
        sliding_window=4096,
        block_pattern=("moe",),
        n_experts=8, top_k=2, moe_d_ff=16384,
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="arXiv:2401.04088; hf:mistralai/Mixtral-8x22B-v0.1",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral_8x22b_smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        sliding_window=16,
        block_pattern=("moe",),
        n_experts=4, top_k=2, moe_d_ff=128,
        capacity_factor=8.0,   # dropless in smoke tests (decode==train)
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
