"""RecurrentGemma-9B — Griffin hybrid [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; block pattern
2×RG-LRU : 1 local attention (window 2048). 38 = 12×3 + 2 (tail handled
unstacked).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000, head_dim=256,
        sliding_window=2048,
        block_pattern=("rglru", "rglru", "local_attn"),
        rnn_width=4096, conv1d_width=4,
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="arXiv:2402.19427",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma_9b_smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=256, head_dim=16,
        sliding_window=16,
        block_pattern=("rglru", "rglru", "local_attn"),
        rnn_width=64, conv1d_width=4,
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
