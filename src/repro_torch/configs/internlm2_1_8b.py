"""InternLM2-1.8B — dense GQA [arXiv:2403.17297; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2_1_8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92544, head_dim=128,
        rope_theta=1e6,
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="arXiv:2403.17297; hf:internlm/internlm2-1_8b",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2_1_8b_smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
