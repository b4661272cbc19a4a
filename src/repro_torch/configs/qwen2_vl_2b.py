"""Qwen2-VL-2B — vision-language backbone [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, M-RoPE (sections
16/24/24 over head_dim 128), QKV bias. The vision frontend is a stub, as
in the reference: the language model runs in text mode (all three M-RoPE
sections take the same position).
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2_vl_2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, head_dim=128,
        qkv_bias=True, rope_theta=1e6, mrope_sections=(16, 24, 24),
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B-Instruct",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2_vl_2b_smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16,
        qkv_bias=True, mrope_sections=(2, 3, 3),
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
