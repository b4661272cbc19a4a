"""CodeQwen1.5-7B — dense MHA (kv=32: no GQA saving — the arch where the
paper's 4× cache compression is most valuable) [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416, QKV bias.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1_5_7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab=92416, head_dim=128,
        qkv_bias=True, rope_theta=1e6,
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="hf:Qwen/CodeQwen1.5-7B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1_5_7b_smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16,
        qkv_bias=True,
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
