"""Whisper-small — encoder-decoder ASR backbone [arXiv:2212.04356].

12+12L d_model=768 12H (MHA) d_ff=3072 vocab=51865, LayerNorm, tied
embeddings. The conv audio frontend is a stub, as in the reference: the
encoder takes (B, 1500, 768) frame embeddings (`data.make_frames`). The
decoder's self-attention cache and its cross-attention cache are both
quantized.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper_small", family="encdec",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, head_dim=64,
        norm="layernorm", tie_embeddings=True,
        n_encoder_layers=12, encoder_seq=1500,
        embedding_inputs=True,
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper_small_smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, head_dim=16,
        norm="layernorm", tie_embeddings=True,
        n_encoder_layers=2, encoder_seq=24,
        embedding_inputs=True,
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
