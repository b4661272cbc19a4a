"""xLSTM-350M — attention-free sLSTM+mLSTM stack [arXiv:2405.04517].

24L d_model=1024 4H d_ff=0 (no FFN; mixers only) vocab=50304.
Pattern 7:1 mLSTM:sLSTM (xLSTM[7:1]); 24 = 3 groups of 8.
No KV cache: the serving state is the mLSTM matrix memory and the sLSTM
cells.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quantization import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm_350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, head_dim=256,
        block_pattern=("mlstm",) * 7 + ("slstm",),
        quant=QuantConfig(granularity="per_block", block_size=256),
        source="arXiv:2405.04517",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm_350m_smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=256, head_dim=16,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        quant=QuantConfig(granularity="per_block", block_size=8),
        source="reduced",
    )
