"""Model/architecture configuration (port of ``repro.configs.base``).

Same dataclass and field names as the reference, so a test can compare a
config field by field; dtypes are plain strings (``"bfloat16"``) and
resolve to torch dtypes through `torch_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.quantization import QuantConfig

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]
BlockKind = Literal["attn", "local_attn", "rglru", "slstm", "mlstm", "moe"]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (any ``torch.<name>`` dtype)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention
    head_dim: int | None = None           # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] | None = None
    sliding_window: int | None = None
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False

    # block pattern: cycle applied over n_layers; default all-attention.
    block_pattern: tuple[BlockKind, ...] = ("attn",)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int | None = None
    capacity_factor: float = 1.25

    # recurrent (rglru / xlstm)
    rnn_width: int | None = None
    conv1d_width: int = 4

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # frontend stub (vlm / audio)
    embedding_inputs: bool = False

    # numerics & quantization
    dtype: str = "bfloat16"
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)

    # citation / provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.rnn_width is None:
            object.__setattr__(self, "rnn_width", self.d_model)

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def block_kind(self, layer: int) -> BlockKind:
        return self.block_pattern[layer % len(self.block_pattern)]

    def kv_cache_bytes(self, batch: int, seq: int, dtype_bytes: float) -> int:
        """Paper Table 1: 2 * L_attn * H_kv * d_head * T * bytes * batch."""
        n_attn = sum(1 for i in range(self.n_layers)
                     if self.block_kind(i) in ("attn", "local_attn", "moe"))
        if self.n_experts:
            n_attn = self.n_layers
        eff_seq = seq if self.sliding_window is None else min(
            seq, self.sliding_window)
        return int(2 * n_attn * self.n_kv_heads * self.head_dim * eff_seq
                   * dtype_bytes * batch)
