"""Model/architecture configuration (port of ``repro.configs.base``).

Same dataclass and field names as the reference, so a test can compare a
config field by field; dtypes are plain strings (``"bfloat16"``) and
resolve to torch dtypes through `torch_dtype`. The derived counts
(`ModelConfig.param_count`, `kv_cache_bytes`) and the shape cells
(`SHAPES`: the dry run's, `launch.dryrun`) are the reference's.
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

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch run 500K-token decode? (sliding window, recurrent,
        or attention-free)."""
        if all(k in ("rglru", "slstm", "mlstm") for k in self.block_pattern):
            return True
        if any(k in ("rglru", "slstm", "mlstm") for k in self.block_pattern):
            return True   # hybrid: attention layers are local/windowed
        return self.sliding_window is not None

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch decodes (whisper via its decoder)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's arithmetic."""
        d, dff, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        total = V * d                                  # embedding
        if not self.tie_embeddings:
            total += V * d                             # lm head
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            total += d                                 # pre-norm scale
            if kind in ("attn", "local_attn"):
                total += d * (n_q + 2 * n_kv) + n_q * d
                if self.qkv_bias:
                    total += n_q + 2 * n_kv
            elif kind == "rglru":
                w = self.rnn_width
                total += 2 * d * w + w * d             # in/gate/out projections
                total += 3 * w + w * self.conv1d_width  # recurrence + conv
            elif kind in ("slstm", "mlstm"):
                total += 4 * d * d + d * d             # gates + out
            if kind == "moe" or (self.n_experts and kind == "attn"):
                eff = self.moe_d_ff or dff
                total += d * self.n_experts            # router
                total += self.n_experts * 3 * d * eff  # routed experts
                total += self.n_shared_experts * 3 * d * eff
                total += d                             # post norm
            elif kind in ("attn", "local_attn", "rglru"):
                total += 3 * d * dff + d               # swiglu + post norm
        for _ in range(self.n_encoder_layers):         # encoder (whisper)
            total += 2 * d + d * 3 * d + d * d + 2 * d * dff + dff * d
        return total

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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: (shape name, seq_len, global_batch, kind)."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
