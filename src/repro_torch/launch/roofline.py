"""Roofline terms of a traced step (port of ``repro.launch.roofline``):

    compute term    = dot FLOPs a device / the card's peak
                      (bf16 at PEAK_FLOPS_BF16, float32 at PEAK_FLOPS_F32)
    memory term     = bytes a device / HBM_BW
    collective term = bytes a device sends / NVLINK_BW

The counts come from `launch.op_cost` (one rank's step run on fake
tensors), not from compiled HLO: the reference's regex over the
partitioned HLO (``collective_bytes``) has no counterpart, as the
collective bytes are the ring counts of `parallel.shard.Mesh.stats`. The
reference divides them by four ICI links of a TPU; the port by one
direction of the card's NVLink (`launch.mesh`: a lower bound where a
mesh crosses nodes). The card's rates are the H100 80GB HBM3 SXM5's
published ones at its 700 W limit.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch import mesh as mesh_mod


@dataclasses.dataclass
class Roofline:
    flops: float                 # dot flops a device (all dtypes)
    hbm_bytes: float             # bytes a device reads and writes
    coll_bytes: float            # bytes a device sends in collectives
    chips: int
    model_flops: float           # 6·N·D useful flops, whole job (0 if n/a)
    coll_detail: dict[str, int] = dataclasses.field(default_factory=dict)
    flops_f32: float = 0.0       # the part of ``flops`` on float32 inputs

    @property
    def compute_s(self) -> float:
        return ((self.flops - self.flops_f32) / mesh_mod.PEAK_FLOPS_BF16
                + self.flops_f32 / mesh_mod.PEAK_FLOPS_F32)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / mesh_mod.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / mesh_mod.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline estimate: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        if not self.model_flops:
            return 0.0
        return self.model_flops / (
            self.step_time_s * self.chips * mesh_mod.PEAK_FLOPS_BF16)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (traced flops summed over chips) — catches remat
        and redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio, "mfu": self.mfu,
            "step_time_s": self.step_time_s,
        }


def analyze(cost, chips: int, model_flops: float = 0.0) -> Roofline:
    """The roofline of one device's cost record (`launch.op_cost.Cost`)."""
    return Roofline(
        flops=cost.flops,
        hbm_bytes=cost.bytes,
        coll_bytes=cost.coll_bytes,
        chips=chips,
        model_flops=model_flops,
        coll_detail={k: int(v) for k, v in cost.coll.items() if v},
        flops_f32=cost.flops_f32,
    )


def train_model_flops(cfg, tokens: int) -> float:
    """6·N·D with N = active params (MoE: routed active + shared)."""
    n = active_param_count(cfg)
    return 6.0 * n * tokens


def active_param_count(cfg) -> float:
    n = cfg.param_count()
    if cfg.n_experts and cfg.top_k:
        eff = cfg.moe_d_ff or cfg.d_ff
        per_expert = 3 * cfg.d_model * eff
        n_moe_layers = sum(1 for i in range(cfg.n_layers)
                           if cfg.block_kind(i) == "moe")
        n -= (cfg.n_experts - cfg.top_k) * per_expert * n_moe_layers
    return n


def prefill_model_flops(cfg, batch: int, seq: int) -> float:
    """Forward-only: 2·N_active per token + causal attention matmuls."""
    n = active_param_count(cfg)
    flops = 2.0 * n * batch * seq
    eff = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.block_kind(i) in ("attn", "local_attn", "moe"))
    # 2 matmuls (qk, pv) x 2 flops, x1/2 causal
    flops += batch * 2.0 * n_attn * cfg.n_heads * cfg.head_dim * seq * eff
    return flops


def decode_model_flops(cfg, batch: int, context: int) -> float:
    """One-token decode: 2·N_active per token + attention cache reads
    (2·2·L_attn·Hkv·dh·T per token ≈ cache dot products)."""
    n = active_param_count(cfg)
    flops = 2.0 * n * batch
    eff = context if cfg.sliding_window is None else min(context,
                                                         cfg.sliding_window)
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.block_kind(i) in ("attn", "local_attn", "moe"))
    flops += batch * 4.0 * n_attn * cfg.n_heads * cfg.head_dim * eff
    return flops
