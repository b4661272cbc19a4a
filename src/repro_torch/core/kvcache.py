"""Contiguous quantized KV cache: INT8 storage with float32 scales (port of
``repro.core.kvcache``).

Layout (per layer):
    k_q, v_q   int8       (B, H_kv, T_max, D)
    k_s, v_s   float32    (B, H_kv, n_blocks, D)  one scale row per block
    resid_k/v  ref_dtype  (B, H_kv, block, D)     unquantized current block
    length     int        tokens written so far, one for every row

Two modes (``QuantConfig.granularity``):
  * per_channel (the paper's): n_blocks == 1; the scales are computed once
    at prefill over the whole prefix (paper Eq. 5) and reused for every
    appended token, which clips to +-127. The residual is unused.
  * per_block: one scale row per ``block_size`` tokens; decode tokens
    gather in the residual and the block is quantized when it fills.

A ring cache (``ring=True``, sliding windows) keeps the last ``T_max``
tokens at slot ``pos % T_max``.

The cache is updated in place (the reference returns new pytrees).
Whole-matrix writes go through the paper's kernels (`kernels.ops`):
per-channel prefill through ``quantize_per_channel``, per-block prefill and
every block flush through ``quantize_blocked``, `dequantized` through
``dequantize``. The length is a host int: it is the same for every row, so
a flush is a Python branch and no decode step waits on the device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core import quantization as Q
from repro_torch.kernels import ops


class QuantizedKVCache:
    def __init__(self, k_q, v_q, k_s, v_s, resid_k, resid_v, length: int,
                 block_size: int, per_channel: bool, ring: bool):
        self.k_q, self.v_q, self.k_s, self.v_s = k_q, v_q, k_s, v_s
        self.resid_k, self.resid_v = resid_k, resid_v
        self.length = length
        self.block_size = block_size
        self.per_channel = per_channel
        self.ring = ring

    @staticmethod
    def init(batch: int, kv_heads: int, max_len: int, head_dim: int,
             cfg: Q.QuantConfig, ring: bool = False, *,
             device) -> "QuantizedKVCache":
        per_channel = cfg.granularity == "per_channel"
        bs = 1 if per_channel else cfg.block_size
        nb = 1 if per_channel else max_len // bs
        if not per_channel and max_len % bs:
            raise ValueError(f"max_len={max_len} not a multiple of block {bs}")
        shp = (batch, kv_heads, max_len, head_dim)
        sshp = (batch, kv_heads, nb, head_dim)
        rshp = (batch, kv_heads, bs, head_dim)
        z8 = lambda: torch.zeros(shp, dtype=torch.int8, device=device)
        zs = lambda: torch.full(sshp, Q._EPS, dtype=torch.float32,
                                device=device)
        zr = lambda: torch.zeros(rshp, dtype=torch_dtype(cfg.ref_dtype),
                                 device=device)
        return QuantizedKVCache(z8(), z8(), zs(), zs(), zr(), zr(), 0, bs,
                                per_channel, ring)

    @property
    def max_len(self) -> int:
        return self.k_q.shape[2]

    @property
    def valid_len(self) -> int:
        """Live cache slots (a ring saturates at max_len)."""
        return min(self.length, self.max_len)

    @property
    def memory_bytes(self) -> int:
        """Storage bytes (paper Table 1 analogue)."""
        return sum(a.numel() * a.element_size() for a in (
            self.k_q, self.v_q, self.k_s, self.v_s, self.resid_k,
            self.resid_v))

    # -- prefill -----------------------------------------------------------
    def prefill(self, k: torch.Tensor, v: torch.Tensor) -> "QuantizedKVCache":
        """Write a (B, H, T, D) prefix, quantized. T must be a block
        multiple in per_block mode. A ring keeps the last max_len tokens,
        rotated to slot pos % max_len so later appends stay aligned."""
        T = k.shape[2]
        ML = self.max_len
        if self.ring and T > ML:
            shift = T % ML
            k = torch.roll(k[:, :, T - ML:], shift, dims=2)
            v = torch.roll(v[:, :, T - ML:], shift, dims=2)
        if self.per_channel:
            k_q, k_s = ops.quantize_per_channel(k)       # over the prefix
            v_q, v_s = ops.quantize_per_channel(v)
            k_s, v_s = k_s[:, :, None], v_s[:, :, None]  # (B, H, 1, D)
        else:
            k_q, k_s = ops.quantize_blocked(k, self.block_size)
            v_q, v_s = ops.quantize_blocked(v, self.block_size)
        n, nb = k_q.shape[2], k_s.shape[2]
        self.k_q[:, :, :n] = k_q
        self.v_q[:, :, :n] = v_q
        self.k_s[:, :, :nb] = k_s
        self.v_s[:, :, :nb] = v_s
        self.length = T
        return self

    # -- decode append -----------------------------------------------------
    def append(self, k: torch.Tensor, v: torch.Tensor) -> "QuantizedKVCache":
        """Append one token (B, H, 1, D) to every row."""
        if self.per_channel:
            return self._append_per_channel(k, v)
        return self._append_blocked(k, v)

    def _append_per_channel(self, k, v):
        # the prefill's scales, reused (paper: scales computed once)
        pos = self.length
        slot = pos % self.max_len if self.ring else min(pos, self.max_len - 1)
        self.k_q[:, :, slot:slot + 1] = Q.quantize(k, self.k_s[:, :, 0])
        self.v_q[:, :, slot:slot + 1] = Q.quantize(v, self.v_s[:, :, 0])
        self.length = pos + 1
        return self

    def _append_blocked(self, k, v):
        bs = self.block_size
        nb = self.k_s.shape[2]
        pos = self.length
        off = pos % bs                       # slot inside the current block
        blk = pos // bs
        blk = blk % nb if self.ring else min(blk, nb - 1)
        self.resid_k[:, :, off] = k[:, :, 0].to(self.resid_k.dtype)
        self.resid_v[:, :, off] = v[:, :, 0].to(self.resid_v.dtype)
        if off == bs - 1:                    # block full: quantize, flush
            fq_k, fs_k = ops.quantize_blocked(self.resid_k, bs)
            fq_v, fs_v = ops.quantize_blocked(self.resid_v, bs)
            self.k_q[:, :, blk * bs:(blk + 1) * bs] = fq_k
            self.v_q[:, :, blk * bs:(blk + 1) * bs] = fq_v
            self.k_s[:, :, blk:blk + 1] = fs_k
            self.v_s[:, :, blk:blk + 1] = fs_v
            self.resid_k.zero_()
            self.resid_v.zero_()
        self.length = pos + 1
        return self

    # -- read --------------------------------------------------------------
    def dequantized(self, dtype: torch.dtype = torch.float32):
        """The whole cache in ``dtype`` (float32 or bfloat16), the residual
        tail overlaid exactly (the attention kernels read int8 directly)."""
        k = ops.dequantize(self.k_q, self.k_s, out_dtype=dtype)
        v = ops.dequantize(self.v_q, self.v_s, out_dtype=dtype)
        if not self.per_channel:
            bs = self.block_size
            nb = self.k_s.shape[2]
            blk = self.length // bs
            blk = blk % nb if self.ring else min(blk, nb - 1)
            n_tail = self.length % bs
            tail = slice(blk * bs, blk * bs + n_tail)
            k[:, :, tail] = self.resid_k[:, :, :n_tail].to(dtype)
            v[:, :, tail] = self.resid_v[:, :, :n_tail].to(dtype)
        return k, v


# -- unquantized baseline (the paper's FP32/BF16 comparison point) -----------

def fp_cache_init(batch, kv_heads, max_len, head_dim, dtype=torch.bfloat16, *,
                  device) -> dict:
    shp = (batch, kv_heads, max_len, head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device), "length": 0}


def fp_cache_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    T = k.shape[2]
    cache["k"][:, :, :T] = k.to(cache["k"].dtype)
    cache["v"][:, :, :T] = v.to(cache["v"].dtype)
    cache["length"] = T
    return cache


def fp_cache_append(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    pos = min(cache["length"], cache["k"].shape[2] - 1)
    cache["k"][:, :, pos:pos + 1] = k.to(cache["k"].dtype)
    cache["v"][:, :, pos:pos + 1] = v.to(cache["v"].dtype)
    cache["length"] += 1
    return cache
