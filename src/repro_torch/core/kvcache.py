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

Under a mesh (sharded serving) a rank holds a `ShardedKVCache`: its rows
and its slots of the cache length, as `launch.specs.cache_shardings`
lays them out.
"""
from __future__ import annotations

import math

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


class ShardedKVCache(QuantizedKVCache):
    """One rank's part of a `QuantizedKVCache` whose rows and cache length
    are sharded over a mesh as `launch.specs.cache_shardings` lays them
    out (rows over "batch", slots over "seq_shard" -> "model"; the
    reference's "flash-decode cross-shard merge"). ``k_q`` / ``v_q``
    (B_l, H_kv, T_l, D) hold the global slots [slot0, slot0 + T_l) of a
    cache of ``total`` slots, a rank's slots over ``axes``; ``k_s`` /
    ``v_s`` hold this rank's scale rows where their spec shards them
    (per block with n_blocks % n == 0: blocks never straddle two ranks)
    and every row where it replicates them (per channel's one row; per
    block where n_blocks % n != 0, so a block may straddle two ranks).
    The residual is replicated over ``axes``, and ``length`` is the
    global token count, one host int.

    Prefill takes the whole prompt's K/V (every rank of ``axes`` has it,
    gathered) and writes this rank's slots: per channel the absmax of its
    slots, a MAX all-reduce over ``axes`` and the second pass on its
    slots (a max is exact: the scales and values equal one process's);
    per block its own blocks, or every block where the scale rows are
    replicated. An append writes a quantized slot on the rank that owns
    it; a flush quantizes the block on its owner (on every rank where the
    scale rows are replicated, each keeping its slots of it).
    `decode_partials` runs the flat decode kernel over this rank's live
    slots and merges every rank's partials in rank order
    (`merge_rank_partials`), so every rank of ``axes`` ends with the same
    bits.

    ``length`` may be set below ``total`` after a prefill: an
    encoder-decoder's cross cache (`models.encdec`) is prefilled per
    channel from the encoder's K/V zero-padded to ``total`` slots, then
    its length set to the true encoder length, so decode reads only the
    live slots. The padding's zeros leave every channel's absmax as it
    is, and a rank whose slots are all padding passes no live slot to
    the kernel: its partials are m = -1e30, l = 0, which the merge
    weighs by zero.

    A ring (``ring=True``, a sliding window) shards its ``total`` slots
    the same way: prefill keeps the prompt's last ``total`` tokens rolled
    to slot ``pos % total`` (the one-process ring) and writes this rank's
    slots of them, an append writes slot ``pos % total`` on its owner, a
    flush block ``blk % n_blocks``, and decode gives the kernel this
    rank's live slots as a length and window of its own
    (`ring_slot_args`)."""

    def __init__(self, k_q, v_q, k_s, v_s, resid_k, resid_v, length: int,
                 block_size: int, per_channel: bool, *, mesh, axes,
                 slot0: int, total: int, ring: bool = False):
        super().__init__(k_q, v_q, k_s, v_s, resid_k, resid_v, length,
                         block_size, per_channel, ring=ring)
        self.mesh, self.axes = mesh, tuple(axes)
        self.slot0, self.total = slot0, total
        T_l = k_q.shape[2]
        self.scales_local = per_channel or k_s.shape[2] * block_size == T_l
        self._rows = None
        if not self.scales_local:
            # the kernel takes T_l / nb slots a scale row: rows of g slots,
            # each the row of the block its first slot lies in
            g = math.gcd(block_size, T_l)
            self._rows = torch.tensor(
                [(slot0 + j * g) // block_size for j in range(T_l // g)],
                dtype=torch.int64, device=k_q.device)

    @staticmethod
    def init(batch: int, kv_heads: int, max_len: int, head_dim: int,
             cfg: Q.QuantConfig, ring: bool = False, *, device, mesh=None,
             axes=(), scale_axes=()) -> "ShardedKVCache":
        """This rank's part of a (``batch`` local rows, ``max_len`` global
        slots; a ring of them with ``ring``) cache: its slots over
        ``axes``, its scale rows over ``scale_axes`` (``()``: every
        row)."""
        from repro_torch.parallel.shard import slot_range
        per_channel = cfg.granularity == "per_channel"
        bs = 1 if per_channel else cfg.block_size
        if not per_channel and max_len % bs:
            raise ValueError(f"max_len={max_len} not a multiple of block "
                             f"{bs}")
        lo, hi = slot_range(axes, max_len, mesh)
        nb = 1 if per_channel else max_len // bs
        s0, s1 = slot_range(scale_axes, nb, mesh)
        z8 = lambda: torch.zeros((batch, kv_heads, hi - lo, head_dim),
                                 dtype=torch.int8, device=device)
        zs = lambda: torch.full((batch, kv_heads, s1 - s0, head_dim), Q._EPS,
                                dtype=torch.float32, device=device)
        zr = lambda: torch.zeros((batch, kv_heads, bs, head_dim),
                                 dtype=torch_dtype(cfg.ref_dtype),
                                 device=device)
        return ShardedKVCache(z8(), z8(), zs(), zs(), zr(), zr(), 0, bs,
                              per_channel, mesh=mesh, axes=axes, slot0=lo,
                              total=max_len, ring=ring)

    @property
    def max_len(self) -> int:
        return self.total

    def _local(self, n: int) -> int:
        """Global slots [0, n) -> how many of this rank's are among them."""
        return min(max(n - self.slot0, 0), self.k_q.shape[2])

    def _overlap(self, a: int, b: int) -> tuple[int, int]:
        """Global slots [a, b) within this rank's, as local offsets."""
        lo, n = self.slot0, self.k_q.shape[2]
        return max(a, lo) - lo, max(min(b, lo + n), max(a, lo)) - lo

    # -- prefill -----------------------------------------------------------
    def prefill(self, k: torch.Tensor, v: torch.Tensor) -> "ShardedKVCache":
        """Write the whole prompt's (B_l, H, S, D) K/V (every rank of
        ``axes`` passes the same): this rank's slots of it (a ring: of its
        last ``total`` tokens, rolled to their slots)."""
        T = S = k.shape[2]
        if self.ring and S > self.total:
            shift = S % self.total
            k = torch.roll(k[:, :, S - self.total:], shift, dims=2)
            v = torch.roll(v[:, :, S - self.total:], shift, dims=2)
            S = self.total
        a, b = self._overlap(0, S)
        lo, bs = self.slot0, self.block_size
        if self.per_channel:
            B, H, _, D = k.shape
            parts = (k[:, :, lo + a:lo + b], v[:, :, lo + a:lo + b])
            if b > a:
                amax = torch.stack([ops.absmax(x) for x in parts])
            else:
                amax = torch.zeros((2, B, H, D), dtype=torch.float32,
                                   device=k.device)
                parts = (torch.zeros((B, H, 1, D), device=k.device),) * 2
            amax = self.mesh.all_reduce(amax, self.axes, op="max")
            for i, (x, dq, ds) in enumerate(zip(parts, (self.k_q, self.v_q),
                                                (self.k_s, self.v_s))):
                x_q, x_s = ops.quantize_with_scales(x, amax[i])
                if b > a:
                    dq[:, :, a:b] = x_q
                ds[:, :, 0] = x_s
        elif self.scales_local:
            if b > a:
                for x, dq, ds in ((k, self.k_q, self.k_s),
                                  (v, self.v_q, self.v_s)):
                    x_q, x_s = ops.quantize_blocked(x[:, :, lo + a:lo + b],
                                                    bs)
                    dq[:, :, a:b] = x_q
                    ds[:, :, a // bs:b // bs] = x_s
        else:                       # replicated scale rows: every block
            for x, dq, ds in ((k, self.k_q, self.k_s),
                              (v, self.v_q, self.v_s)):
                x_q, x_s = ops.quantize_blocked(x, bs)
                dq[:, :, a:b] = x_q[:, :, lo + a:lo + b]
                ds[:, :, :S // bs] = x_s
        self.length = T
        return self

    # -- decode append -----------------------------------------------------
    def _append_per_channel(self, k, v):
        slot = self.length % self.total if self.ring else \
            min(self.length, self.total - 1)
        a, b = self._overlap(slot, slot + 1)
        if b > a:
            self.k_q[:, :, a:b] = Q.quantize(k, self.k_s[:, :, 0])
            self.v_q[:, :, a:b] = Q.quantize(v, self.v_s[:, :, 0])
        self.length += 1
        return self

    def _append_blocked(self, k, v):
        bs = self.block_size
        pos = self.length
        off = pos % bs
        nb = self.total // bs
        blk = (pos // bs) % nb if self.ring else min(pos // bs, nb - 1)
        self.resid_k[:, :, off] = k[:, :, 0].to(self.resid_k.dtype)
        self.resid_v[:, :, off] = v[:, :, 0].to(self.resid_v.dtype)
        if off == bs - 1:                    # block full: flush
            a, b = self._overlap(blk * bs, (blk + 1) * bs)
            if b > a or not self.scales_local:
                row = blk - self.slot0 // bs if self.scales_local else blk
                src = self.slot0 + a - blk * bs
                for r, dq, ds in ((self.resid_k, self.k_q, self.k_s),
                                  (self.resid_v, self.v_q, self.v_s)):
                    f_q, f_s = ops.quantize_blocked(r, bs)
                    dq[:, :, a:b] = f_q[:, :, src:src + b - a]
                    ds[:, :, row:row + 1] = f_s
            self.resid_k.zero_()
            self.resid_v.zero_()
        self.length = pos + 1
        return self

    # -- read --------------------------------------------------------------
    def decode_partials(self, q: torch.Tensor, n: int, window=None):
        """One query a row (B_l, H, D) over the quantized slots [0, n)
        (a ring: the live slots of ``n`` tokens written, masked by
        ``window`` as the one-process kernel masks them): the flat decode
        kernel over this rank's (a rank with none gives m = -1e30), then
        every rank's partials merged in rank order. Returns the merged
        (o, m, l), the same bits on every rank."""
        from repro_torch.kernels.quant_attention import merge_rank_partials
        from repro_torch.parallel.shard import gather_partials
        k_s, v_s = self.k_s, self.v_s
        if self._rows is not None:
            k_s, v_s = k_s[:, :, self._rows], v_s[:, :, self._rows]
        if self.ring:
            n, window = ring_slot_args(n, window, self.total, self.slot0,
                                       self.k_q.shape[2])
        else:
            n, window = self._local(n), None
        o, m, l = ops.quant_attention_decode_partials(
            q, self.k_q, k_s, self.v_q, v_s, n, window=window)
        return merge_rank_partials(*gather_partials(o, m, l, self.axes,
                                                    self.mesh))

    def dequantized(self, dtype: torch.dtype = torch.float32):
        raise ValueError("a sharded cache holds a part of the slots: read "
                         "it through decode_partials")


def ring_slot_args(length: int, window, total: int, lo: int,
                   n: int) -> tuple[int, int]:
    """The flat decode kernel's (length, window) over the slots [lo, lo +
    n) of a ring of ``total`` slots that masks exactly the slots the
    one-process kernel leaves live there at ``length`` tokens written and
    ``window`` (None: every slot). The kernel keeps local slot t where t
    < min(length, n) and (length - 1 - t) mod n < window. The live slots
    of the whole ring are one run of ``c`` slots from slot ``s`` that
    may wrap past the last slot; its part in [lo, lo + n) is a run, or
    two that touch both ends of the rank's slots: one run that wraps in
    the rank's own slots."""
    w = total if window is None else min(int(window), total)
    if length <= total:
        s = max(length - w, 0)
        c = length - s
    else:
        c = w
        s = (length - 1 - c + 1) % total
    hi = lo + n
    # the run [s, s + c) (mod total) cut by [lo, hi), as local offsets
    a1, b1 = max(s, lo) - lo, min(s + c, total, hi) - lo
    a2, b2 = 0, min(s + c - total, hi) - lo
    one = b1 > a1
    two = s + c > total and b2 > a2
    if one and two:                 # [0, b2) and [a1, n): wraps at n
        return n + b2, b2 + n - a1
    if one:
        return b1, b1 - a1
    if two:
        return b2, b2
    return 0, 0


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
