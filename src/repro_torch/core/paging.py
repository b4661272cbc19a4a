"""Paged quantized KV cache — page pool + page-table views, and the
host-side free-list allocator (port of ``repro.core.paging``).

``PagePool`` holds the physical pages of one layer:
    k_q, v_q    (n_pages, tokens_packed, H_kv, D)  int8 / float8_e4m3fn
    k_s, v_s    float32 (n_pages, H_kv, D)         one scale row per page

``PagedQuantizedKVCache`` is a batched view into one pool:
    page_table  int32 (B, max_blocks)     physical page per logical block
    resid_k/v   ref_dtype (B, H_kv, page_size, D)  the row's partial page
    length      int32 (B,)                tokens written per row

The layout is the reference's, byte for byte, so the two pools can be
compared directly. Unlike the reference, which is functional and rebuilds
the (donated) pool on every write, the port writes pages IN PLACE
(``index_copy_``); the small per-row tensors (residuals, lengths) are
rebound to new tensors, so a page table or length tensor shared between
layers is never mutated under another layer.

Invariants (as the reference): page_size == quantization block size; page
0 is a sentinel that is never allocated — unmapped table entries point at
it and masked rows scatter into it, so its contents are garbage by design
and always masked out by ``length``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core import quantization as Q

SENTINEL_PAGE = 0


class HostPageAllocator:
    """Host-authoritative page allocator: a free list plus per-page
    refcounts (the free-list part of the reference's allocator; its prefix
    index, LRU, deferred and in-flight populations are ROADMAP queue 1,
    items 8-10). Pages 1..n_pages-1 are allocatable."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the sentinel)")
        self.n_pages = n_pages
        self.free: list[int] = list(range(1, n_pages))
        self.ref: dict[int, int] = {}

    @property
    def n_free(self) -> int:
        """Pages an admission may claim."""
        return len(self.free)

    def alloc(self, n: int) -> list[int]:
        """Claim ``n`` pages (refcount 1 each); raises past capacity."""
        if n > len(self.free):
            raise ValueError(f"alloc({n}) exceeds available={len(self.free)}")
        ids = [self.free.pop() for _ in range(n)]
        for p in ids:
            self.ref[p] = 1
        return ids

    def release(self, pages) -> None:
        """Drop one reference per page; a page reaching 0 returns to the
        free list. A count below 0 is a refcounting bug and raises."""
        for p in pages:
            c = self.ref.get(p, 0) - 1
            if c < 0:
                raise ValueError(f"refcount underflow on page {p}")
            if c:
                self.ref[p] = c
            else:
                del self.ref[p]
                self.free.append(p)


def live_page_count(tables, lengths, page_size: int) -> int:
    """Distinct physical pages holding tokens across rows (sentinel never
    counts)."""
    live: set[int] = set()
    for b in range(len(lengths)):
        nb = -(-int(lengths[b]) // page_size)
        live.update(int(p) for p in tables[b][:nb])
    live.discard(SENTINEL_PAGE)
    return len(live)


def page_bytes_for(page_size: int, kv_heads: int, head_dim: int,
                   kv_dtype: str = "int8") -> int:
    """Storage cost of ONE page of ``kv_dtype``: K+V value slots plus their
    float32 scale rows."""
    ps_eff = Q.packed_tokens(page_size, kv_dtype)
    itemsize = Q.kv_storage_dtype(kv_dtype).itemsize
    return 2 * (ps_eff * kv_heads * head_dim * itemsize
                + kv_heads * head_dim * 4)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """int8 view of a page tensor: fp8 pages are copied as raw bytes, so
    every index op works whatever the storage dtype."""
    return t.view(torch.int8) if t.dtype != torch.int8 else t


class PagePool:
    """Physical page storage of one layer (see module docstring). The
    allocation policy lives in `HostPageAllocator`."""

    def __init__(self, k_q, v_q, k_s, v_s, page_size: int, kv_dtype: str):
        self.k_q, self.v_q, self.k_s, self.v_s = k_q, v_q, k_s, v_s
        self.page_size = page_size
        self.kv_dtype = kv_dtype

    @staticmethod
    def init(n_pages: int, page_size: int, kv_heads: int, head_dim: int,
             kv_dtype: str = "int8", *, device) -> "PagePool":
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the sentinel)")
        if page_size % 8:
            raise ValueError(f"page_size must be a multiple of 8, "
                             f"got {page_size}")
        ps_eff = Q.packed_tokens(page_size, kv_dtype)
        shape = (n_pages, ps_eff, kv_heads, head_dim)
        dt = Q.kv_storage_dtype(kv_dtype)
        zs = torch.full((n_pages, kv_heads, head_dim), Q._EPS,
                        dtype=torch.float32, device=device)
        return PagePool(torch.zeros(shape, dtype=dt, device=device),
                        torch.zeros(shape, dtype=dt, device=device),
                        zs, zs.clone(), page_size, kv_dtype)

    def write(self, ids: torch.Tensor, k_q, k_s, v_q, v_s) -> None:
        """Write whole pages in place: ``ids`` (N,) page ids, values
        (N, tokens_packed, H_kv, D), scales (N, H_kv, D). Ids repeated
        (masked rows all aimed at the sentinel) leave that page garbage."""
        ids = ids.reshape(-1).long()
        _as_bytes(self.k_q).index_copy_(0, ids, _as_bytes(k_q.contiguous()))
        _as_bytes(self.v_q).index_copy_(0, ids, _as_bytes(v_q.contiguous()))
        self.k_s.index_copy_(0, ids, k_s.float().contiguous())
        self.v_s.index_copy_(0, ids, v_s.float().contiguous())


class PagedQuantizedKVCache:
    """Per-row page-table view over a `PagePool` (see module docstring).
    `prefill_at` and `append` write the pool in place and return ``self``."""

    def __init__(self, pool: PagePool, page_table: torch.Tensor,
                 resid_k: torch.Tensor, resid_v: torch.Tensor,
                 length: torch.Tensor):
        self.pool = pool
        self.page_table = page_table
        self.resid_k, self.resid_v = resid_k, resid_v
        self.length = length

    @staticmethod
    def init(batch: int, kv_heads: int, max_len: int, head_dim: int,
             cfg: Q.QuantConfig, *, n_pages: int, kv_dtype: str = "int8",
             device) -> "PagedQuantizedKVCache":
        if cfg.granularity != "per_block":
            raise ValueError("paged cache requires per_block quantization "
                             "(one scale row per page)")
        ps = cfg.block_size
        if max_len % ps:
            raise ValueError(f"max_len={max_len} not a multiple of page {ps}")
        pool = PagePool.init(n_pages, ps, kv_heads, head_dim, kv_dtype,
                             device=device)
        table = torch.zeros((batch, max_len // ps), dtype=torch.int32,
                            device=device)
        resid = torch.zeros((batch, kv_heads, ps, head_dim),
                            dtype=torch_dtype(cfg.ref_dtype), device=device)
        return PagedQuantizedKVCache(
            pool, table, resid, resid.clone(),
            torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def page_size(self) -> int:
        return self.pool.page_size

    @property
    def kv_dtype(self) -> str:
        return self.pool.kv_dtype

    @property
    def max_blocks(self) -> int:
        return self.page_table.shape[-1]

    def _scatter_chunk(self, k: torch.Tensor, v: torch.Tensor,
                       ids: torch.Tensor) -> None:
        """Quantize a (B, H, T, D) page-aligned chunk and write it into
        physical pages ``ids`` (B, T // ps)."""
        B, H, T, D = k.shape
        ps = self.page_size
        nb = T // ps
        ps_eff = Q.packed_tokens(ps, self.kv_dtype)
        k_q, k_s = Q.quantize_pages(k, ps, self.kv_dtype)
        v_q, v_s = Q.quantize_pages(v, ps, self.kv_dtype)

        def to_pages(x_q):       # (B, H, nb*ps_eff, D) -> (B*nb, ps_eff, H, D)
            return x_q.reshape(B, H, nb, ps_eff, D).permute(
                0, 2, 3, 1, 4).reshape(B * nb, ps_eff, H, D)

        def scales_to_pages(s):  # (B, H, nb, D) -> (B*nb, H, D)
            return s.permute(0, 2, 1, 3).reshape(B * nb, H, D)

        self.pool.write(ids, to_pages(k_q), scales_to_pages(k_s),
                        to_pages(v_q), scales_to_pages(v_s))

    def prefill_at(self, k: torch.Tensor, v: torch.Tensor,
                   start_block: torch.Tensor, row_mask=None, valid=None
                   ) -> "PagedQuantizedKVCache":
        """Chunk write for varlen chunked prefill: quantize the full pages
        of a (B, H, T, D) chunk (T a page multiple) into logical blocks
        starting at each row's ``start_block``; the partial tail
        ``valid % ps`` lands in the row's fp residual at offsets
        ``[0, valid % ps)``. Masked-off rows and pages past ``valid`` are
        aimed at the sentinel and keep their state."""
        B, H, T, D = k.shape
        ps = self.page_size
        if T % ps:
            raise ValueError(f"T={T} not a multiple of page_size={ps}")
        nb = T // ps
        dev = k.device
        ar_nb = torch.arange(nb, dtype=torch.int32, device=dev)
        ar_ps = torch.arange(ps, dtype=torch.int32, device=dev)
        start_block = start_block.to(torch.int32)
        blk = torch.clamp(start_block[:, None] + ar_nb[None],
                          max=self.max_blocks - 1)
        ids = torch.gather(self.page_table, 1, blk.long())
        valid_t = (torch.full((B,), T, dtype=torch.int32, device=dev)
                   if valid is None else valid.to(torch.int32))
        full = torch.div(valid_t, ps, rounding_mode="floor")
        sentinel = torch.zeros_like(ids)
        ids = torch.where(ar_nb[None] < full[:, None], ids, sentinel)
        if row_mask is not None:
            ids = torch.where(row_mask[:, None], ids, sentinel)
        self._scatter_chunk(k, v, ids)
        # partial tail -> fp residual (page positions [0, valid % ps))
        src = torch.clamp(full[:, None] * ps + ar_ps[None], max=T - 1)
        in_tail = ar_ps[None] < (valid_t - full * ps)[:, None]     # (B, ps)
        idx = src[:, None, :, None].expand(B, H, ps, D).long()
        keep = in_tail[:, None, :, None]

        def gat(x):
            g = torch.gather(x.to(self.resid_k.dtype), 2, idx)
            return torch.where(keep, g, torch.zeros_like(g))

        rk, rv = gat(k), gat(v)
        new_len = start_block * ps + valid_t
        if row_mask is None:
            self.length, self.resid_k, self.resid_v = new_len, rk, rv
        else:
            rm = row_mask[:, None, None, None]
            self.length = torch.where(row_mask, new_len, self.length)
            self.resid_k = torch.where(rm, rk, self.resid_k)
            self.resid_v = torch.where(rm, rv, self.resid_v)
        return self

    def append(self, k: torch.Tensor, v: torch.Tensor, row_mask=None
               ) -> "PagedQuantizedKVCache":
        """Append one token (B, H, 1, D) per row at its own offset. Tokens
        gather in the row's residual; a row whose page fills flushes it
        (quantized from the ref-dtype residual) to its mapped page.
        ``row_mask`` (B,) bool freezes unmasked rows entirely."""
        B, H, _, D = k.shape
        ps = self.page_size
        dev = k.device
        off = self.length % ps
        blk = torch.clamp(torch.div(self.length, ps, rounding_mode="floor"),
                          max=self.max_blocks - 1)
        write = (torch.arange(ps, device=dev)[None, None, :, None]
                 == off[:, None, None, None])
        if row_mask is not None:
            write = write & row_mask[:, None, None, None]
        resid_k = torch.where(write, k.to(self.resid_k.dtype), self.resid_k)
        resid_v = torch.where(write, v.to(self.resid_v.dtype), self.resid_v)
        full = off == ps - 1
        if row_mask is not None:
            full = full & row_mask
        fq_k, fs_k = Q.quantize_page_matrix(resid_k, self.kv_dtype)
        fq_v, fs_v = Q.quantize_page_matrix(resid_v, self.kv_dtype)
        pid = self.page_table[torch.arange(B, device=dev), blk.long()]
        pid = torch.where(full, pid, torch.zeros_like(pid))
        self.pool.write(pid, fq_k.transpose(1, 2), fs_k,
                        fq_v.transpose(1, 2), fs_v)
        clear = full[:, None, None, None]
        self.resid_k = torch.where(clear, torch.zeros_like(resid_k), resid_k)
        self.resid_v = torch.where(clear, torch.zeros_like(resid_v), resid_v)
        advance = 1 if row_mask is None else row_mask.to(torch.int32)
        self.length = self.length + advance
        return self
