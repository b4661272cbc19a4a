"""Paged quantized KV cache — page pool + page-table views, the
host-side allocator with the prefix cache's content-hash index and the
host tier's in-flight population, and the seeded pool fault injector
(port of ``repro.core.paging``).

``PagePool`` holds the physical pages of one layer:
    k_q, v_q    (n_pages, tokens_packed, H_kv, D)  int8 / float8_e4m3fn
    k_s, v_s    float32 (n_pages, H_kv, D)         one scale row per page

``PagedQuantizedKVCache`` is a batched view into one pool:
    page_table  int32 (B, max_blocks)     physical page per logical block
    resid_k/v   ref_dtype (B, H_kv, page_size, D)  the row's partial page
    length      int32 (B,)                tokens written per row

The layout is the reference's, byte for byte, so the two pools can be
compared directly. Unlike the reference, which is functional and rebuilds
the (donated) pool on every write, the port writes every tensor of the
state IN PLACE: pages through ``index_copy_``, residuals, lengths and
page-table rows through ``copy_`` / ``add_``. A tensor keeps its address
for the life of the cache, so a captured CUDA graph can replay a step
over it (`serving.dispatch`). A length tensor is written by its own
layer's steps and must not be shared between layers; a page table is
only read by steps (and written by `fork_row` alike in every layer), so
layers may share one.

Invariants (as the reference): page_size == quantization block size; page
0 is a sentinel that is never allocated — unmapped table entries point at
it and masked rows scatter into it, so its contents are garbage by design
and always masked out by ``length``. A page is written only by the flush
or prefill scatter that fills it, so sharing one (prefix hits, `fork_row`)
needs no device copy: copy-on-write retargets a table entry on the host
before the flush, and the fp residual holds the page's whole content.

Under a mesh (sharded serving) a rank's pool holds its kv heads where
`parallel.shard.page_pool_specs` shards them (``kv_axes`` names the
axes) and every page, its views its rows; the allocator runs alike on
every rank, and a rank writes the pages of its own rows only.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.core import quantization as Q
from repro_torch.core import tiering as TIER

SENTINEL_PAGE = 0


_CHAIN_SEED = b"repro-paged-int8-v1"


def chain_hashes(tokens, page_size: int, parent: bytes | None = None):
    """Hash chain over a page-aligned token stream: digest i is
    ``blake2b(digest_{i-1} || tokens of page i)`` (16 bytes), so equal
    digests mean equal full prefixes. ``parent`` continues a chain (a
    previous digest); the seed is the reference's, so both packages index
    a page under the same bytes. Callers hash only a prompt's full pages,
    unpadded: the partial last page lives in the fp residual."""
    toks = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    if toks.ndim != 1 or toks.size % page_size:
        raise ValueError(f"token stream of shape {toks.shape} is not a "
                         f"multiple of page_size={page_size}")
    h = parent if parent is not None else _CHAIN_SEED
    out = []
    for i in range(toks.size // page_size):
        blk = toks[i * page_size:(i + 1) * page_size].tobytes()
        h = hashlib.blake2b(h + blk, digest_size=16).digest()
        out.append(h)
    return out


class PoolFaultInjector:
    """Seeded fault injector for `HostPageAllocator` (the reference's,
    draw for draw): it drives the scheduler's overload recovery from tests
    and benchmarks instead of waiting for real pressure. Deterministic
    given the seed and the tick sequence:

      * ``p_alloc_fail`` — per-tick probability that every admission and
        growth gate reports zero available pages for that tick (drawn once
        per `HostPageAllocator.tick`, never per query, so the gates of one
        tick agree);
      * ``hold_pages`` — this many pages withheld from the gates
        (`available`, `available_after_adopt`); mutable at any time, so a
        test can squeeze the pool mid-run and let it go later;
      * ``reclaim_delay`` — a page whose refcount reaches 0 parks this many
        ticks (``deferred``) before it reaches the LRU or the free list.

    And the host tier's two:

      * ``p_swap_fail`` — per-prefetch probability (one seeded draw per
        `swap_fault` call, from the same stream) that the host record is
        lost at promotion: the tier drops it, the digest stops matching,
        and the requester recomputes instead of stalling;
      * ``swap_delay`` — every prefetch lands this many ticks late (the
        page rides the allocator's in-flight population until
        `HostPageAllocator.tick` publishes it).

    Faults touch the gates only; `alloc` and copy-on-write check physical
    capacity, so an allocation that passed its gate never fails."""

    def __init__(self, seed: int = 0, *, p_alloc_fail: float = 0.0,
                 hold_pages: int = 0, reclaim_delay: int = 0,
                 p_swap_fail: float = 0.0, swap_delay: int = 0):
        if not 0.0 <= p_alloc_fail <= 1.0:
            raise ValueError(f"p_alloc_fail={p_alloc_fail} not in [0, 1]")
        if not 0.0 <= p_swap_fail <= 1.0:
            raise ValueError(f"p_swap_fail={p_swap_fail} not in [0, 1]")
        if hold_pages < 0 or reclaim_delay < 0 or swap_delay < 0:
            raise ValueError("hold_pages / reclaim_delay / swap_delay "
                             "must be >= 0")
        self._rng = np.random.RandomState(seed)
        self.p_alloc_fail = p_alloc_fail
        self.hold_pages = hold_pages
        self.reclaim_delay = reclaim_delay
        self.p_swap_fail = p_swap_fail
        self.swap_delay = swap_delay
        self.blocked = False        # are this tick's gates blocked?
        self.alloc_fault_ticks = 0  # ticks whose gates reported 0 pages
        self.delayed_releases = 0   # pages that took the deferred path
        self.swap_faults = 0        # host records lost at promotion

    def tick(self) -> None:
        """Advance one scheduler tick: draw whether its gates are blocked."""
        self.blocked = (self.p_alloc_fail > 0.0
                        and bool(self._rng.random_sample() < self.p_alloc_fail))
        if self.blocked:
            self.alloc_fault_ticks += 1

    def swap_fault(self) -> bool:
        """One prefetch's draw: True when its host record is to be lost."""
        hit = (self.p_swap_fail > 0.0
               and bool(self._rng.random_sample() < self.p_swap_fail))
        if hit:
            self.swap_faults += 1
        return hit


class HostPageAllocator:
    """Host-authoritative page allocator: free list, per-page refcounts,
    with ``prefix_cache`` the content-hash index of automatic prefix
    caching, and with a `tiering.HostTier` the host swap tier's half (the
    reference's allocator).

    Pages 1..n_pages-1 are in exactly one population: ``free`` (holding
    nothing), ``ref`` (page -> refcount > 0), ``lru`` (refcount 0 but
    still indexed: hittable, reclaimed in the `tiering.Evictor` policy's
    order when ``alloc`` runs out of free pages), ``inflight`` (page ->
    (digest, tick it lands): staging a host-to-device promotion,
    `begin_prefetch` to `finish_prefetch`) or, with an injector's
    ``reclaim_delay``, ``deferred`` (page -> the tick it leaves for the
    LRU or the free list). ``index`` maps chain digests (`chain_hashes`)
    to pages and ``hash_of`` is its inverse; an indexed page's content
    never changes (`ensure_private` is the copy-on-write gate). With a
    host tier, a reclaimed victim is offered to ``demote_hook(page,
    digest)`` before its index entry dies, and ``demote_flush()`` (when
    set) runs once after the victims of one `alloc`, so the caller can
    batch the copies; `match_tiered` counts host and in-flight digests.
    An attached `PoolFaultInjector` depresses the gates (`available`,
    `available_after_adopt`), never `alloc`."""

    def __init__(self, n_pages: int, *, prefix_cache: bool = False,
                 injector: PoolFaultInjector | None = None,
                 evictor=None, host_tier=None):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the sentinel)")
        self.n_pages = n_pages
        self.prefix_cache = prefix_cache
        self.injector = injector
        self.free: list[int] = list(range(1, n_pages))
        self.ref: dict[int, int] = {}
        self.index: dict[bytes, int] = {}
        self.hash_of: dict[int, bytes] = {}
        if evictor is None:
            evictor = "lru"
        self.lru: TIER.Evictor = (TIER.make_evictor(evictor)
                                  if isinstance(evictor, str) else evictor)
        self.deferred: dict[int, int] = {}   # page -> tick it is disposed
        self.host_tier = host_tier
        self.demote_hook = None     # (page, digest), set by the scheduler
        self.demote_flush = None    # () after one alloc's victims
        self.inflight: dict[int, tuple[bytes, int]] = {}  # page->(h, ready)
        self.inflight_digests: dict[bytes, int] = {}      # inverse
        self._promoted: set[int] = set()     # device pages of host origin
        self._tick = 0
        self.hits = 0           # pages resolved from the index
        self.misses = 0         # prompt pages that had to be computed
        self.reclaims = 0       # cached pages evicted to satisfy alloc
        self.cow_retargets = 0  # shared pages replaced before a flush
        self.prefetch_issued = 0   # host-to-device promotions started
        self.promote_hits = 0      # promoted pages later adopted by a row

    @property
    def n_free(self) -> int:
        """Truly free pages (cached pages still hold data)."""
        return len(self.free)

    @property
    def n_cached(self) -> int:
        """Evictable cached pages (refcount 0, still indexed)."""
        return len(self.lru)

    @property
    def _physical(self) -> int:
        """Pages physically allocatable, faults ignored (what `alloc` and
        copy-on-write check)."""
        return len(self.free) + len(self.lru)

    @property
    def available(self) -> int:
        """Pages an admission may claim: free plus reclaimable, 0 on an
        injector's blocked tick, less its ``hold_pages``."""
        inj = self.injector
        if inj is not None:
            if inj.blocked:
                return 0
            return max(0, self._physical - inj.hold_pages)
        return self._physical

    def available_after_adopt(self, chain) -> int:
        """Pages allocatable once ``chain``'s digests are adopted: adopted
        pages that sit on the LRU stop being reclaimable. Injected faults
        depress it as they do `available`."""
        on_lru = sum(1 for h in chain if self.index.get(h) in self.lru)
        inj = self.injector
        if inj is not None:
            if inj.blocked:
                return 0
            return max(0, self._physical - on_lru - inj.hold_pages)
        return self._physical - on_lru

    def tick(self) -> None:
        """Advance one scheduler tick: the injector's draw, the deferred
        pages whose delay has run out go to the LRU or the free list, and
        in-flight promotions whose delay has run out are published
        (`finish_prefetch`)."""
        self._tick += 1
        if self.injector is not None:
            self.injector.tick()
            for p in [p for p, t in self.deferred.items() if t <= self._tick]:
                del self.deferred[p]
                self._dispose(p)
        for p in [p for p, (_, t) in self.inflight.items()
                  if t <= self._tick]:
            self.finish_prefetch(p)

    def _dispose(self, page: int) -> None:
        """A refcount-0 page goes to the LRU (most recent end) if it is
        indexed, else to the free list."""
        if page in self.hash_of:
            self.lru.cache(page)
        else:
            self.free.append(page)

    def alloc(self, n: int) -> list[int]:
        """Claim ``n`` pages (refcount 1 each): free pages first, then
        cached pages reclaimed in the evictor's victim order, each offered
        to ``demote_hook`` (with a host tier) before it is un-indexed.
        Raises past physical capacity; admission gates on
        `available_after_adopt`."""
        if n > self._physical:
            raise ValueError(f"alloc({n}) exceeds available={self._physical}")
        ids = [self.free.pop() for _ in range(min(n, len(self.free)))]
        demoted = False
        while len(ids) < n:
            page = self.lru.pop_victim()
            digest = self.hash_of.pop(page)
            del self.index[digest]
            self._promoted.discard(page)
            if self.demote_hook is not None and self.host_tier is not None:
                self.demote_hook(page, digest)
                demoted = True
            self.reclaims += 1
            ids.append(page)
        if demoted and self.demote_flush is not None:
            self.demote_flush()
        for p in ids:
            self.ref[p] = 1
        return ids

    def incref(self, page: int) -> None:
        """Add a reference to an already referenced page (sharing)."""
        if self.ref.get(page, 0) <= 0:
            raise ValueError(f"incref of unreferenced page {page}")
        self.ref[page] += 1

    def release(self, pages) -> None:
        """Drop one reference per page. A page reaching 0 is disposed
        (`_dispose`), or with an injector's ``reclaim_delay`` parks in
        ``deferred`` until `tick` disposes of it. A count below 0 is a
        refcounting bug and raises."""
        inj = self.injector
        delay = inj.reclaim_delay if inj is not None else 0
        for p in pages:
            c = self.ref.get(p, 0) - 1
            if c < 0:
                raise ValueError(f"refcount underflow on page {p}")
            if c:
                self.ref[p] = c
                continue
            del self.ref[p]
            if delay:
                self.deferred[p] = self._tick + delay
                inj.delayed_releases += 1
            else:
                self._dispose(p)

    def match(self, chain) -> int:
        """Length of ``chain``'s longest prefix resident in the index (0
        without ``prefix_cache``). No refcount changes."""
        if not self.prefix_cache:
            return 0
        n = 0
        for h in chain:
            if h not in self.index:
                break
            n += 1
        return n

    def match_tiered(self, chain) -> tuple[int, int]:
        """``(dev, swap)``: the device-resident prefix (`match`) and the
        run beyond it restorable without recompute (digests on the host
        tier or already in flight back to the device). No state changes."""
        dev = self.match(chain)
        swap = 0
        if self.prefix_cache and self.host_tier is not None:
            for h in chain[dev:]:
                if h in self.inflight_digests or h in self.host_tier:
                    swap += 1
                else:
                    break
        return dev, swap

    def begin_prefetch(self, digest: bytes, delay: int = 0) -> int:
        """Claim a device page to receive the host record ``digest`` and
        park it in flight; the caller issues the copy. It is published
        (`finish_prefetch`) at once for ``delay`` 0, else by `tick`
        ``delay`` ticks from now. An in-flight page is neither free,
        cached, referenced nor matched by `match`."""
        page = self.alloc(1)[0]
        del self.ref[page]
        self.inflight[page] = (digest, self._tick + delay)
        self.inflight_digests[digest] = page
        self.prefetch_issued += 1
        if delay <= 0:
            self.finish_prefetch(page)
        return page

    def finish_prefetch(self, page: int) -> bool:
        """Publish a landed promotion under its digest on the cached set.
        If the digest was registered meanwhile (a prefill computed the same
        content first), the staging page goes back to the free list.
        Returns True iff published."""
        digest, _ = self.inflight.pop(page)
        del self.inflight_digests[digest]
        if self.prefix_cache and digest not in self.index \
                and page not in self.hash_of:
            self.index[digest] = page
            self.hash_of[page] = digest
            self._promoted.add(page)
            self.lru.cache(page)
            return True
        self.free.append(page)
        return False

    def abort_prefetch(self, page: int) -> None:
        """Cancel an in-flight promotion: the page goes back to the free
        list and the digest stops being in flight."""
        digest, _ = self.inflight.pop(page)
        del self.inflight_digests[digest]
        self.free.append(page)

    def adopt(self, chain) -> list[int]:
        """Take a reference on each digest's page (reviving cached and
        deferred pages); returns the pages in chain order and counts them
        as hits (a promoted page's first adoption also as a prefetch
        hit)."""
        ids = []
        for h in chain:
            p = self.index[h]
            if p in self.lru:
                self.lru.uncache(p)
                self.ref[p] = 1
            elif p in self.deferred:
                del self.deferred[p]
                self.ref[p] = 1
            else:
                self.ref[p] += 1
            if p in self._promoted:         # first adoption after a swap-in
                self._promoted.discard(p)
                self.promote_hits += 1
            ids.append(p)
        self.hits += len(ids)
        return ids

    def register(self, page: int, digest: bytes) -> bool:
        """Publish a fully written page under its chain digest. The first
        writer wins: a digest already indexed leaves ``page`` a private
        duplicate (returns False). A page holds one digest; registering it
        under a second raises."""
        if not self.prefix_cache or digest in self.index:
            return False
        if page in self.hash_of:
            raise ValueError(f"page {page} is already registered; a page "
                             f"holds exactly one digest (immutable content)")
        self.index[digest] = page
        self.hash_of[page] = digest
        return True

    def ensure_private(self, page: int) -> int | None:
        """Copy-on-write gate before a row flushes into ``page``: None when
        the row owns it alone and it is unindexed; otherwise a new page
        (this row's reference on the shared one dropped) that the caller
        retargets its table entry to. No device copy is needed: the flush
        writes the whole page from the row's fp residual."""
        if self.ref.get(page, 0) <= 1 and page not in self.hash_of:
            return None
        if not self._physical:
            raise ValueError("copy-on-write retarget needs a free page: "
                             "leave pool headroom when forking")
        new = self.alloc(1)[0]
        self.release([page])
        self.cow_retargets += 1
        return new


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
    allocation policy lives in `HostPageAllocator`; ``n_free`` is a host
    int mirroring its free count (the scheduler's `_sync_device` sets it),
    where the reference keeps a device free stack."""

    def __init__(self, k_q, v_q, k_s, v_s, page_size: int, kv_dtype: str):
        self.k_q, self.v_q, self.k_s, self.v_s = k_q, v_q, k_s, v_s
        self.page_size = page_size
        self.kv_dtype = kv_dtype
        self.n_free = k_q.shape[0] - 1

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


def gather_pages(pool_kq, pool_ks, pool_vq, pool_vs, page_table):
    """The contiguous cache layout from a page pool: pool (n_pages,
    ps_packed, H, D) + table (B, NT) -> values (B, H, NT * ps_packed, D)
    and float32 scales (B, H, NT, D), K then V (the reference path's
    gather; the paged kernels read pages through the table instead)."""
    B, NT = page_table.shape
    _, ps, H, D = pool_kq.shape
    tbl = page_table.long()

    def gq(pool_q):
        return pool_q[tbl].permute(0, 3, 1, 2, 4).reshape(B, H, NT * ps, D)

    def gs(pool_s):
        return pool_s[tbl].permute(0, 2, 1, 3)

    return gq(pool_kq), gs(pool_ks), gq(pool_vq), gs(pool_vs)


class PagedQuantizedKVCache:
    """Per-row page-table view over a `PagePool` (see module docstring).
    `prefill_at`, `append` and `fork_row` write the pool, the residuals,
    the lengths and the table in place and return ``self``."""

    def __init__(self, pool: PagePool, page_table: torch.Tensor,
                 resid_k: torch.Tensor, resid_v: torch.Tensor,
                 length: torch.Tensor):
        self.pool = pool
        self.page_table = page_table
        self.resid_k, self.resid_v = resid_k, resid_v
        self.length = length
        # the mesh axes this rank's kv heads are a shard over (under a
        # mesh, where `parallel.shard.page_pool_specs` shards them)
        self.kv_axes: tuple[str, ...] = ()

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

    def prefill(self, k: torch.Tensor, v: torch.Tensor, row_mask=None
                ) -> "PagedQuantizedKVCache":
        """Write a whole (B, H, T, D) prompt, T a page multiple, into each
        row's first T / page_size mapped pages (the reference's
        whole-prompt entry point; the scheduler goes through
        `prefill_at`): `prefill_at` from block 0 with every token valid,
        so the residuals are cleared and the lengths set to T."""
        if k.shape[2] % self.page_size:
            raise ValueError(f"T={k.shape[2]} not a multiple of "
                             f"page_size={self.page_size}")
        return self.prefill_at(k, v, torch.zeros_like(self.length),
                               row_mask=row_mask)

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
        if row_mask is not None:
            rm = row_mask[:, None, None, None]
            new_len = torch.where(row_mask, new_len, self.length)
            rk = torch.where(rm, rk, self.resid_k)
            rv = torch.where(rm, rv, self.resid_v)
        self.length.copy_(new_len)
        self.resid_k.copy_(rk)
        self.resid_v.copy_(rv)
        return self

    def dequantized_prefix(self, n_blocks: int, dtype=torch.float32
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dequantized (k, v) of each row's first ``n_blocks`` logical
        blocks: (B, H_kv, n_blocks * ps, D) in ``dtype``, no residual
        overlay. The parity oracle's history read only
        (`attention.prefill_chunk(use_fused=False)`): the fused paged
        prefill kernel reads the pages in place and never writes this
        copy. Plain dequantization of the gathered pages (the
        reference's ``Q.dequantize_pages``), not a kernel."""
        k_q, k_s, v_q, v_s = gather_pages(
            self.pool.k_q, self.pool.k_s, self.pool.v_q, self.pool.v_s,
            self.page_table[:, :n_blocks])
        kv_dtype = self.pool.kv_dtype
        return (Q.dequantize_pages(k_q, k_s, kv_dtype, dtype=dtype),
                Q.dequantize_pages(v_q, v_s, kv_dtype, dtype=dtype))

    def fork_row(self, src: int, dst: int) -> "PagedQuantizedKVCache":
        """Copy row ``src``'s view into row ``dst``, in place: page table
        row, fp residual and length. The physical pages become shared: the
        caller takes references (`HostPageAllocator.incref`) and, before
        either row flushes into a still-shared page, retargets it through
        `HostPageAllocator.ensure_private` (the residual copied here is the
        private page content, so no device copy is needed)."""
        for x in (self.page_table, self.resid_k, self.resid_v, self.length):
            x[dst] = x[src]
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
        self.resid_k.copy_(torch.where(clear, torch.zeros_like(resid_k),
                                       resid_k))
        self.resid_v.copy_(torch.where(clear, torch.zeros_like(resid_v),
                                       resid_v))
        self.length.add_(1 if row_mask is None else row_mask.to(torch.int32))
        return self
