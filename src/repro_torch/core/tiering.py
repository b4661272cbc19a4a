"""Tiered KV cache: the host swap tier, pluggable device eviction and the
swap-vs-recompute cost model (port of ``repro.core.tiering``).

A full prefix page is resident in the device pool, parked on the host
tier, or gone. The tier keys its records by the same chain digests the
device index uses (`core.paging.chain_hashes`), so a digest is a handle
that does not depend on where the page lives: demotion moves it from a
device page id to a host record, promotion moves it back.

  * `Evictor` owns the allocator's cached population (refcount 0, still
    indexed) and picks reclaim victims: `LRUEvictor` oldest first (the
    baseline), `FreqSizeEvictor` lowest hit density first. Its read
    surface (`in` / `iter` / `len`) is a dict's.
  * `HostTier` maps digest -> `HostPageRecord` with its own LRU capacity
    (``capacity`` pages). A record holds the page's quantized values and
    scale rows of every layer in host tensors (pinned when the pools live
    on the card); with ``dtype`` set they are recompressed to that storage
    format (`repack_page`), which gives up the bitwise restore for host
    bytes. The scheduler keeps its records in a `HostSlab`: the tier's
    host memory, pinned on the card and allocated once.
  * `SwapCostModel` prices a restore (one copy, ``copy_cost_tokens``)
    against a recompute (``page_size`` prefill tokens).

The allocator's half (the in-flight population, prefetch begin / finish /
abort, the demote hook) is `core.paging.HostPageAllocator`; the copies
themselves are issued by the scheduler, which owns the pools.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from repro_torch.core import quantization as Q


# ---------------------------------------------------------------------------
# Pluggable device-eviction policy
# ---------------------------------------------------------------------------

class Evictor:
    """The allocator's cached pages (refcount 0, still in the content-hash
    index) and the choice of reclaim victims. The allocator calls `cache`
    when a page's last reference goes, `uncache` when a row adopts it (a
    hit, counted per page) and `pop_victim` when `alloc` runs out of free
    pages. Hit counts survive cache/uncache cycles of one physical page
    and reset when it is evicted (its content is about to change)."""

    def __init__(self):
        self._cached: OrderedDict[int, int] = OrderedDict()  # page -> bytes
        self._hits: dict[int, int] = {}

    def __contains__(self, page) -> bool:
        return page in self._cached

    def __len__(self) -> int:
        return len(self._cached)

    def __iter__(self):
        return iter(self._cached)

    def cache(self, page: int, nbytes: int = 1) -> None:
        """Admit a refcount-0 indexed page (most recently used end)."""
        self._cached[page] = nbytes
        self._hits.setdefault(page, 0)

    def uncache(self, page: int) -> None:
        """Remove an adopted page (a hit); its hit count persists."""
        del self._cached[page]
        self._hits[page] = self._hits.get(page, 0) + 1

    def pop_victim(self) -> int:
        """Evict and return the policy's victim; its hit count resets."""
        page = self._select()
        del self._cached[page]
        self._hits.pop(page, None)
        return page

    def hits_of(self, page: int) -> int:
        """Adoptions of ``page`` since it was last evicted."""
        return self._hits.get(page, 0)

    def _select(self) -> int:
        raise NotImplementedError


class LRUEvictor(Evictor):
    """Oldest cached page first: the baseline policy and victim order."""

    def _select(self) -> int:
        return next(iter(self._cached))


class FreqSizeEvictor(Evictor):
    """Lowest hit density (adoptions per byte) first, ties oldest first: a
    system prompt every request adopts stays resident under pressure that
    would roll an LRU over it. In one uniform pool every page costs the
    same bytes, so density is plain hit frequency."""

    def _select(self) -> int:
        return min(
            ((self._hits.get(p, 0) / max(nb, 1), k, p)
             for k, (p, nb) in enumerate(self._cached.items())),
        )[2]


EVICTORS = {"lru": LRUEvictor, "freq": FreqSizeEvictor}


def make_evictor(name: str) -> Evictor:
    """A registered `Evictor` by name: ``lru`` or ``freq``."""
    if name not in EVICTORS:
        raise ValueError(f"unknown evictor {name!r}; "
                         f"expected one of {sorted(EVICTORS)}")
    return EVICTORS[name]()


# ---------------------------------------------------------------------------
# Host tier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostPageRecord:
    """One demoted page: per layer ``(k_q, k_s, v_q, v_s)`` host tensors,
    the storage dtype of each layer's values, and its bytes (from shapes).
    The scheduler's records live in `HostSlab` slot ``slot``: ``blocks``
    is the slot's (values, scales) of which ``payloads`` are views,
    ``ready`` the CUDA event after the device-to-host copy that fills it
    and ``read`` the event after the last promotion that read it (None on
    the CPU). Read no byte on the host before `wait`."""
    digest: bytes
    payloads: list
    dtypes: list[str]
    nbytes: int
    hits: int = 0
    blocks: tuple | None = None
    slot: int | None = None
    ready: object | None = None
    read: object | None = None

    def wait(self) -> "HostPageRecord":
        """Block the host until the record's bytes have landed."""
        if self.ready is not None:
            self.ready.synchronize()
        return self


class HostTier:
    """Host-RAM page store keyed by chain digest, ``capacity`` pages with
    its own LRU: the allocator's reclaim demotes cold indexed pages here
    instead of dropping them, and admission promotes them back ahead of
    prefill. With ``dtype`` (one of `Q.KV_DTYPES`) demoted pages are
    stored recompressed to that format (`repack_page`): lossy, so restores
    are no longer bitwise; None stores the device bytes verbatim."""

    def __init__(self, capacity: int, *, dtype: str | None = None):
        if capacity < 1:
            raise ValueError(f"host tier needs capacity >= 1 pages "
                             f"(got {capacity})")
        if dtype is not None:
            Q.kv_storage_dtype(dtype)       # validates the name
        self.capacity = capacity
        self.dtype = dtype
        self.pages: OrderedDict[bytes, HostPageRecord] = OrderedDict()
        self.on_remove = None       # (record) when one leaves the tier
        self.demotions = 0          # device pages copied in
        self.promotions = 0         # host pages copied back out
        self.host_evictions = 0     # records dropped by the capacity LRU
        self.lost = 0               # records dropped by injected swap faults

    def __contains__(self, digest: bytes) -> bool:
        return digest in self.pages

    def __len__(self) -> int:
        return len(self.pages)

    @property
    def nbytes(self) -> int:
        """Host bytes held (the tier's half of the split-tier accounting)."""
        return sum(r.nbytes for r in self.pages.values())

    def evict_oldest(self) -> None:
        """Drop the coldest record (the capacity LRU)."""
        rec = self.pages.popitem(last=False)[1]
        self.host_evictions += 1
        if self.on_remove is not None:
            self.on_remove(rec)

    def put(self, digest: bytes, payloads, dtypes, *, blocks=None,
            slot=None, ready=None) -> bool:
        """Store one page's per-layer payloads under ``digest`` (most
        recently used end). A digest already held is refreshed, not copied
        again (registered pages are immutable, so the first copy is the
        copy). Overflow drops the coldest record. Returns True iff a new
        record was stored."""
        if digest in self.pages:
            self.pages.move_to_end(digest)
            return False
        while len(self.pages) >= self.capacity:
            self.evict_oldest()
        nbytes = sum(int(a.nbytes) for p in payloads for a in p)
        self.pages[digest] = HostPageRecord(digest, list(payloads),
                                            list(dtypes), nbytes,
                                            blocks=blocks, slot=slot,
                                            ready=ready)
        self.demotions += 1
        return True

    def get(self, digest: bytes) -> HostPageRecord:
        """Promotion read: the record, refreshed to most recently used. It
        stays on the tier (a later demotion of the same content is free)."""
        rec = self.pages[digest]
        self.pages.move_to_end(digest)
        rec.hits += 1
        self.promotions += 1
        return rec

    def drop(self, digest: bytes) -> None:
        """Discard a record (an injected swap fault): the digest stops
        matching, so the requester recomputes instead of waiting on a copy
        that never lands."""
        rec = self.pages.pop(digest, None)
        if rec is not None:
            self.lost += 1
            if self.on_remove is not None:
                self.on_remove(rec)

    def run_length(self, chain, start: int = 0) -> int:
        """Length of the run of ``chain[start:]`` held here (no recency
        change)."""
        n = 0
        for h in chain[start:]:
            if h not in self.pages:
                break
            n += 1
        return n


class HostSlab:
    """Host memory for a tier's records, allocated with the tier:
    ``capacity`` page slots of values (``q_shape``, int8 bytes) and float32
    scales (``s_shape``), pinned when the pools are on the card
    (``device``), so a demotion's copy lands without an allocation
    (pinning memory costs far more than copying it). ``q[slot]`` and
    ``s[slot]`` are a slot's tensors. A record holds one slot from its
    demotion until it leaves the tier; a freed slot is handed out again
    only after the current stream has waited on the last copy that read
    it, and a slot `hold` keeps (a promotion not yet issued reads it) is
    freed at `unhold`. With every slot held or in use, `take` adds one."""

    def __init__(self, capacity: int, q_shape, s_shape, *, device):
        self.device = torch.device(device)
        self._shapes = (tuple(q_shape), tuple(s_shape))
        self.q: list[torch.Tensor] = []
        self.s: list[torch.Tensor] = []
        self.free: list[int] = []
        self._after: dict[int, object] = {}   # slot -> last reader's event
        self._held: dict[int, bool] = {}      # slot -> its record left
        self._grow(capacity)

    def _grow(self, n: int) -> None:
        pin = self.device.type == "cuda"
        (qs, ss), start = self._shapes, len(self.q)
        self.q.extend(torch.empty((n, *qs), dtype=torch.int8,
                                  pin_memory=pin).unbind(0))
        self.s.extend(torch.empty((n, *ss), dtype=torch.float32,
                                  pin_memory=pin).unbind(0))
        self.free.extend(range(start + n - 1, start - 1, -1))

    def take(self) -> int:
        """A free slot, safe to overwrite on the current stream."""
        if not self.free:
            self._grow(1)
        slot = self.free.pop()
        ev = self._after.pop(slot, None)
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        return slot

    def release(self, rec: HostPageRecord) -> None:
        """Return ``rec``'s slot (the tier's ``on_remove``); a held slot
        is returned at `unhold`."""
        if rec.slot in self._held:
            self._held[rec.slot] = True
            return
        if rec.read is not None:
            self._after[rec.slot] = rec.read
        self.free.append(rec.slot)

    def hold(self, rec: HostPageRecord) -> None:
        """Keep ``rec``'s slot from reuse until `unhold`, even if the
        record leaves the tier meanwhile."""
        self._held.setdefault(rec.slot, False)

    def unhold(self, rec: HostPageRecord) -> None:
        """End a `hold` (after the copy that reads the slot is issued)."""
        if self._held.pop(rec.slot):
            self.release(rec)


# ---------------------------------------------------------------------------
# Swap-vs-recompute cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SwapCostModel:
    """Swap against recompute in prefill-token units: restoring a page
    costs one copy, ``copy_cost_tokens`` tokens of prefill (default 1),
    recomputing it ``page_size`` tokens. The scheduler asks `prefer_swap`
    at demotion, at admission (wait for a prefetch or prefill again) and
    at preemption (preempt-by-swap); a ``copy_cost_tokens`` above
    ``page_size`` turns every choice to recompute."""

    page_size: int
    copy_cost_tokens: float = 1.0

    def swap_cost(self, n_pages: int) -> float:
        return n_pages * self.copy_cost_tokens

    def recompute_cost(self, n_pages: int) -> float:
        return float(n_pages * self.page_size)

    def prefer_swap(self, n_pages: int = 1) -> bool:
        """True when copying ``n_pages`` beats recomputing them."""
        return self.swap_cost(n_pages) < self.recompute_cost(n_pages)


# ---------------------------------------------------------------------------
# Host recompression
# ---------------------------------------------------------------------------

def repack_page(q: torch.Tensor, s: torch.Tensor, src_dtype: str,
                dst_dtype: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Requantize pages between storage dtypes, pool layout in and out:
    values (..., tokens_packed, H, D) in ``src_dtype`` storage, float32
    scales (..., H, D). The same dtype returns its inputs (bitwise);
    otherwise the f32 values (`Q.dequantize_pages`) are quantized again
    (`Q.quantize_page_matrix`), on whatever device the tensors are."""
    if src_dtype == dst_dtype:
        return q, s
    x = Q.dequantize_pages(q.movedim(-3, -2), s[..., None, :].float(),
                           src_dtype)                     # (..., H, ps, D)
    q2, s2 = Q.quantize_page_matrix(x, dst_dtype)         # (..., H, tp2, D)
    return q2.movedim(-2, -3), s2
