"""Eviction policy of the page pool's cached population (port of the
``"lru"`` policy of ``repro.core.tiering``).

`HostPageAllocator` parks pages whose refcount reached 0 but whose content
is still indexed in an `LRUEvictor`; when free pages run out, `pop_victim`
names the cached page to reclaim. The ``"freq"`` policy (which needs the
reference's per-page hit counts) and the host swap tier are ROADMAP queue
1, item 10.
"""
from __future__ import annotations

from collections import OrderedDict


class LRUEvictor:
    """Cached (refcount 0, still indexed) pages, evicted oldest-cached
    first: the reference's baseline policy and victim order."""

    def __init__(self):
        self._cached: OrderedDict[int, None] = OrderedDict()

    def __contains__(self, page) -> bool:
        return page in self._cached

    def __len__(self) -> int:
        return len(self._cached)

    def __iter__(self):
        return iter(self._cached)

    def cache(self, page: int) -> None:
        """Admit a refcount-0 indexed page (most recently used end)."""
        self._cached[page] = None

    def uncache(self, page: int) -> None:
        """Remove an adopted page (a hit)."""
        del self._cached[page]

    def pop_victim(self) -> int:
        """Evict and return the oldest cached page."""
        return self._cached.popitem(last=False)[0]
