"""Host-side page-pool bookkeeping for the paged KV cache, in plain Python.

A copy of `repro.serving.kv_pool` (DESIGN.md §12), which imports no JAX; the
port keeps its own so that it never imports the reference package.

The device side is a fixed pool of (n_pages, page_size) K/V pages per
attention layer (models/attention.py paged_init_cache); this module owns
everything the model step does not see: the free list, per-page refcounts,
the prefix cache that maps page-aligned prompt prefixes onto already-written
pages, and the copy-on-write decision. All methods are O(pages touched)
Python; the engine calls them between forwards.

Sharing model:
  - a page is *live* while any request maps it (refcount >= 1);
  - a page whose content is a registered full-page prompt prefix stays
    resident after its last request retires (refcount 0, on the evictable
    LRU) so later requests with the same prefix skip prefill for it;
  - eviction (reclaiming a cached page for a fresh allocation) comes
    before shedding: `alloc` pops the free list first, then the oldest
    evictable page, and only returns None when both are empty, at which
    point the engine sheds a request (never runs out of memory).

Prefix keys are the literal token-id tuples `prompt[:k*page_size]`: exact
match by construction, no hash-collision risk. Registered pages are
immutable: any write that would land on one (or on a page another request
can see) triggers copy-on-write in the engine, guided by `needs_cow`.

Page 0 is the reserved garbage page (attention.GARBAGE_PAGE): masked
writes are routed there, so it is never allocated here.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.models.attention import GARBAGE_PAGE


class KVPagePool:
    def __init__(self, n_pages: int, page_size: int, *, prefix_sharing: bool = True):
        if n_pages < 2:
            raise ValueError(f"n_pages={n_pages}: need >= 2 (page 0 is reserved)")
        if page_size < 1:
            raise ValueError(f"page_size={page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self.prefix_sharing = bool(prefix_sharing)
        self.refcount = np.zeros((n_pages,), np.int64)
        # pop() allocates ascending from 1; GARBAGE_PAGE never enters the list
        self._free: list[int] = list(range(n_pages - 1, GARBAGE_PAGE, -1))
        self._prefix_pages: dict[tuple, int] = {}   # token-id tuple -> page
        self._page_key: dict[int, tuple] = {}       # page -> its registered key
        self._evictable: OrderedDict[int, None] = OrderedDict()  # rc==0, registered
        self.counters: dict[str, int] = {}
        self.peak_resident = 0
        self.reset_counters()

    # ---------------- capacity views ----------------
    @property
    def n_allocatable(self) -> int:
        """Pages a request could ever hold (pool minus the garbage page)."""
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        """Pages on the free list (content-less)."""
        return len(self._free)

    @property
    def n_cached(self) -> int:
        """Retired prefix pages kept resident for reuse (evictable)."""
        return len(self._evictable)

    @property
    def n_resident(self) -> int:
        """Pages holding live or cached content."""
        return self.n_pages - 1 - len(self._free)

    @property
    def n_shared(self) -> int:
        """Pages mapped by more than one request right now."""
        return int((self.refcount > 1).sum())

    def reset_counters(self) -> None:
        self.counters = {
            "prefix_lookups": 0,
            "prefix_hits": 0,
            "cow_copies": 0,
            "prefix_evictions": 0,
            "alloc_failures": 0,
        }
        self.peak_resident = self.n_resident

    # ---------------- allocation ----------------
    def alloc(self) -> int | None:
        """One exclusively-owned page (refcount 1), or None when the pool is
        exhausted — free list empty AND nothing evictable. Never raises and
        never returns GARBAGE_PAGE; exhaustion is the caller's scheduling
        problem (the engine sheds a request, DESIGN.md §12.3)."""
        if self._free:
            page = self._free.pop()
        elif self._evictable:
            page, _ = self._evictable.popitem(last=False)        # oldest first
            del self._prefix_pages[self._page_key.pop(page)]
            self.counters["prefix_evictions"] += 1
        else:
            self.counters["alloc_failures"] += 1
            return None
        self.refcount[page] = 1
        self.peak_resident = max(self.peak_resident, self.n_resident)
        return page

    def ref(self, page: int) -> None:
        if page == GARBAGE_PAGE:
            raise ValueError("refusing to map the garbage page")
        if self.refcount[page] == 0:
            # cached -> live again: it must leave the evictable list
            self._evictable.pop(page, None)
        self.refcount[page] += 1

    def unref(self, page: int) -> None:
        if self.refcount[page] <= 0:
            raise ValueError(f"unref of unmapped page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            if page in self._page_key:
                self._evictable[page] = None     # keep resident for prefix reuse
            else:
                self._free.append(page)

    # ---------------- prefix cache ----------------
    def lookup_prefix(self, prompt) -> list[int]:
        """Longest chain of cached full-page prefixes of `prompt`; the
        returned pages are ref'd for the caller (one request)."""
        if not self.prefix_sharing:
            return []
        self.counters["prefix_lookups"] += 1
        pages: list[int] = []
        for pi in range(len(prompt) // self.page_size):
            page = self._prefix_pages.get(tuple(prompt[: (pi + 1) * self.page_size]))
            if page is None:
                break
            pages.append(page)
        for p in pages:
            self.ref(p)
        self.counters["prefix_hits"] += len(pages)
        return pages

    def register_prefix(self, prefix: tuple, page: int) -> bool:
        """Publish `page` as holding the K/V of token prefix `prefix`
        (a full-page-aligned token-id tuple). First writer wins; a page
        already carrying a key keeps it."""
        if not self.prefix_sharing:
            return False
        if prefix in self._prefix_pages or page in self._page_key:
            return False
        self._prefix_pages[prefix] = page
        self._page_key[page] = prefix
        return True

    def is_registered(self, page: int) -> bool:
        return page in self._page_key

    def needs_cow(self, page: int) -> bool:
        """A write may not land on a page other requests can see (shared)
        or that the prefix cache has published (immutable content)."""
        return self.refcount[page] > 1 or page in self._page_key
