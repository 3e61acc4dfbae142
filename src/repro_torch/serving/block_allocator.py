"""Refcounted fixed-size page allocator for the paged KV cache.

The global KV pool is a flat array of physical pages (page = a fixed
number of token positions, all layers stacked alongside in the pool
tensors).  Each page carries a reference count:

  * a decode slot holds one reference per page in its block table;
  * the PredictiveCacheManager holds one reference per page backing a
    registered (tier-0-resident) prompt block;
  * radix-prefix hits map the *same* physical pages into a new slot's
    block table (refcount bump — copy-on-write sharing, §III-F).

Pages return to the free list only when the count reaches zero, so a
finished request's prefix pages survive for cross-request reuse exactly
as long as the cache manager keeps the block hot.  Writers must call
``ensure_private`` (via PagedKVCache) before mutating a shared page —
the copy-on-write step.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Sequence

from repro_torch.core.tiers import CapacityError

RESERVED = -1          # refcount sentinel: page never allocatable


@dataclass
class AllocatorStats:
    allocated: int = 0        # pages handed out
    freed: int = 0            # pages returned to the free list
    shares: int = 0           # CoW references added (prefix sharing)
    cow_copies: int = 0       # private copies forced by a write to a shared page
    peak_in_use: int = 0

    def as_dict(self) -> dict:
        return {"allocated": self.allocated, "freed": self.freed,
                "shares": self.shares, "cow_copies": self.cow_copies,
                "peak_in_use": self.peak_in_use}


class BlockAllocator:
    """Free-list page allocator with per-page refcounts."""

    def __init__(self, n_pages: int, reserved: Sequence[int] = ()):
        self.n_pages = n_pages
        self._refs = [0] * n_pages
        rset = set(reserved)
        for r in rset:
            self._refs[r] = RESERVED
        self._free: Deque[int] = deque(i for i in range(n_pages)
                                       if i not in rset)
        self._lock = threading.Lock()
        self._in_use = 0           # incrementally tracked page count —
        #                            alloc() used to recount every
        #                            refcount per call, an O(n_pages)
        #                            scan on the per-step decode path
        self.stats = AllocatorStats()

    # ------------------------------------------------------------------
    @property
    def n_free(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self._in_use

    def refcount(self, page_id: int) -> int:
        return self._refs[page_id]

    # ------------------------------------------------------------------
    def alloc(self, n: int = 1) -> List[int]:
        """Take ``n`` pages off the free list (refcount 1 each)."""
        with self._lock:
            if len(self._free) < n:
                raise CapacityError(
                    f"KV pool exhausted: need {n} pages, "
                    f"{len(self._free)}/{self.n_pages} free")
            out = [self._free.popleft() for _ in range(n)]
            for pid in out:
                self._refs[pid] = 1
            self.stats.allocated += n
            self._in_use += n
            self.stats.peak_in_use = max(self.stats.peak_in_use,
                                         self._in_use)
            return out

    def ref(self, page_id: int, *, share: bool = False) -> None:
        """Add a reference to an already-allocated page."""
        with self._lock:
            if self._refs[page_id] <= 0:
                raise ValueError(f"page {page_id} not allocated")
            self._refs[page_id] += 1
            if share:
                self.stats.shares += 1

    def deref(self, page_id: int) -> bool:
        """Drop one reference; returns True if the page was freed."""
        with self._lock:
            r = self._refs[page_id]
            if r == RESERVED:
                return False
            if r <= 0:
                raise ValueError(f"page {page_id} double-free")
            self._refs[page_id] = r - 1
            if r == 1:
                self._free.append(page_id)
                self.stats.freed += 1
                self._in_use -= 1
                return True
            return False

    def note_cow_copy(self) -> None:
        with self._lock:
            self.stats.cow_copies += 1

    # ------------------------------------------------------------------
    def stats_dict(self) -> dict:
        with self._lock:
            d = self.stats.as_dict()
        d.update(n_pages=self.n_pages, free=self.n_free, in_use=self.in_use)
        return d
