"""Block-paged KV cache: fixed page geometry + host-side free-list alloc.

The port of ``repro.serve.paged_kv`` (pure host code, copied).  The
device side is a per-layer page *pool* ``[n_pages, page_size, KV, hd]``
(specs from ``Model.paged_cache_specs(n_pages, page_size)``); slots own
pages through an int32 page table ``[n_slots, pages_per_slot]`` that the
decode step indirects every read/write through (the ring-write of the
dense cache generalized to table lookup).  This module is the host-side
bookkeeping: geometry arithmetic and the free-list allocator that makes
KV memory scale with *live tokens* instead of ``n_slots * cache_n``.

Page 0 is a reserved scratch page: it is never handed out, table rows of
empty slots point at it, and invalid-token writes are redirected there,
so a fixed-shape step can always write somewhere harmless.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

__all__ = ["SCRATCH_PAGE", "PageGeometry", "PageAllocator"]

#: Reserved pool page absorbing writes from inactive/padded positions.
SCRATCH_PAGE = 0


@dataclass(frozen=True)
class PageGeometry:
    """Fixed page geometry — pinned at engine build so shapes never change.

    ``n_pages`` counts the scratch page; ``usable_pages`` excludes it.
    """

    page_size: int
    n_pages: int
    pages_per_slot: int

    def __post_init__(self):
        if self.page_size < 1 or self.pages_per_slot < 1:
            raise ValueError(f"degenerate page geometry {self}")
        if self.n_pages < 2:
            raise ValueError(
                f"n_pages={self.n_pages} leaves no usable page after the "
                f"scratch page {SCRATCH_PAGE}")

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV entries."""
        return max(1, -(-n_tokens // self.page_size))

    @property
    def slot_capacity(self) -> int:
        """Max tokens one slot can address through its page table."""
        return self.pages_per_slot * self.page_size

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def token_capacity(self) -> int:
        """Total live tokens the pool can hold across all slots."""
        return self.usable_pages * self.page_size


class PageAllocator:
    """Free-list allocator over the pool's usable pages.

    Allocation is all-or-nothing (a request reserves its worst case at
    admission, so decode can never deadlock mid-generation) and freeing
    a page twice raises — the leak invariant the tests assert is exactly
    ``n_free == usable_pages`` after a drained burst.
    """

    def __init__(self, geom: PageGeometry):
        self.geom = geom
        # ascending hand-out order (pop from the front) purely for
        # debuggability; correctness never depends on which page you get
        self._free: List[int] = list(range(1, geom.n_pages))
        self._live: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._live)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` pages, or None (and no change) if not available."""
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        self._live.update(pages)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if p not in self._live:
                raise ValueError(f"double free / foreign page {p}")
            self._live.discard(p)
        self._free.extend(pages)
