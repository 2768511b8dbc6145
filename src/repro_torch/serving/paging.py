"""Block-granular KV page allocator for the paged decode engine.

A :class:`PageAllocator` manages the *logical* side of a global KV page
pool: a free list over page ids ``1..num_pages`` (page id 0 is the reserved
trash page — inactive slots' writes land there and are masked by length, so
it is never allocated), an ownership map ``slot -> [page ids]``, and a
reservation ledger that holds back the worst-case growth pages of admitted
requests so a mid-generation block-boundary crossing can never fail.

Lifecycle mirrors the engine's slot lifecycle:

  ``reserve(slot, n_pages)``  — at scheduling time, promise the request its
      worst-case page count; admission gating checks ``available_pages``
      (free minus everyone else's reservations), so two requests admitted
      in the same tick cannot both count the same free pages.
  ``admit(slot, n_map, n_total)`` — map the prompt's pages now; the
      remaining ``n_total - n_map`` stay reserved for ``grow``.
  ``grow(slot)``  — one page when generation crosses a block boundary,
      drawn from the slot's reservation.
  ``release(slot)`` — return every owned page and drop any reservation.

Pure Python/stdlib on purpose: the hypothesis property suite and the
sanitizer's page invariants exercise it without touching JAX.
"""
from __future__ import annotations

from typing import Dict, List, Optional

TRASH_PAGE = 0


class PageAllocator:
    def __init__(self, num_pages: int, block: int):
        if num_pages < 1:
            raise ValueError("need at least one allocatable page")
        self.num_pages = num_pages
        self.block = block
        # Descending so pop() hands out 1, 2, 3, ... on a fresh pool;
        # released pages go to the tail and are reused LIFO (deterministic).
        self._free: List[int] = list(range(num_pages, 0, -1))
        self.owned: Dict[int, List[int]] = {}
        self.reserved: Dict[int, int] = {}

    # -- accounting ----------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` KV entries."""
        return max(1, -(-n_tokens // self.block))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def reserved_pages(self) -> int:
        return sum(self.reserved.values())

    @property
    def available_pages(self) -> int:
        """Free pages not promised to an already-scheduled request."""
        return len(self._free) - self.reserved_pages

    @property
    def used_pages(self) -> int:
        return sum(len(p) for p in self.owned.values())

    def free_list(self) -> List[int]:
        return list(self._free)

    def all_pages(self) -> frozenset:
        return frozenset(range(1, self.num_pages + 1))

    # -- lifecycle -----------------------------------------------------

    def can_admit(self, n_total: int) -> bool:
        return n_total <= self.available_pages

    def reserve(self, slot: int, n_total: int) -> bool:
        """Promise ``n_total`` pages to ``slot``; False if the pool cannot
        honour it (caller must not admit)."""
        assert slot not in self.owned and slot not in self.reserved, slot
        if n_total > self.available_pages:
            return False
        self.reserved[slot] = n_total
        return True

    def admit(self, slot: int, n_map: int,
              n_total: Optional[int] = None) -> Optional[List[int]]:
        """Map ``n_map`` pages to ``slot`` now, keeping the rest of its
        ``n_total`` worst case reserved for :meth:`grow`.  Returns the page
        ids, or None if the pool cannot cover an unreserved admission."""
        assert slot not in self.owned, slot
        if n_total is None:
            n_total = n_map
        n_total = max(n_total, n_map)
        if slot not in self.reserved:
            if n_total > self.available_pages:
                return None
            self.reserved[slot] = n_total
        pages = [self._free.pop() for _ in range(n_map)]
        self.owned[slot] = pages
        left = self.reserved[slot] - n_map
        if left > 0:
            self.reserved[slot] = left
        else:
            del self.reserved[slot]
        return pages

    def grow(self, slot: int) -> int:
        """One more page for ``slot`` (generation crossed a block boundary).
        Draws on the slot's reservation — gated admission guarantees it."""
        assert slot in self.owned, slot
        left = self.reserved.get(slot, 0)
        if left == 0 and self.available_pages <= 0:
            raise RuntimeError(
                f"page pool exhausted growing slot {slot}: admission was "
                "not gated on the worst-case page count")
        page = self._free.pop()
        if left:
            if left == 1:
                del self.reserved[slot]
            else:
                self.reserved[slot] = left - 1
        self.owned[slot].append(page)
        return page

    def release(self, slot: int) -> List[int]:
        """Return every page owned by ``slot`` (and drop any outstanding
        reservation).  Safe on a slot that only ever reserved."""
        self.reserved.pop(slot, None)
        pages = self.owned.pop(slot, [])
        self._free.extend(pages)
        return pages

    # -- invariants ----------------------------------------------------

    def audit(self) -> List[str]:
        """Internal-consistency problems, empty when healthy.  The engine
        sanitizer layers the slot-lifecycle invariants (released slots hold
        zero pages, table rows match ownership) on top of this."""
        problems = []
        held = [p for pages in self.owned.values() for p in pages]
        if len(set(held)) != len(held):
            problems.append("page owned by two live slots")
        if TRASH_PAGE in held or TRASH_PAGE in self._free:
            problems.append("trash page 0 entered circulation")
        if set(self._free) & set(held):
            problems.append("page simultaneously free and owned")
        if set(self._free) | set(held) != self.all_pages():
            problems.append("free list + owned pages do not cover the pool")
        if self.reserved_pages > len(self._free):
            problems.append("reservations exceed the free list")
        return problems
