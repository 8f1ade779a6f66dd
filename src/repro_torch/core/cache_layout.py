"""Paged cache layout and its host-side page allocator (port of
``repro/core/cache_layout.py``; the shared-prefix index comes with the
prefix-cache slice).

A :class:`PagedLayout` is a pool of fixed-size pages shared by up to
``slots`` sequences; a per-slot page-table row maps group index -> pool
page. Page size equals the quantization group size, so one page holds one
key group plus its token-major value rows. Unassigned table entries point
at the pool's *scratch page* (index ``num_pages``), so masked lanes of
batched writes land there harmlessly.

Pages are refcounted: a page returns to the free list only when its last
reference drops.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """A pool of ``num_pages`` pages of ``page_size`` tokens shared by up to
    ``slots`` sequences, each owning at most ``pages_per_slot`` pages."""

    page_size: int
    num_pages: int       # allocatable pages (scratch page excluded)
    slots: int
    pages_per_slot: int

    @property
    def scratch_page(self) -> int:
        """Write target for masked-out lanes; never read unmasked."""
        return self.num_pages

    @property
    def pool_pages(self) -> int:
        """Physical pages to allocate: pool + one scratch page."""
        return self.num_pages + 1

    @property
    def tokens_per_slot(self) -> int:
        return self.pages_per_slot * self.page_size

    def pages_for(self, num_tokens: int) -> int:
        """Pages needed to hold ``num_tokens`` tokens of one sequence."""
        return -(-num_tokens // self.page_size)


class PageAllocator:
    """Host-side refcounting free-list allocator over a :class:`PagedLayout`.

    Mutates numpy state between device steps and ships the page table to
    the device as an int32 tensor (:meth:`table`)."""

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        self._free: deque[int] = deque(range(layout.num_pages))
        self._ref = np.zeros((layout.num_pages,), np.int32)
        self._table = np.full((layout.slots, layout.pages_per_slot),
                              layout.scratch_page, np.int32)
        self._owned: list[list[int]] = [[] for _ in range(layout.slots)]

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.layout.num_pages - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / max(self.layout.num_pages, 1)

    def slot_pages(self, slot: int) -> int:
        return len(self._owned[slot])

    def can_alloc(self, count: int) -> bool:
        return len(self._free) >= count

    def decref(self, page: int) -> int:
        """Drop one reference; the page returns to the free list when the
        count reaches zero. Returns the new count."""
        if self._ref[page] <= 0:
            raise ValueError(f"decref on free page {page} (double free)")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
        return int(self._ref[page])

    def alloc(self, slot: int, count: int = 1) -> bool:
        """Append ``count`` fresh pages (refcount 1) to ``slot``'s table
        row. All-or-nothing: returns False (state unchanged) when the pool
        or the slot's row can't fit them."""
        owned = self._owned[slot]
        if count > len(self._free):
            return False
        if len(owned) + count > self.layout.pages_per_slot:
            return False
        for _ in range(count):
            page = self._free.popleft()
            self._ref[page] = 1
            self._table[slot, len(owned)] = page
            owned.append(page)
        return True

    def free_slot(self, slot: int) -> int:
        """Drop ``slot``'s references; returns the number of pages whose
        last reference this was (i.e. actually reclaimed)."""
        n = 0
        for page in self._owned[slot]:
            if self.decref(page) == 0:
                n += 1
        self._owned[slot] = []
        self._table[slot, :] = self.layout.scratch_page
        return n

    def table(self, device=None) -> torch.Tensor:
        """(slots, pages_per_slot) int32 page table on ``device`` (the
        host copy when None)."""
        return torch.as_tensor(self._table.copy(), device=device)
