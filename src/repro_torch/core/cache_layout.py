"""Cache layouts, the paged layout's host-side page allocator and the
shared-prefix page index (port of ``repro/core/cache_layout.py``).

A :class:`LinearLayout` places the dense cache's tokens at their absolute
positions. A :class:`RingLayout` places position ``pos`` at slot
``pos % capacity`` with capacity == the local-attention window, so a key
expires exactly when its value slot is overwritten.

A :class:`PagedLayout` is a pool of fixed-size pages shared by up to
``slots`` sequences; a per-slot page-table row maps group index -> pool
page. Page size equals the quantization group size, so one page holds one
key group plus its token-major value rows. Unassigned table entries point
at the pool's *scratch page* (index ``num_pages``), so masked lanes of
batched writes land there harmlessly.

Pages are refcounted (DESIGN.md §12): a page may be mapped into several
slots' table rows at once (shared-prefix reuse — the encoded bytes are
shared verbatim) and additionally referenced by the :class:`PrefixIndex`,
which keeps reclaimed prompt pages alive for future admissions. A page
returns to the free list only when its last reference drops; writers go
through :meth:`PageAllocator.cow` before mutating a page whose refcount
exceeds one.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict, deque

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LinearLayout:
    """Dense layout: absolute position == buffer slot. Requires
    ``length <= capacity`` at all times."""

    capacity: int

    def token_slot(self, pos):
        return pos

    def group_slot(self, gidx, ngroups: int):
        return gidx

    def prefill_offset(self, t: int) -> int:
        if t > self.capacity:
            raise ValueError(
                f"prompt length {t} exceeds linear capacity {self.capacity}")
        return 0

    def copy_segments(self, t: int) -> list[tuple[int, int, int]]:
        self.prefill_offset(t)
        return [(0, t, 0)]


@dataclasses.dataclass(frozen=True)
class RingLayout:
    """Sliding-window layout: slot ``pos % capacity``; capacity == window."""

    capacity: int

    def token_slot(self, pos):
        return pos % self.capacity

    def group_slot(self, gidx, ngroups: int):
        return gidx % ngroups

    def prefill_offset(self, t: int) -> int:
        return max(0, t - self.capacity)

    def copy_segments(self, t: int) -> list[tuple[int, int, int]]:
        return ring_segments(t, self.capacity)


def ring_segments(t: int, cap: int) -> list[tuple[int, int, int]]:
    """Static (src_lo, src_hi, dst_lo) copy segments mapping positions
    [max(0, t-cap), t) onto slots pos % cap. At most two segments."""
    start = max(0, t - cap)
    if start == 0:
        return [(0, t, 0)]
    p0 = -(-start // cap) * cap  # first position mapping to slot 0
    segs = []
    if p0 > start:
        segs.append((start, min(p0, t), start % cap))
    if t > p0:
        segs.append((p0, t, 0))
    return segs


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
    the device as an int32 tensor (:meth:`table`). Every mapping of a page
    into a slot's table row holds one reference, and external holders (the
    :class:`PrefixIndex`) take references through :meth:`incref`; a page
    is free iff its refcount is zero, so :meth:`free_slot` *decrefs*."""

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        self._free: deque[int] = deque(range(layout.num_pages))
        self._ref = np.zeros((layout.num_pages,), np.int32)
        self._table = np.full((layout.slots, layout.pages_per_slot),
                              layout.scratch_page, np.int32)
        self._owned: list[list[int]] = [[] for _ in range(layout.slots)]
        self._quarantined: list[int] = []

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

    def slot_page_ids(self, slot: int) -> list[int]:
        """The slot's owned pages in table-row order (copy)."""
        return list(self._owned[slot])

    def page_at(self, slot: int, idx: int) -> int:
        return self._owned[slot][idx]

    def can_alloc(self, count: int) -> bool:
        return len(self._free) >= count

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def incref(self, page: int) -> int:
        """Take an external reference on an *allocated* page (prefix-index
        pin). Returns the new count."""
        if not 0 <= page < self.layout.num_pages:
            raise ValueError(f"page {page} out of pool range")
        if self._ref[page] == 0:
            raise ValueError(f"incref on free page {page}")
        self._ref[page] += 1
        return int(self._ref[page])

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

    def adopt(self, slot: int, pages: list[int]) -> bool:
        """Map already-allocated ``pages`` into ``slot``'s table row at
        refcount+1 (shared-prefix hit: the encoded bytes are shared
        verbatim). All-or-nothing on row capacity; the pages must be live."""
        owned = self._owned[slot]
        if len(owned) + len(pages) > self.layout.pages_per_slot:
            return False
        for page in pages:
            self.incref(page)
            self._table[slot, len(owned)] = page
            owned.append(page)
        return True

    def cow(self, slot: int, idx: int) -> tuple[int, int] | None:
        """Copy-on-write split of ``slot``'s ``idx``-th page: when it is
        shared (refcount > 1), remap the row entry to a fresh page, drop the
        old reference and return ``(old, new)`` so the caller copies the
        pool bytes on the device before writing. None when the page is
        exclusively owned. Raises when the pool is dry."""
        page = self._owned[slot][idx]
        if self._ref[page] <= 1:
            return None
        if not self._free:
            raise RuntimeError("COW split with an empty pool")
        new = self._free.popleft()
        self._ref[new] = 1
        self._owned[slot][idx] = new
        self._table[slot, idx] = new
        self.decref(page)
        return page, new

    def free_slot(self, slot: int) -> int:
        """Drop ``slot``'s references; returns the number of pages whose
        last reference this was (i.e. actually reclaimed)."""
        n = 0
        for page in self._owned[slot]:
            # pages shared with other slots or pinned by the prefix index
            # survive with their encoded bytes intact
            if self.decref(page) == 0:
                n += 1
        self._owned[slot] = []
        self._table[slot, :] = self.layout.scratch_page
        return n

    def quarantine(self, count: int) -> int:
        """Pull up to ``count`` pages off the free list and pin them
        (refcount 1, mapped into no slot): the fault-injection form of pool
        exhaustion (DESIGN.md §16). A quarantined page is an external pin
        like a prefix-index pin, so every allocator invariant holds while
        it is held. Returns the number actually quarantined."""
        n = min(int(count), len(self._free))
        for _ in range(n):
            page = self._free.popleft()
            self._ref[page] = 1
            self._quarantined.append(page)
        return n

    def release_quarantine(self) -> int:
        """Return every quarantined page to the free list; returns the
        number released."""
        n = len(self._quarantined)
        for page in self._quarantined:
            self.decref(page)
        self._quarantined = []
        return n

    @property
    def quarantined_pages(self) -> int:
        return len(self._quarantined)

    def table(self, device=None) -> torch.Tensor:
        """(slots, pages_per_slot) int32 page table on ``device`` (the
        host copy when None)."""
        return torch.as_tensor(self._table.copy(), device=device)


# ---------------------------------------------------------------------------
# Shared-prefix page index
# ---------------------------------------------------------------------------


def token_page_hashes(tokens, page_size: int) -> list[bytes]:
    """Chain hashes of ``tokens``, one per *full* page: ``h[i]`` digests
    every token in ``[0, (i+1)*page_size)``, because a page's encoded bytes
    depend on the whole token prefix through the transformer. int32 tokens
    and a sha1 chain seeded with ``str(page_size)``: byte-equal to the JAX
    package's hashes."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: list[bytes] = []
    h = hashlib.sha1(str(page_size).encode())
    for i in range(len(toks) // page_size):
        h = h.copy()
        h.update(toks[i * page_size:(i + 1) * page_size].tobytes())
        out.append(h.digest())
    return out


class PrefixIndex:
    """Content-hash index over encoded prompt pages (DESIGN.md §12).

    Maps the chain hash of a token prefix (:func:`token_page_hashes`) to
    the pool page holding that group's encoded keys and value rows.
    Entries form a trie over chains: each records its parent hash, so
    eviction stays *leaf-first* and never strands reachable descendants.
    The index holds one allocator reference per entry (taken at
    :meth:`register`); under pool pressure :meth:`evict` drops
    least-recently-used leaf entries whose page has no other holder.

    Page bytes are deterministic in (token prefix, group size, prefill
    chunking), so an index serves one ``(page_size, chunk_tokens)`` pair.
    """

    def __init__(self, layout: PagedLayout, chunk_tokens: int = 0):
        self.layout = layout
        self.chunk_tokens = int(chunk_tokens)
        # hash -> (page, parent_hash | None); order == LRU (oldest first)
        self._entries: "OrderedDict[bytes, tuple[int, bytes | None]]" = \
            OrderedDict()
        self._children: dict[bytes, int] = {}   # hash -> live child count
        self.hits = 0
        self.queries = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages(self) -> list[int]:
        return [p for p, _ in self._entries.values()]

    def match(self, tokens, count: bool = True) -> list[int]:
        """Pages of the longest indexed prefix of ``tokens`` (whole pages,
        in position order; empty on a first-page miss). Touches matched
        entries for LRU recency; ``count=False`` skips the query/hit
        stats (repeated admission polls of the same queue head)."""
        return self.match_hashes(
            token_page_hashes(tokens, self.layout.page_size), count=count)

    def match_hashes(self, hashes: list[bytes],
                     count: bool = True) -> list[int]:
        """:meth:`match` on precomputed chain hashes; the page walk always
        runs against the live index (eviction may drop entries between
        polls)."""
        if count:
            self.queries += 1
        pages: list[int] = []
        for h in hashes:
            ent = self._entries.get(h)
            if ent is None:
                break
            pages.append(ent[0])
            self._entries.move_to_end(h)
        if count:
            self.hits += bool(pages)
        return pages

    def register(self, tokens, pages: list[int],
                 alloc: PageAllocator) -> int:
        """Index ``pages`` (the slot's table-row prefix) under the chain
        hashes of ``tokens``, taking one allocator reference per *newly*
        indexed page. Existing entries win (equal chain hash means
        bit-identical bytes). Returns the number of new entries."""
        new = 0
        parent: bytes | None = None
        for h, page in zip(token_page_hashes(tokens, self.layout.page_size),
                           pages):
            if h not in self._entries:
                alloc.incref(page)
                self._entries[h] = (page, parent)
                self._children.setdefault(h, 0)
                if parent is not None:
                    self._children[parent] += 1
                new += 1
            self._entries.move_to_end(h)
            parent = h
        return new

    def _drop(self, h: bytes, alloc: PageAllocator) -> None:
        page, parent = self._entries.pop(h)
        del self._children[h]
        if parent is not None and parent in self._children:
            self._children[parent] -= 1
        alloc.decref(page)
        self.evictions += 1

    def drop_all(self, alloc: PageAllocator) -> None:
        for h in list(self._entries):
            self._drop(h, alloc)

    def evict(self, alloc: PageAllocator, need: int,
              keep: set[int] | None = None) -> int:
        """Free up to ``need`` pages by dropping LRU *leaf* entries whose
        page has no holder besides the index (refcount == 1) and is not in
        ``keep`` (pages about to be adopted). Returns pages freed."""
        keep = keep or set()
        freed = 0
        while freed < need:
            victim = None
            for h, (page, _) in self._entries.items():   # oldest first
                if (self._children.get(h, 0) == 0 and page not in keep
                        and alloc.refcount(page) == 1):
                    victim = h
                    break
            if victim is None:
                break
            self._drop(victim, alloc)
            freed += 1
        return freed
