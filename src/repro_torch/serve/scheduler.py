"""Continuous-batching scheduler state: requests, slots, page accounting
(port of ``repro/serve/scheduler.py`` with prefix adoption, the
multi-token spans of run-ahead decode and QoS admission).

Host-side only. Policies (vLLM-style FCFS unless QoS is attached):

* **Admission**: the head of the pending queue is admitted when a slot is
  free AND the pool can cover the pages for its context plus the first
  decoded token. With a :class:`~repro_torch.serve.qos.QosState` the
  pending queue is walked in weighted-fair order instead (DESIGN.md §16)
  and the first request that fits is admitted. With a
  :class:`~repro_torch.core.cache_layout.PrefixIndex` attached, the
  context is first matched against indexed prompt pages:
  hits are *adopted* into the slot's table row at refcount+1 and only the
  remainder needs fresh pages — under pool pressure index-only pages are
  evicted to make room (DESIGN.md §12).
* **Decode paging**: when a slot's next token starts a new page, one page
  is allocated on demand; with the pool dry the slot *stalls* (left out
  of the step's active mask). If every slot stalls, the engine
  recompute-preempts the most recent admission. A run-ahead horizon
  reserves every page its span can touch up front.
* **Reclamation**: EOS / length-limit completion frees the slot and
  *decrefs* its pages — pages shared with other slots or pinned by the
  prefix index survive with their encoded bytes intact.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.cache_layout import (
    PageAllocator, PagedLayout, PrefixIndex, token_page_hashes,
)


@dataclasses.dataclass
class Request:
    """One generation request (host-side bookkeeping)."""

    rid: int
    prompt: np.ndarray                  # (Tp,) int32
    max_new_tokens: int = 32
    arrival_time: float = 0.0           # engine-clock seconds
    tenant: str = "default"             # QoS accounting bucket
    #: TTFT deadline in seconds from arrival (0 = fall back to the
    #: session's ``QosConfig.ttft_slo``; only enforced under QoS)
    ttft_deadline: float = 0.0

    # filled in by the engine
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    state: str = "waiting"              # EngineCore lifecycle (core.py)
    preemptions: int = 0
    prefix_hit_tokens: int = 0          # tokens adopted at the last admission
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def context_len(self) -> int:
        """Tokens the cache must hold at (re-)admission: the prompt plus
        everything already generated (recompute-preemption resumes by
        prefilling the whole context)."""
        return self.prompt_len + len(self.out_tokens)

    def context_tokens(self) -> np.ndarray:
        return np.concatenate(
            [np.asarray(self.prompt, np.int32),
             np.asarray(self.out_tokens, np.int32)])

    @property
    def done_tokens(self) -> int:
        return len(self.out_tokens)

    def latency(self) -> float:
        return (self.t_done or 0.0) - self.arrival_time


@dataclasses.dataclass(frozen=True)
class CancelSummary:
    """Report for a request leaving the scheduler early (cancel or QoS
    shed), one shape whether or not it was admitted: ``slot`` -1 and
    ``freed_pages`` 0 for a pending request; an active one reports the
    slot it released and the pages that actually returned to the free
    list (pages shared with other slots or pinned by the prefix index
    survive and are not counted)."""

    req: Request
    slot: int = -1
    was_active: bool = False
    freed_pages: int = 0


class Scheduler:
    """Slot + page bookkeeping for one engine.

    ``prefix_index`` (optional) enables shared-prefix page reuse;
    ``chunk_tokens`` is the engine's prefill chunk size — adoption is
    rounded *down* to chunk boundaries and always leaves at least the
    final chunk to recompute, which keeps a shared-prefix prefill
    bit-identical to the unshared chunked baseline and gives the engine
    live logits for the last prompt token (DESIGN.md §12).

    ``qos`` (optional, a :class:`~repro_torch.serve.qos.QosState`)
    replaces the head-of-queue admission poll with weighted fair queueing
    over the whole pending queue (budget-filtered, DESIGN.md §16); with
    ``qos=None`` admission is FCFS."""

    def __init__(self, layout: PagedLayout, *,
                 prefix_index: Optional[PrefixIndex] = None,
                 chunk_tokens: int = 0, qos=None):
        self.layout = layout
        self.alloc = PageAllocator(layout)
        self.prefix = prefix_index
        self.qos = qos
        self.chunk_tokens = int(chunk_tokens)
        self.free_slots: deque[int] = deque(range(layout.slots))
        self.active: dict[int, Request] = {}       # slot -> request
        self.pending: deque[Request] = deque()
        # prefix-reuse accounting (whole-run totals)
        self.adopted_pages = 0
        self.fresh_pages = 0
        self._last_query: tuple[int, int] = (-1, -1)
        self._hash_cache: tuple[int, int, list[bytes]] = (-1, -1, [])

    # --- admission -------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _adoptable(self, req: Request) -> list[int]:
        """Pages of ``req``'s context the prefix index can serve, rounded
        down to a prefill-chunk boundary and capped so the chunk holding
        the last context token is always recomputed. Always matched fresh
        against the live index (eviction may drop pages between polls);
        only the chain hashes and the hit/query stats are memoized per
        queue head."""
        if self.prefix is None or self.chunk_tokens <= 0:
            return []
        ctx_len = req.context_len
        g = self.layout.page_size
        c = self.chunk_tokens
        count = self._last_query != (req.rid, ctx_len)
        self._last_query = (req.rid, ctx_len)
        rid, clen, hashes = self._hash_cache
        if (rid, clen) != (req.rid, ctx_len):
            hashes = token_page_hashes(req.context_tokens(), g)
            self._hash_cache = (req.rid, ctx_len, hashes)
        hit = self.prefix.match_hashes(hashes, count=count)
        n_chunks = min((len(hit) * g) // c, (ctx_len - 1) // c)
        return hit[: n_chunks * c // g]

    def reclaim(self, need: int, keep: Optional[set[int]] = None) -> int:
        """Evict index-only pages (LRU, leaf-first) until ``need`` pages
        are free; returns pages actually freed."""
        if self.prefix is None or need <= 0:
            return 0
        return self.prefix.evict(self.alloc, need, keep=keep)

    def _fits(self, req: Request) -> bool:
        """Pages for the context plus the first decode append are free,
        after adopting prefix hits and evicting index-only pages."""
        need = self.layout.pages_for(req.context_len + 1)
        if need > self.layout.pages_per_slot:
            raise ValueError(
                f"request {req.rid}: context {req.context_len} needs {need} "
                f"pages > pages_per_slot {self.layout.pages_per_slot}")
        hits = self._adoptable(req)
        need -= len(hits)
        if not self.alloc.can_alloc(need):
            self.reclaim(need - self.alloc.free_pages, keep=set(hits))
        return self.alloc.can_alloc(need)

    def admissible(self) -> Optional[Request]:
        """Next pending request that fits right now. Without QoS: FCFS,
        head only (a head that does not fit blocks the queue). With QoS:
        the pending queue in weighted-fair order (over-budget tenants
        filtered), the first request that fits."""
        if not self.pending or not self.free_slots:
            return None
        if self.qos is None:
            req = self.pending[0]
            return req if self._fits(req) else None
        for req in self.qos.admission_order(self.pending):
            if self._fits(req):
                return req
        return None

    def admit(self, req: Request) -> int:
        """Assign a slot; adopt prefix-hit pages (refcount+1) and allocate
        fresh pages for the rest of the context plus the first decode
        token. The caller prefills from ``req.prefix_hit_tokens`` on."""
        self._remove_pending(req)
        slot = self.free_slots.popleft()
        hits = self._adoptable(req)
        need = self.layout.pages_for(req.context_len + 1) - len(hits)
        if hits:
            ok = self.alloc.adopt(slot, hits)
            assert ok, "admissible() checked row capacity"
        ok = self.alloc.alloc(slot, need)
        assert ok, "admissible() guaranteed capacity"
        self.adopted_pages += len(hits)
        self.fresh_pages += need
        if self.qos is not None:
            self.qos.on_admit(req)
        req.prefix_hit_tokens = len(hits) * self.layout.page_size
        self._last_query = (-1, -1)
        req.slot = slot
        self.active[slot] = req
        return slot

    def _remove_pending(self, req: Request) -> None:
        for i, r in enumerate(self.pending):
            if r is req:
                del self.pending[i]
                return
        raise AssertionError(f"request {req.rid} not pending")

    def register_prefix(self, slot: int) -> int:
        """Index the slot's *prompt* pages once its prefill completed (full
        prefill chunks only — trailing pages are never adopted). The index
        increfs each newly registered page, keeping it alive past EOS."""
        if self.prefix is None or self.chunk_tokens <= 0:
            return 0
        req = self.active[slot]
        g = self.layout.page_size
        n_pages = (req.prompt_len // self.chunk_tokens) * \
            (self.chunk_tokens // g)
        if n_pages <= 0:
            return 0
        pages = self.alloc.slot_page_ids(slot)[:n_pages]
        return self.prefix.register(np.asarray(req.prompt, np.int32), pages,
                                    self.alloc)

    # --- decode-step paging ----------------------------------------------

    def ensure_pages(self, lengths: np.ndarray, skip: Iterable[int] = (),
                     spans: Optional[dict] = None) -> list[int]:
        """Allocate next-page pages for slots about to cross a page
        boundary; returns slots that must stall this step (pool empty even
        after evicting index-only pages).

        ``lengths``: (slots,) current per-slot token counts — the next
        append writes at ``lengths[slot]``. ``skip``: slots to leave alone
        (mid-prefill slots, whose pages were reserved at admission).
        ``spans``: optional slot -> tokens the next dispatch may append
        (>= 1; a run-ahead horizon). Without it — or for span 1 — this is
        the one-token rule. A wider span asks for every page covering
        ``[pos, pos + span)``; under a dry pool the trailing pages are
        shed one at a time, and the slot only stalls when even its first
        append position has no page."""
        g = self.layout.page_size
        skip = set(skip)
        stalled = []
        for slot in self.active:
            if slot in skip:
                continue
            pos = int(lengths[slot])
            span = min(spans.get(slot, 1) if spans else 1,
                       self.layout.tokens_per_slot - pos)
            if span <= 1:
                if pos % g == 0 and self.alloc.slot_pages(slot) <= pos // g:
                    if not self.alloc.can_alloc(1):
                        self.reclaim(1)
                    if not self.alloc.alloc(slot, 1):
                        stalled.append(slot)
                continue
            want = self.layout.pages_for(pos + span)
            need_min = self.layout.pages_for(pos + 1)
            while self.alloc.slot_pages(slot) < want:
                n = want - self.alloc.slot_pages(slot)
                if not self.alloc.can_alloc(n):
                    self.reclaim(n)
                if self.alloc.alloc(slot, n):
                    break
                if want <= need_min:
                    break
                want -= 1
            if self.alloc.slot_pages(slot) < need_min:
                stalled.append(slot)
        return stalled

    # --- cancellation / completion ---------------------------------------

    def cancel(self, rid: int) -> Optional[CancelSummary]:
        """Cancel ``rid`` wherever the scheduler holds it; None when it is
        unknown (finished, cancelled or never submitted). An active slot
        is released through :meth:`finish`, so its pages are *decref'd*.
        Both admission memos are invalidated: a later request may reuse
        the rid (and its context length)."""
        for i, req in enumerate(self.pending):
            if req.rid == rid:
                del self.pending[i]
                self._last_query = (-1, -1)
                self._hash_cache = (-1, -1, [])
                return CancelSummary(req)
        for slot, req in self.active.items():
            if req.rid == rid:
                self._last_query = (-1, -1)
                self._hash_cache = (-1, -1, [])
                free_before = self.alloc.free_pages
                self.finish(slot)
                return CancelSummary(
                    req, slot=slot, was_active=True,
                    freed_pages=self.alloc.free_pages - free_before)
        return None

    def finish(self, slot: int) -> Request:
        req = self.active.pop(slot)
        self.alloc.free_slot(slot)
        self.free_slots.append(slot)
        req.slot = -1
        return req

    def preempt(self, slot: int) -> Request:
        """Recompute-preemption: free the slot and its pages, requeue the
        request at the head of the pending queue (resuming prefills
        ``prompt + out_tokens``; with a prefix index its prompt pages
        usually survive and are re-adopted)."""
        req = self.finish(slot)
        req.preemptions += 1
        self.pending.appendleft(req)
        return req

    # --- introspection ---------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.active or self.pending)

    @property
    def num_active(self) -> int:
        return len(self.active)

    def utilization(self) -> float:
        return self.alloc.utilization()
