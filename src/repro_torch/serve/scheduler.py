"""Continuous-batching scheduler state: requests, slots, page accounting
(port of ``repro/serve/scheduler.py`` for classic FCFS serving; prefix
adoption, QoS and speculative spans come in later slices).

Host-side only. Policies (vLLM-style FCFS):

* **Admission**: the head of the pending queue is admitted when a slot is
  free AND the pool can cover the pages for its context plus the first
  decoded token.
* **Decode paging**: when a slot's next token starts a new page, one page
  is allocated on demand; with the pool dry the slot *stalls* (left out
  of the step's active mask). If every slot stalls, the engine
  recompute-preempts the most recent admission.
* **Reclamation**: EOS / length-limit completion frees the slot and
  decrefs its pages.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.cache_layout import PageAllocator, PagedLayout


@dataclasses.dataclass
class Request:
    """One generation request (host-side bookkeeping)."""

    rid: int
    prompt: np.ndarray                  # (Tp,) int32
    max_new_tokens: int = 32
    arrival_time: float = 0.0           # engine-clock seconds

    # filled in by the engine
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    state: str = "waiting"              # EngineCore lifecycle (core.py)
    preemptions: int = 0
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
    """Report for a request leaving the scheduler early: ``slot`` is -1
    for a never-admitted request."""

    req: Request
    slot: int = -1


class Scheduler:
    """Slot + page bookkeeping for one engine."""

    def __init__(self, layout: PagedLayout):
        self.layout = layout
        self.alloc = PageAllocator(layout)
        self.free_slots: deque[int] = deque(range(layout.slots))
        self.active: dict[int, Request] = {}       # slot -> request
        self.pending: deque[Request] = deque()

    # --- admission -------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _fits(self, req: Request) -> bool:
        """Pages for the context plus the first decode append are free."""
        need = self.layout.pages_for(req.context_len + 1)
        if need > self.layout.pages_per_slot:
            raise ValueError(
                f"request {req.rid}: context {req.context_len} needs {need} "
                f"pages > pages_per_slot {self.layout.pages_per_slot}")
        return self.alloc.can_alloc(need)

    def admissible(self) -> Optional[Request]:
        """The pending head if it fits right now (FCFS: a head that does
        not fit blocks the queue)."""
        if not self.pending or not self.free_slots:
            return None
        req = self.pending[0]
        return req if self._fits(req) else None

    def admit(self, req: Request) -> int:
        """Assign a slot and allocate pages for the context plus the first
        decode token."""
        self._remove_pending(req)
        slot = self.free_slots.popleft()
        need = self.layout.pages_for(req.context_len + 1)
        ok = self.alloc.alloc(slot, need)
        assert ok, "admissible() guaranteed capacity"
        req.slot = slot
        self.active[slot] = req
        return slot

    def _remove_pending(self, req: Request) -> None:
        for i, r in enumerate(self.pending):
            if r is req:
                del self.pending[i]
                return
        raise AssertionError(f"request {req.rid} not pending")

    # --- decode-step paging ----------------------------------------------

    def ensure_pages(self, lengths: np.ndarray) -> list[int]:
        """Allocate next-page pages for slots about to cross a page
        boundary; returns slots that must stall this step (pool empty).
        ``lengths``: (slots,) current per-slot token counts — the next
        append writes at ``lengths[slot]``."""
        g = self.layout.page_size
        stalled = []
        for slot in self.active:
            pos = int(lengths[slot])
            if pos % g == 0 and self.alloc.slot_pages(slot) <= pos // g:
                if not self.alloc.alloc(slot, 1):
                    stalled.append(slot)
        return stalled

    # --- cancellation / completion ---------------------------------------

    def cancel(self, rid: int) -> Optional[CancelSummary]:
        """Cancel ``rid`` wherever the scheduler holds it; None when it is
        unknown (finished, cancelled or never submitted)."""
        for i, req in enumerate(self.pending):
            if req.rid == rid:
                del self.pending[i]
                return CancelSummary(req)
        for slot, req in self.active.items():
            if req.rid == rid:
                self.finish(slot)
                return CancelSummary(req, slot=slot)
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
        ``prompt + out_tokens``)."""
        req = self.finish(slot)
        req.preemptions += 1
        self.pending.appendleft(req)
        return req

    # --- introspection ---------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self.active or self.pending)

    def utilization(self) -> float:
        return self.alloc.utilization()
