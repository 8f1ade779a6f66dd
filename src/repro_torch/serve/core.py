"""EngineCore: the step-shaped device-dispatch layer of the serve stack
(port of the classic continuous-batching path of ``repro/serve/core.py``).

One public :meth:`EngineCore.step` performs exactly one scheduling
decision + at most one device dispatch (admit + whole-prompt prefill, or
one batched decode step) and returns structured :class:`TokenEvent`\\ s.
Requests move through::

    WAITING -> PREFILLING -> DECODING -> FINISHED
                                  \\-> PREEMPTED (-> WAITING)
    any live state -> CANCELLED

The device state (one paged cache per layer) is updated in place by each
dispatch. The engine clock advances by measured wall time around each
dispatch, which ends in the host fetch of the sampled tokens — the fetch
waits for the device, so the clock counts device time. Chunked prefill,
the prefix cache, run-ahead, speculative decoding, QoS and chaos come in
later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.cache_layout import PagedLayout
from repro_torch.models.registry import Model
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.utils import (
    cdiv, nearest_rank_pct, pow2_bucket, resolve_device,
)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0
    eos_id: int = -1              # -1 => never stop early
    seed: int = 0


def _sample(logits: torch.Tensor, gen: GenerationConfig,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy argmax at temperature <= 0; otherwise temperature scaling,
    top-k masking and Gumbel-max sampling (the categorical draw of the JAX
    engine). ``noise`` injects the Gumbel noise (tests feed both engines
    the same draws); else it is drawn from ``generator``."""
    if gen.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / gen.temperature
    if gen.top_k > 0:
        vals = torch.topk(logits, gen.top_k, dim=-1).values
        logits = torch.where(logits < vals[..., -1:],
                             torch.full_like(logits, -1e30), logits)
    if noise is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
        noise = -torch.log(-torch.log(u))
    return torch.argmax(logits + noise.to(logits.device), dim=-1).to(
        torch.int32)


# ---------------------------------------------------------------------------
# Request lifecycle states and the event taxonomy
# ---------------------------------------------------------------------------

WAITING = "waiting"          # submitted, not yet holding a slot
PREFILLING = "prefilling"    # slot assigned, context not yet encoded
DECODING = "decoding"        # prefill done, producing tokens
FINISHED = "finished"        # EOS / length limit; slot + pages released
PREEMPTED = "preempted"      # pages reclaimed under pressure; requeued
CANCELLED = "cancelled"      # caller cancelled; slot + pages released


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One observable engine transition, stamped with the engine clock.

    ``token`` is the sampled token for ``first_token``/``token`` events;
    for ``preempt`` it is the *retracted* token (never fed to the model,
    re-sampled on resume). ``ordinal`` is the token's 0-based index in
    the request's output stream."""

    kind: str
    rid: int
    t: float
    token: Optional[int] = None
    slot: int = -1
    ordinal: int = -1


class EngineCore:
    """Step-shaped continuous-batching core over per-layer paged caches.

    ``max_slots`` concurrent requests share ``num_pages`` pages of one
    quantization group each (default: fully provisioned). ``device``:
    the card unless named — with no GPU and no device named, construction
    raises. ``params`` must live on that device."""

    def __init__(self, model: Model, params: dict, *, max_slots: int = 4,
                 max_len: int = 256, num_pages: Optional[int] = None,
                 device=None):
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        g = model.cfg.quant.group_size
        pages_per_slot = cdiv(max_len, g)
        if num_pages is None:
            num_pages = max_slots * pages_per_slot
        self.layout = PagedLayout(page_size=g, num_pages=num_pages,
                                  slots=max_slots,
                                  pages_per_slot=pages_per_slot)
        self.reset()

    # --- session lifecycle ------------------------------------------------

    def reset(self, gen: Optional[GenerationConfig] = None) -> None:
        """Start a fresh session: new device state, scheduler, clock, RNG
        and metrics."""
        self.gen = gen if gen is not None else GenerationConfig()
        self.sched = Scheduler(self.layout)
        self.state = self.model.init_paged_state(self.layout, self.device)
        s = self.layout.slots
        self.clock = 0.0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.gen.seed)
        self._next_tok = np.zeros((s,), np.int32)
        self._lengths = np.zeros((s,), np.int64)
        self._eff_max: dict[int, int] = {}
        self._admit_seq: dict[int, int] = {}   # slot -> admission order
        self._n_admitted = 0
        self._arrivals: list[Request] = []     # sorted by arrival_time
        self.completed: list[Request] = []
        self.cancelled: list[Request] = []
        self._phase = "begin"
        # metrics
        self._util: list[float] = []
        self._active_hist: list[int] = []
        self._step_times: list[float] = []
        self._prefill_times: list[float] = []
        self.decode_steps = 0
        self.prefill_computed = 0   # prefill tokens run through the model

    # --- request intake ---------------------------------------------------

    def add_request(self, req: Request) -> int:
        """Enqueue ``req`` for admission at ``req.arrival_time`` on the
        engine clock (insertion-ordered among equal times). Rejects
        (ValueError) a context that can never fit one slot."""
        need = self.layout.pages_for(req.context_len + 1)
        if need > self.layout.pages_per_slot:
            raise ValueError(
                f"request {req.rid}: context {req.context_len} needs "
                f"{need} pages > pages_per_slot "
                f"{self.layout.pages_per_slot}")
        req.state = WAITING
        i = len(self._arrivals)
        while i > 0 and self._arrivals[i - 1].arrival_time > \
                req.arrival_time:
            i -= 1
        self._arrivals.insert(i, req)
        return req.rid

    def cancel(self, rid: int) -> list[TokenEvent]:
        """Cancel a request wherever it is; returns the ``cancel`` event
        ([] when ``rid`` is unknown or already finished). Host-side only:
        the slot's pages are decref'd and the slot is free at once."""
        for i, r in enumerate(self._arrivals):
            if r.rid == rid:
                del self._arrivals[i]
                return self._cancelled(r)
        summary = self.sched.cancel(rid)
        if summary is None:
            return []
        if summary.slot >= 0:
            self._eff_max.pop(rid, None)
        return self._cancelled(summary.req, summary.slot)

    def _cancelled(self, req: Request, slot: int = -1) -> list[TokenEvent]:
        req.state = CANCELLED
        req.t_done = self.clock
        self.cancelled.append(req)
        return [TokenEvent("cancel", req.rid, self.clock, slot=slot)]

    @property
    def has_work(self) -> bool:
        return bool(self._arrivals) or self.sched.has_work

    # --- width buckets ----------------------------------------------------

    def _decode_widths(self) -> list[int]:
        """Page-table width buckets of the decode step: powers of two
        capped at ``pages_per_slot``."""
        n = self.layout.pages_per_slot
        widths, w = [], 1
        while w < n:
            widths.append(w)
            w *= 2
        widths.append(n)
        return widths

    def _step_width(self, pages_needed: int) -> int:
        """Smallest width bucket covering ``pages_needed`` live pages: the
        decode step reads the table only up to it, so its cost follows the
        batch's live context, not the pool capacity."""
        for w in self._decode_widths():
            if w >= pages_needed:
                return w
        return self.layout.pages_per_slot

    def _bucket(self, prompt_len: int) -> int:
        return min(pow2_bucket(prompt_len, self.layout.page_size),
                   self.layout.tokens_per_slot)

    def _table(self, width: Optional[int] = None) -> torch.Tensor:
        t = self.sched.alloc.table(self.device)
        return t if width is None else t[:, :width]

    def warmup(self, prompt_lens: list[int]) -> None:
        """Run every prefill bucket of ``prompt_lens`` and every decode
        width once against throwaway state (kernel builds and library
        initialisation stay out of the measurements)."""
        state = self.model.init_paged_state(self.layout, self.device)
        row = self._table()[0]
        s = self.layout.slots
        for tp in sorted({self._bucket(t) for t in prompt_lens}):
            toks = torch.zeros((1, tp), dtype=torch.int64, device=self.device)
            logits, _ = self.model.prefill_paged(self.params, toks, state, 0,
                                                 row, tp)
            _sample(logits, self.gen, self._generator).cpu()
        for w in self._decode_widths():
            logits, _ = self.model.decode_paged(
                self.params, state,
                torch.zeros((s,), dtype=torch.int64, device=self.device),
                self._table(w),
                torch.zeros((s,), dtype=torch.bool, device=self.device))
            _sample(logits, self.gen, self._generator).cpu()

    # --- the step loop ----------------------------------------------------

    def step(self) -> list[TokenEvent]:
        """One scheduling decision + at most one device dispatch: admit
        (with its whole-prompt prefill) the next admissible request, or run
        one batched decode step over all decode-ready slots — or
        recompute-preempt the youngest admission when every slot stalls on
        a dry pool. Idle with scheduled arrivals jumps the clock; idle with
        no work returns ``[]``."""
        if self._phase == "begin":
            self._pump_arrivals()
            if not self.sched.has_work:
                if not self._arrivals:
                    return []   # fully idle: wait for add_request()
                # idle engine: jump the clock to the next arrival
                self.clock = max(self.clock, self._arrivals[0].arrival_time)
                self._pump_arrivals()
            self._phase = "admit"
        req = self.sched.admissible()
        if req is not None:
            return self._admit(req)
        if not self.sched.active:
            # nothing running and the queue head can't fit: wait for
            # arrivals (clock jump) or fail loudly
            self._phase = "begin"
            if self.sched.pending and self._arrivals:
                self.clock = max(self.clock, self._arrivals[0].arrival_time)
                return []
            if self.sched.pending:
                raise RuntimeError("pool cannot fit a single pending request "
                                   "(num_pages too small)")
            return []
        self._phase = "begin"   # decode (or preempt) ends the cycle
        return self._decode_step()

    def _pump_arrivals(self) -> None:
        while self._arrivals and \
                self._arrivals[0].arrival_time <= self.clock:
            self.sched.submit(self._arrivals.pop(0))

    def _admit(self, req: Request) -> list[TokenEvent]:
        """Assign a slot, reserve pages, prefill the whole context in one
        dispatch and sample the first token (a preempted request resumes
        by prefilling its full context)."""
        slot = self.sched.admit(req)
        req.state = PREFILLING
        self._admit_seq[slot] = self._n_admitted
        self._n_admitted += 1
        ctx_toks = req.context_tokens()
        tl = len(ctx_toks)
        self._eff_max[req.rid] = req.done_tokens + min(
            req.max_new_tokens - req.done_tokens,
            self.layout.tokens_per_slot - tl + 1)
        events = [TokenEvent("admit", req.rid, self.clock, slot=slot)]
        toks = np.zeros((1, self._bucket(tl)), np.int64)
        toks[0, :tl] = ctx_toks
        t0 = time.monotonic()
        logits, self.state = self.model.prefill_paged(
            self.params, torch.as_tensor(toks, device=self.device),
            self.state, slot, self._table()[slot], tl)
        # the host fetch waits for the device: the clock counts its time
        tok0 = int(_sample(logits, self.gen, self._generator).cpu()[0])
        dt = time.monotonic() - t0
        self.clock += dt
        self._prefill_times.append(dt)
        self.prefill_computed += tl
        return events + self._take_first_token(slot, tok0, tl)

    def _take_first_token(self, slot: int, tok0: int,
                          tl: int) -> list[TokenEvent]:
        """Record a request's first sampled token after its prefill."""
        req = self.sched.active[slot]
        req.state = DECODING
        first = req.t_first_token is None
        if req.t_admitted is None:
            req.t_admitted = req.t_first_token = self.clock
        req.out_tokens.append(tok0)
        self._next_tok[slot] = tok0
        self._lengths[slot] = tl
        # a preemption-resume re-prefill is not the stream's first token
        events = [TokenEvent("first_token" if first else "token",
                             req.rid, self.clock, token=tok0, slot=slot,
                             ordinal=req.done_tokens - 1)]
        if (self.gen.eos_id >= 0 and tok0 == self.gen.eos_id) or \
                req.done_tokens >= self._eff_max[req.rid]:
            events += self._finish(slot)
        return events

    def _finish(self, slot: int) -> list[TokenEvent]:
        req = self.sched.active[slot]
        req.state = FINISHED
        req.t_done = self.clock
        self._eff_max.pop(req.rid, None)
        self.completed.append(self.sched.finish(slot))
        return [TokenEvent("finish", req.rid, self.clock, slot=slot)]

    def _decode_step(self) -> list[TokenEvent]:
        """Batched decode over the non-stalled slots; recompute-preemption
        when every slot stalls on a dry pool."""
        sched = self.sched
        stalled = set(sched.ensure_pages(self._lengths))
        step_slots = [sl for sl in sched.active if sl not in stalled]
        if not step_slots:
            # every slot needs a page and the pool is dry: recompute-
            # preempt the most recent admission so the rest make progress
            victim = max(sched.active, key=self._admit_seq.__getitem__)
            vreq = sched.active[victim]
            if vreq.preemptions >= 64:
                raise RuntimeError(
                    "request thrashing on preemption — pool too small to "
                    "finish any request")
            retracted = vreq.out_tokens.pop() if vreq.out_tokens else None
            self._eff_max.pop(vreq.rid, None)
            sched.preempt(victim)
            vreq.state = PREEMPTED
            return [TokenEvent("preempt", vreq.rid, self.clock,
                               token=retracted, slot=victim)]
        return self._decode_dispatch(step_slots)

    def _decode_dispatch(self, step_slots: list[int]) -> list[TokenEvent]:
        """The one-token decode dispatch over ``step_slots``."""
        sched, g = self.sched, self.layout.page_size
        s = self.layout.slots
        mask = np.zeros((s,), bool)
        mask[step_slots] = True
        # width-slice the page table to the live pages of this step's
        # batch: the decode step then reads O(live tokens)
        w = self._step_width(
            max(int(self._lengths[sl]) // g + 1 for sl in step_slots))
        t0 = time.monotonic()
        logits, self.state = self.model.decode_paged(
            self.params, self.state,
            torch.as_tensor(self._next_tok.astype(np.int64),
                            device=self.device),
            self._table(w), torch.as_tensor(mask, device=self.device))
        # one host fetch per step; it waits for the device
        toks = _sample(logits, self.gen, self._generator).cpu().numpy()
        step_s = time.monotonic() - t0
        self.clock += step_s
        self.decode_steps += 1
        self._step_times.append(step_s)
        self._util.append(sched.utilization())
        self._active_hist.append(len(step_slots))

        events = []
        for sl in step_slots:
            self._lengths[sl] += 1
            req = sched.active[sl]
            t = int(toks[sl])
            req.out_tokens.append(t)
            self._next_tok[sl] = t
            events.append(TokenEvent("token", req.rid, self.clock, token=t,
                                     slot=sl, ordinal=req.done_tokens - 1))
            if (self.gen.eos_id >= 0 and t == self.gen.eos_id) or \
                    req.done_tokens >= self._eff_max[req.rid]:
                events += self._finish(sl)
        return events

    # --- session results --------------------------------------------------

    def events(self) -> Iterator[TokenEvent]:
        """Drive :meth:`step` until the engine has no work, yielding each
        event as it happens."""
        while self.has_work:
            yield from self.step()

    def result(self) -> dict:
        """Aggregate session metrics plus the completed request objects."""
        completed = self.completed
        total_tokens = sum(r.done_tokens for r in completed)
        lats = sorted(r.latency() for r in completed)
        ttfts = sorted((r.t_first_token or 0.0) - r.arrival_time
                       for r in completed)
        step_times = self._step_times
        cache_bytes = sum(
            t.numel() * t.element_size() for c in self.state
            for t in (c.key_codes, *c.key_scales.values(), c.key_residual,
                      c.value_fp, c.lengths))
        return {
            "requests": completed,
            "total_tokens": total_tokens,
            "wall_s": self.clock,
            "tokens_per_s": total_tokens / max(self.clock, 1e-9),
            "p50_latency_s": nearest_rank_pct(lats, 50),
            "p99_latency_s": nearest_rank_pct(lats, 99),
            "p50_ttft_s": nearest_rank_pct(ttfts, 50),
            "p99_ttft_s": nearest_rank_pct(ttfts, 99),
            "decode_steps": self.decode_steps,
            "decode_step_s_mean": float(np.mean(step_times)) if step_times
            else 0.0,
            "decode_step_s_p50": float(np.median(step_times)) if step_times
            else 0.0,
            "prefill_s_total": float(np.sum(self._prefill_times)),
            "prefills": len(self._prefill_times),
            "mean_active_slots": float(np.mean(self._active_hist))
            if self._active_hist else 0.0,
            "mean_page_utilization": float(np.mean(self._util))
            if self._util else 0.0,
            "cache_bytes": cache_bytes,
            "prefill_tokens_computed": self.prefill_computed,
            "cancelled_requests": self.cancelled,
            "n_cancelled": len(self.cancelled),
        }
