"""The device-dispatch layer of the serve stack (port of
``repro/serve/core.py``): :class:`ServeEngine`, the static-batching
engine over dense caches, and :class:`EngineCore`, the continuous-batching
core over paged caches (classic whole-prompt prefill, chunked prefill and
the shared-prefix page cache).

:class:`ServeEngine` runs one shared prefill and lock-step decode; the
sampled tokens stay on the device until the loop ends (no host
synchronisation per step), and prefill and decode are timed with a device
synchronise at their ends.

In :class:`EngineCore`, one public :meth:`EngineCore.step` performs
exactly one scheduling decision + at most one device dispatch (admit —
with its whole-prompt prefill in classic mode —, one prefill chunk, or
one batched decode step) and returns structured :class:`TokenEvent`\\ s.
Requests move through::

    WAITING -> PREFILLING -> DECODING -> FINISHED
                                  \\-> PREEMPTED (-> WAITING)
    any live state -> CANCELLED

The device state (one paged cache per layer) is updated in place by each
dispatch. The engine clock advances by measured wall time around each
dispatch, which ends in the host fetch of the sampled tokens — the fetch
waits for the device, so the clock counts device time. Run-ahead,
speculative decoding, QoS, chaos and the mesh come in later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import paged_cache as pgc
from repro_torch.core.cache_layout import PagedLayout, PrefixIndex
from repro_torch.models.registry import Model
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.utils import (
    cdiv, nearest_rank_pct, pow2_bucket, resolve_device, tree_bytes,
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Static batching: one shared prefill, lock-step decode; the whole
    batch runs until its last step. Runs on the card unless ``device``
    names another (``params`` must live there); with no GPU and no device
    named, construction raises."""

    def __init__(self, model: Model, params: dict, max_len: int,
                 device=None):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)

    def generate(self, batch: dict,
                 gen: Optional[GenerationConfig] = None) -> dict:
        """batch: {"tokens": (B, Tp) int}. Returns the generated tokens
        (B, max_new_tokens) as numpy, prefill and decode seconds, decode
        tokens/s and the cache's physical bytes (in all and per layer)."""
        gen = gen if gen is not None else GenerationConfig()
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        b, tp = tokens.shape
        # linear cache: prompt + appended tokens must fit (the last sampled
        # token is never appended, hence the -1)
        if tp + gen.max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt {tp} + max_new_tokens {gen.max_new_tokens} "
                f"exceeds cache capacity {self.max_len}")
        generator = torch.Generator(device=self.device)
        generator.manual_seed(gen.seed)
        state = self.model.init_decode_state(b, self.max_len, self.device)
        t0 = time.monotonic()
        logits, state = self.model.prefill(self.params, {"tokens": tokens},
                                           state)
        _sync(self.device)
        t_prefill = time.monotonic() - t0

        tok = _sample(logits, gen, generator)
        toks = [tok]
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        t0 = time.monotonic()
        for _ in range(gen.max_new_tokens - 1):
            logits, state = self.model.decode(self.params, state, tok)
            tok = _sample(logits, gen, generator)
            if gen.eos_id >= 0:
                done = done | (tok == gen.eos_id)
                tok = torch.where(done, torch.full_like(tok, gen.eos_id),
                                  tok)
            toks.append(tok)
        _sync(self.device)
        t_decode = time.monotonic() - t0
        n_dec = max(gen.max_new_tokens - 1, 1)
        return {
            "tokens": torch.stack(toks, dim=1).cpu().numpy(),
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_per_s": b * n_dec / max(t_decode, 1e-9),
            "cache_bytes": tree_bytes(state),
            "cache_bytes_per_layer": self.model.cache_layer_bytes(state),
        }


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
    raises. ``params`` must live on that device.

    ``prefill_chunk > 0`` prefills prompts in page-aligned chunks
    interleaved with decode steps, one chunk per cycle.
    ``prefix_cache=True`` (which implies a chunk of two pages when none is
    given) registers completed prompts' full-chunk pages in a
    :class:`PrefixIndex`; admissions that match adopt those pages and
    prefill only the tail (DESIGN.md §12). Page tables are width-sliced to
    pow2 live-page buckets."""

    def __init__(self, model: Model, params: dict, *, max_slots: int = 4,
                 max_len: int = 256, num_pages: Optional[int] = None,
                 prefix_cache: bool = False, prefill_chunk: int = 0,
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
        self.prefix_cache = bool(prefix_cache)
        chunk = int(prefill_chunk)
        if chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {chunk}")
        if self.prefix_cache and chunk == 0:
            chunk = 2 * g   # sharing requires the chunk-aligned path
        if chunk:
            chunk = cdiv(chunk, g) * g   # page-aligned chunks
            if not model.cfg.quant.codec.supports_paged_prefill:
                raise ValueError(
                    f"codec {model.cfg.quant.method!r} has no page-native "
                    "chunk prefill in this port")
        self.prefill_chunk = chunk
        self.reset()

    # --- session lifecycle ------------------------------------------------

    def reset(self, gen: Optional[GenerationConfig] = None) -> None:
        """Start a fresh session: new device state, scheduler, clock, RNG
        and metrics."""
        self.gen = gen if gen is not None else GenerationConfig()
        self.prefix = (PrefixIndex(self.layout, self.prefill_chunk)
                       if self.prefix_cache else None)
        self.sched = Scheduler(self.layout, prefix_index=self.prefix,
                               chunk_tokens=self.prefill_chunk)
        self.state = self.model.init_paged_state(self.layout, self.device)
        s = self.layout.slots
        self.clock = 0.0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.gen.seed)
        self._next_tok = np.zeros((s,), np.int32)
        self._lengths = np.zeros((s,), np.int64)
        self._eff_max: dict[int, int] = {}
        self._admit_seq: dict[int, int] = {}   # slot -> admission order
        self._prefilling: dict[int, dict] = {}  # slot -> {"ctx", "off"}
        self._n_admitted = 0
        self._arrivals: list[Request] = []     # sorted by arrival_time
        self.completed: list[Request] = []
        self.cancelled: list[Request] = []
        # cycle state: one cycle is the phase sequence begin -> admit* ->
        # prefill* -> decode, pumping arrivals and resetting the chunk
        # budget once per cycle (the JAX engine's replay order)
        self._phase = "begin"
        self._progressed = False
        self._budget_left = 0
        # metrics
        self._util: list[float] = []
        self._active_hist: list[int] = []
        self._step_times: list[float] = []
        self._prefill_times: list[float] = []
        self.decode_steps = 0
        self.prefill_computed = 0   # prefill tokens run through the model
        self.prefill_skipped = 0    # prefill tokens served from adoption
        self.cow_splits = 0

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
            self._prefilling.pop(summary.slot, None)
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

    def _prefill_widths(self, prompt_lens: list[int]) -> list[int]:
        """Table-row widths the chunk prefill runs at: the decode buckets
        up to the largest prompt's page count."""
        maxw = self._step_width(
            self.layout.pages_for(max(prompt_lens))
            if prompt_lens else self.layout.pages_per_slot)
        return [w for w in self._decode_widths() if w <= maxw]

    def _bucket(self, prompt_len: int) -> int:
        return min(pow2_bucket(prompt_len, self.layout.page_size),
                   self.layout.tokens_per_slot)

    def _table(self, width: Optional[int] = None) -> torch.Tensor:
        t = self.sched.alloc.table(self.device)
        return t if width is None else t[:, :width]

    def warmup(self, prompt_lens: list[int]) -> None:
        """Run every prefill bucket (or chunk width) of ``prompt_lens`` and
        every decode width once against throwaway state (kernel builds and
        library initialisation stay out of the measurements)."""
        state = self.model.init_paged_state(self.layout, self.device)
        row = self._table()[0]
        s = self.layout.slots
        if self.prefill_chunk:
            c = self.prefill_chunk
            toks = torch.zeros((1, c), dtype=torch.int64, device=self.device)
            for w in self._prefill_widths(prompt_lens):
                # a width-w row holds at most w pages of real tokens
                logits, _ = self.model.prefill_paged_chunk(
                    self.params, toks, state, 0, row[:w], 0,
                    min(c, w * self.layout.page_size))
                _sample(logits, self.gen, self._generator).cpu()
        else:
            for tp in sorted({self._bucket(t) for t in prompt_lens}):
                toks = torch.zeros((1, tp), dtype=torch.int64,
                                   device=self.device)
                logits, _ = self.model.prefill_paged(self.params, toks, state,
                                                     0, row, tp)
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
        """One scheduling decision + at most one device dispatch, in cycle
        priority order: admit the next admissible request (adopting prefix
        pages; classic mode also runs its whole-prompt prefill here), run
        one prefill chunk (chunked mode, under the cycle budget), or run
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
            self._progressed = False
            self._budget_left = self.prefill_chunk
            self._phase = "admit"

        if self._phase == "admit":
            req = self.sched.admissible()
            if req is not None:
                return self._admit(req)
            if not self.sched.active:
                # nothing running and the queue head can't fit: wait for
                # arrivals (clock jump) or fail loudly
                self._phase = "begin"
                if self.sched.pending and self._arrivals:
                    self.clock = max(self.clock,
                                     self._arrivals[0].arrival_time)
                    return []
                if self.sched.pending:
                    raise RuntimeError("pool cannot fit a single pending "
                                       "request (num_pages too small)")
                return []
            self._phase = "prefill"

        if self._phase == "prefill":
            if self._budget_left > 0 and self._prefilling:
                return self._prefill_one_chunk()
            self._phase = "decode"

        self._phase = "begin"   # decode (or preempt) ends the cycle
        return self._decode_step()

    def _pump_arrivals(self) -> None:
        while self._arrivals and \
                self._arrivals[0].arrival_time <= self.clock:
            self.sched.submit(self._arrivals.pop(0))

    def _admit(self, req: Request) -> list[TokenEvent]:
        """Assign a slot, adopt prefix hits, reserve pages. Chunked mode
        queues the context for interleaved chunk prefill; classic mode
        prefills the whole context in one dispatch and samples the first
        token (a preempted request resumes by prefilling its full
        context either way)."""
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
        if self.prefill_chunk:
            # adopted prefix pages skip their prefill compute; chunks
            # cover [prefix_hit_tokens, tl)
            self._prefilling[slot] = {"ctx": ctx_toks,
                                      "off": req.prefix_hit_tokens}
            self._lengths[slot] = req.prefix_hit_tokens
            self.prefill_skipped += req.prefix_hit_tokens
            return events
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

    def _prefill_one_chunk(self) -> list[TokenEvent]:
        """One prefill chunk for the oldest mid-prefill admission (FCFS);
        the slot joins the decode batch the step after its final chunk."""
        slot = min(self._prefilling, key=self._admit_seq.__getitem__)
        cur = self._prefilling[slot]
        ctx_toks, off = cur["ctx"], cur["off"]
        tl = len(ctx_toks)
        c = self.prefill_chunk
        clen = min(c, tl - off)
        toks = np.zeros((1, c), np.int64)
        toks[0, :clen] = ctx_toks[off:off + clen]
        # width-slice the row to the pages this chunk touches: the kernel
        # then reads O(live prefix), not O(capacity)
        row = self._table()[slot][:self._step_width(
            cdiv(off + clen, self.layout.page_size))]
        t0 = time.monotonic()
        logits, self.state = self.model.prefill_paged_chunk(
            self.params, torch.as_tensor(toks, device=self.device),
            self.state, slot, row, off, clen)
        self._progressed = True
        self._budget_left -= clen
        self.prefill_computed += clen
        cur["off"] = off + clen
        self._lengths[slot] = off + clen
        if cur["off"] >= tl:
            # final chunk: its last-token logits seed decode; the host
            # fetch waits for the device
            tok0 = int(_sample(logits, self.gen, self._generator).cpu()[0])
            dt = time.monotonic() - t0
            self.clock += dt
            self._prefill_times.append(dt)
            del self._prefilling[slot]
            self.sched.register_prefix(slot)
            return self._take_first_token(slot, tok0, tl)
        _sync(self.device)   # honest clock
        dt = time.monotonic() - t0
        self.clock += dt
        self._prefill_times.append(dt)
        return []

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
        """Batched decode over the non-stalled, fully prefilled slots;
        recompute-preemption when nothing can run and no chunk progressed
        this cycle."""
        sched, g = self.sched, self.layout.page_size
        if not sched.active:
            return []   # cancellation emptied the cycle mid-flight
        stalled = set(sched.ensure_pages(self._lengths,
                                         skip=self._prefilling.keys()))
        step_slots = [sl for sl in sched.active
                      if sl not in stalled and sl not in self._prefilling]

        # copy-on-write guard: never append into a shared page. Chunk-
        # aligned adoption makes this a no-op in steady state (adopted
        # pages all precede the write frontier), but it is the invariant
        # that keeps sharing safe under any adoption policy (DESIGN.md §12)
        if step_slots and (self.prefix_cache or self.cow_splits):
            safe = []
            for sl in step_slots:
                pidx = int(self._lengths[sl]) // g
                if pidx < sched.alloc.slot_pages(sl) and sched.alloc.refcount(
                        sched.alloc.page_at(sl, pidx)) > 1:
                    if not sched.alloc.can_alloc(1):
                        sched.reclaim(1)
                    if not sched.alloc.can_alloc(1):
                        continue   # no page to split into: stall a step
                    src, dst = sched.alloc.cow(sl, pidx)
                    self.state = self.model.copy_pages(self.state, src, dst)
                    self.cow_splits += 1
                safe.append(sl)
            step_slots = safe

        if not step_slots:
            if self._progressed:
                return []   # chunk prefill advanced; next cycle retries
            # every slot needs a page and the pool is dry: recompute-
            # preempt the most recent admission so the rest make progress
            victim = max(sched.active, key=self._admit_seq.__getitem__)
            vreq = sched.active[victim]
            if vreq.preemptions >= 64:
                raise RuntimeError(
                    "request thrashing on preemption — pool too small to "
                    "finish any request")
            # mid-prefill slots can't be victims: chunk work always
            # progresses when any exist, and progress skips this branch
            assert victim not in self._prefilling
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
        cache_bytes = tree_bytes(self.state)
        res = {
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
            # prefill dispatches: whole prompts, or chunks in chunked mode
            "prefill_s_total": float(np.sum(self._prefill_times)),
            "prefills": len(self._prefill_times),
            "mean_active_slots": float(np.mean(self._active_hist))
            if self._active_hist else 0.0,
            "mean_page_utilization": float(np.mean(self._util))
            if self._util else 0.0,
            "cache_bytes": cache_bytes,
            "prefill_chunk": self.prefill_chunk,
            "prefix_cache": self.prefix_cache,
            "prefill_tokens_computed": self.prefill_computed,
            "prefill_tokens_skipped": self.prefill_skipped,
            "prefix_hit_rate": self.prefill_skipped / max(
                self.prefill_skipped + self.prefill_computed, 1),
            "adopted_pages": self.sched.adopted_pages,
            "fresh_pages": self.sched.fresh_pages,
            "cow_splits": self.cow_splits,
            "cancelled_requests": self.cancelled,
            "n_cancelled": len(self.cancelled),
        }
        if self.prefix is not None:
            page_bytes = sum(pgc.pool_page_bytes(c) for c in self.state)
            res["pool_page_bytes"] = page_bytes
            res["prefix_pool_bytes_saved"] = \
                self.sched.adopted_pages * page_bytes
            res["prefix_index"] = {
                "entries": len(self.prefix), "queries": self.prefix.queries,
                "evictions": self.prefix.evictions,
            }
        return res
