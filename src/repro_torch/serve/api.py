"""Streaming request API: the open-loop front door over
:class:`~repro_torch.serve.core.EngineCore` (port of
``repro/serve/api.py``).

The batch adapter (``engine.ContinuousBatchingEngine``) takes every
request up front and returns tokens when the whole batch drains.
:class:`StreamingEngine` inverts that: requests are **added while the
loop runs**, tokens stream out as :class:`~repro_torch.serve.core.
TokenEvent`\\ s the step they are sampled, and any request can be
**cancelled** mid-prefill or mid-decode — its pages are decref'd through
the scheduler (never freed under the prefix index's refcounts) and its
slot is reusable by the very next admission. Host-side only: every
device dispatch happens inside ``EngineCore.step()``.

Typical interactive use::

    eng = StreamingEngine(EngineCore(model, params, max_slots=4))
    rid = eng.add_request(prompt, max_new_tokens=64)
    for ev in eng.events():
        if ev.kind in ("first_token", "token"):
            emit(ev.rid, ev.token)          # per-token streaming
        elif ev.kind == "preempt":
            retract_last(ev.rid)            # ev.token was withdrawn; it
                                            # is re-sampled on resume
        if bored_of(ev.rid):
            eng.cancel(ev.rid)              # frees pages + slot next step

``events()`` ends when the engine runs out of work; calling it again
after more ``add_request()`` calls resumes the same session (same cache,
same prefix index, same clock).

**Run-ahead stream semantics** (``EngineCore(runahead=H)``, DESIGN.md
§18): in decode-bound stretches the core runs H decode micro-steps per
dispatch and emits that horizon's tokens when the block lands —
typically on the *next* ``step()`` call, so a single step may yield zero
events (the dispatch step) and the following one a burst. Horizon tokens
take the shape of a speculative span: per-token ordinals stay dense,
every token of a horizon shares one clock stamp with ``(span, span_ix)``
marking its position, and EOS/budget truncation happens before emission
— so ``check_event_stream`` and ``stream_latency_stats`` apply
unchanged. A ``cancel()`` arriving while a horizon is in flight lands
the block first: its token events are delivered ahead of the ``cancel``
event, never after it.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, Optional

import numpy as np

from repro_torch.serve.core import EngineCore, GenerationConfig, TokenEvent
from repro_torch.serve.scheduler import Request
from repro_torch.utils import nearest_rank_pct


class StreamingEngine:
    """Open-loop driver over an :class:`EngineCore`.

    ``core`` may be an ``EngineCore`` or anything exposing one as
    ``.core`` (e.g. a ``ContinuousBatchingEngine``). Construction starts a
    fresh session with ``gen`` as the sampling configuration."""

    def __init__(self, core, gen: Optional[GenerationConfig] = None):
        self.core: EngineCore = getattr(core, "core", core)
        self.core.reset(gen)
        self._next_rid = 0
        self._pending_events: deque[TokenEvent] = deque()

    # --- request intake ---------------------------------------------------

    def add_request(self, prompt, max_new_tokens: int = 32, *,
                    rid: Optional[int] = None,
                    arrival_time: Optional[float] = None,
                    tenant: str = "default",
                    ttft_deadline: float = 0.0) -> int:
        """Enqueue a prompt; returns its rid. ``arrival_time`` defaults to
        *now* on the engine clock (an open-loop caller never schedules the
        future; batch replays may). ``tenant`` and ``ttft_deadline`` feed
        QoS accounting and deadline shedding when the core has a
        :class:`~repro_torch.serve.qos.QosConfig` (ignored otherwise).
        With QoS bounded-queue backpressure, intake over a full queue
        never hangs silently: the request is rejected and an explicit
        ``reject`` event (``reason="queue_full"``) is queued for the next
        :meth:`step` / :meth:`events` pull."""
        if rid is None:
            rid = self._next_rid   # submit() advances the counter
        req = Request(
            rid=rid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=int(max_new_tokens),
            arrival_time=(self.core.clock if arrival_time is None
                          else float(arrival_time)),
            tenant=tenant, ttft_deadline=float(ttft_deadline))
        return self.submit(req)

    def submit(self, req: Request) -> int:
        """Enqueue a pre-built :class:`Request` (batch-replay path)."""
        self._next_rid = max(self._next_rid, req.rid) + 1
        rid = self.core.add_request(req)
        # intake-time QoS rejects surface ahead of any step's events
        self._pending_events.extend(self.core.take_intake_events())
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel ``rid`` wherever it is — queued, mid-prefill, or
        mid-decode. Pages are decref'd and the slot freed at once; the
        ``cancel`` event surfaces on the next :meth:`step` /
        :meth:`events` pull. An unknown rid (finished, already cancelled,
        shed or rejected by QoS) is a documented no-op returning False."""
        events = self.core.cancel(rid)
        self._pending_events.extend(events)
        return bool(events)

    # --- the event stream -------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self._pending_events) or self.core.has_work

    def step(self) -> list[TokenEvent]:
        """One engine step's worth of events (cancel events emitted
        between steps are delivered first, in order)."""
        events = list(self._pending_events)
        self._pending_events.clear()
        if self.core.has_work:
            events.extend(self.core.step())
        return events

    def events(self) -> Iterator[TokenEvent]:
        """Yield events until the engine has no work. Safe to re-enter:
        add more requests and iterate again to continue the session."""
        while self.has_work:
            yield from self.step()

    def result(self) -> dict:
        """Aggregate session metrics so far (see
        :meth:`EngineCore.result`)."""
        return self.core.result()


# ---------------------------------------------------------------------------
# Event-stream latency accounting
# ---------------------------------------------------------------------------


def stream_latency_stats(events: Iterable[TokenEvent],
                         requests: Iterable[Request]) -> dict:
    """Per-request TTFT and inter-token latency percentiles from a
    :class:`TokenEvent` stream.

    * **TTFT** — first *kept* token minus the request's ``arrival_time``.
      A ``preempt`` event retracts the rid's latest token; if that empties
      everything the client was shown, TTFT restarts at the post-resume
      token.
    * **ITL** — gaps between consecutive token-bearing events of the same
      request. Every token of a span (``TokenEvent.span``/``span_ix``: a
      run-ahead horizon retires several tokens from one dispatch) carries
      the same timestamp, so the intra-span gaps count as 0 — the client
      receives them together — and the gap to the *next* span carries
      the full dispatch latency. Gaps are clamped at zero.

    Returns ``{"ttft_s": {p50,p95,p99,mean,n}, "itl_s": {...}}`` (zeros
    when the stream is empty)."""
    arrival = {r.rid: r.arrival_time for r in requests}
    first_t: dict[int, float] = {}
    last_t: dict[int, float] = {}
    ntoks: dict[int, int] = {}
    ttft_by: dict[int, float] = {}
    itls: list[float] = []
    for ev in events:
        if ev.kind == "preempt" and ntoks.get(ev.rid, 0) > 0:
            ntoks[ev.rid] -= 1
            if ntoks[ev.rid] == 0:
                # the whole visible stream was retracted: the next token
                # is the client's real first byte again
                first_t.pop(ev.rid, None)
                last_t.pop(ev.rid, None)
                ttft_by.pop(ev.rid, None)
            continue
        if ev.kind not in ("first_token", "token"):
            continue
        ntoks[ev.rid] = ntoks.get(ev.rid, 0) + 1
        if ev.rid not in first_t:
            first_t[ev.rid] = ev.t
            if ev.rid in arrival:
                ttft_by[ev.rid] = ev.t - arrival[ev.rid]
        else:
            itls.append(max(ev.t - last_t[ev.rid], 0.0))
        last_t[ev.rid] = ev.t
    ttfts = list(ttft_by.values())

    def stats(vals: list[float]) -> dict:
        vals = sorted(vals)
        return {
            "p50": nearest_rank_pct(vals, 50),
            "p95": nearest_rank_pct(vals, 95),
            "p99": nearest_rank_pct(vals, 99),
            "mean": float(np.mean(vals)) if vals else 0.0,
            "n": len(vals),
        }

    return {"ttft_s": stats(ttfts), "itl_s": stats(itls)}


def check_event_stream(events: Iterable[TokenEvent]) -> dict:
    """Assert the event-stream invariants every engine session upholds:

    * per-rid token ordinals are **dense** — each kept token's ordinal is
      exactly (tokens emitted so far − tokens retracted by preempts);
    * at most one **terminal** event per rid (``finish``, ``cancel``,
      ``shed`` or ``reject``), with no event for that rid after it;
    * ``first_token`` happens once per rid;
    * timestamps are non-decreasing stream-wide;
    * the tokens of one span (``span > 1``) are consecutive events of
      their rid, ``span_ix`` running 0..span-1, all with one timestamp.

    Returns per-rid terminal kinds (``{rid: kind}``); raises
    AssertionError on any violation."""
    ntoks: dict[int, int] = {}
    seen_first: set[int] = set()
    terminal: dict[int, str] = {}
    open_span: dict[int, tuple[int, int, float]] = {}  # rid -> (span, ix, t)
    last_t = float("-inf")
    for ev in events:
        assert ev.t >= last_t, \
            f"timestamp regression at rid {ev.rid}: {ev.t} < {last_t}"
        last_t = ev.t
        if ev.rid in terminal:
            raise AssertionError(
                f"rid {ev.rid}: event {ev.kind!r} after terminal "
                f"{terminal[ev.rid]!r}")
        if ev.kind in ("first_token", "token"):
            if ev.kind == "first_token":
                assert ev.rid not in seen_first, \
                    f"rid {ev.rid}: duplicate first_token"
                seen_first.add(ev.rid)
            n = ntoks.get(ev.rid, 0)
            assert ev.ordinal == n, \
                f"rid {ev.rid}: ordinal {ev.ordinal} != dense {n}"
            ntoks[ev.rid] = n + 1
            assert 0 <= ev.span_ix < ev.span, \
                f"rid {ev.rid}: span_ix {ev.span_ix} outside span {ev.span}"
            if ev.span_ix == 0:
                open_span[ev.rid] = (ev.span, 0, ev.t)
            else:
                assert open_span.get(ev.rid) == (ev.span, ev.span_ix - 1,
                                                 ev.t), \
                    f"rid {ev.rid}: span token {ev.span_ix} of {ev.span} " \
                    "out of order or off its span's timestamp"
                open_span[ev.rid] = (ev.span, ev.span_ix, ev.t)
            if ev.span_ix == ev.span - 1:
                del open_span[ev.rid]
            continue
        assert ev.rid not in open_span, \
            f"rid {ev.rid}: {ev.kind!r} inside an unfinished span"
        if ev.kind == "preempt":
            if ntoks.get(ev.rid, 0) > 0:
                ntoks[ev.rid] -= 1   # the retracted token re-samples
        elif ev.kind in ("finish", "cancel", "shed", "reject"):
            terminal[ev.rid] = ev.kind
    return terminal
