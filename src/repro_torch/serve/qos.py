"""QoS layer: SLA-aware admission, per-tenant fairness, and graceful
degradation for the serving stack (DESIGN.md §16; port of
``repro/serve/qos.py``, which the port copies rather than imports).

Host-side only: no torch in this module. Everything here runs between
device dispatches and mutates nothing but its own counters; the scheduler
and :class:`~repro_torch.serve.core.EngineCore` consult it at three seams:

* **Admission order** — :meth:`QosState.admission_order` replaces the
  scheduler's FCFS head-of-queue poll with weighted fair queueing over
  pending requests: tenants are served in order of *attained weighted
  service* (committed tokens / weight), so a flooding tenant cannot
  starve a light one. Tenants over their token budget are skipped until
  their bucket refills.
* **Deadline shedding** — :meth:`QosState.unmeetable` flags pending
  requests whose TTFT deadline is already blown or unmeetable given the
  queue depth ahead of them and the measured prefill throughput
  (:class:`RateEstimator`). The engine sheds them with an explicit
  ``shed`` TokenEvent instead of spending prefill on a request whose
  client has already timed out.
* **Degradation** — :class:`DegradeController` watches pool pressure
  (page utilization + preemption events) and downshifts through discrete
  levels with hysteresis: cap the speculative draft length, shrink the
  per-cycle prefill budget, and (level 2+) evict index-only prefix pages
  *before* any live request has to be recompute-preempted. Each
  transition is counted and surfaced in ``result()["qos"]``.

``EngineCore(qos=None)`` takes none of these branches: its admission is
the FCFS engine's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class QosConfig:
    """Knobs for the QoS layer. The zero values disable each feature
    independently, so ``QosConfig()`` alone changes nothing but the
    admission *order* (and only when ``wfq`` is True and tenants
    differ)."""

    #: bound on queued requests (scheduled arrivals + pending); beyond it
    #: :meth:`EngineCore.add_request` rejects with a ``reject`` event
    #: instead of letting the queue grow without bound. 0 = unbounded.
    max_pending: int = 0
    #: session-default TTFT deadline (seconds from arrival) for requests
    #: that don't carry their own ``Request.ttft_deadline``. 0 = none.
    ttft_slo: float = 0.0
    #: per-tenant token-bucket refill rate (committed tokens / second of
    #: engine clock). 0 = budgets disabled.
    tenant_budget: float = 0.0
    #: bucket capacity; <= 0 defaults to two seconds of refill.
    tenant_burst: float = 0.0
    #: per-tenant WFQ weights (missing tenants weigh 1.0).
    weights: Mapping[str, float] = dataclasses.field(default_factory=dict)
    #: weighted-fair-queueing admission order (False = keep FCFS order,
    #: budgets/deadlines still apply).
    wfq: bool = True
    #: shed pending requests whose deadline is unmeetable.
    shed_late: bool = True
    #: enable the degradation controller.
    degrade: bool = True
    #: pool-pressure thresholds (page utilization) with hysteresis:
    #: ``hysteresis_up`` consecutive pressured cycles to downshift one
    #: level, ``hysteresis_down`` calm cycles to recover one level.
    pressure_hi: float = 0.92
    pressure_lo: float = 0.60
    hysteresis_up: int = 3
    hysteresis_down: int = 12
    max_level: int = 3

    def __post_init__(self):
        if self.max_pending < 0:
            raise ValueError("max_pending must be >= 0")
        if self.ttft_slo < 0 or self.tenant_budget < 0:
            raise ValueError("ttft_slo / tenant_budget must be >= 0")
        if not (0.0 <= self.pressure_lo <= self.pressure_hi <= 1.0):
            raise ValueError("need 0 <= pressure_lo <= pressure_hi <= 1")
        if self.hysteresis_up < 1 or self.hysteresis_down < 1:
            raise ValueError("hysteresis counts must be >= 1")
        if self.max_level < 1:
            raise ValueError("max_level must be >= 1")
        for t, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"weight for tenant {t!r} must be > 0")

    @property
    def burst(self) -> float:
        return (self.tenant_burst if self.tenant_burst > 0
                else 2.0 * self.tenant_budget)


class RateEstimator:
    """EWMA tokens/second estimator for the prefill path. Returns None
    until the first observation — deadline *projection* is disabled until
    the engine has measured real throughput (already-blown deadlines are
    still shed)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = float(alpha)
        self._rate: Optional[float] = None

    def observe(self, tokens: int, seconds: float) -> None:
        if tokens <= 0 or seconds <= 0:
            return
        r = tokens / seconds
        self._rate = (r if self._rate is None
                      else self.alpha * r + (1 - self.alpha) * self._rate)

    @property
    def rate(self) -> Optional[float]:
        return self._rate


class TenantState:
    """Accounting for one tenant: attained weighted service (the WFQ
    key) and the token bucket."""

    def __init__(self, name: str, weight: float, cfg: QosConfig):
        self.name = name
        self.weight = max(float(weight), 1e-9)
        self.cfg = cfg
        self.committed_tokens = 0    # admission-time commitments (WFQ key)
        self.served_tokens = 0       # tokens actually produced (metrics)
        self.admitted = 0
        self.shed = 0
        self.rejected = 0
        self.bucket = cfg.burst      # starts full
        self._last_refill = 0.0

    def refill(self, clock: float) -> None:
        if self.cfg.tenant_budget <= 0:
            return
        dt = max(clock - self._last_refill, 0.0)
        self._last_refill = clock
        self.bucket = min(self.bucket + dt * self.cfg.tenant_budget,
                          self.cfg.burst)

    def affording_clock(self, need: float, clock: float) -> float:
        """A clock after ``clock`` whose :meth:`refill` brings the bucket to
        ``need`` (the refill's own float operations, so it surely does).
        Used when ``clock + deficit / tenant_budget`` does not move the
        clock: a deficit left by a refill that fell an ulp short adds less
        than one ulp, a clock that does not move refills nothing, and an
        idle engine would jump to the same clock forever."""
        step = math.ulp(clock) if clock > 0 else 2.0 ** -52
        t = clock + step
        while self.bucket + max(t - self._last_refill, 0.0) \
                * self.cfg.tenant_budget < need:
            step *= 2.0
            t = clock + step
        return t

    def can_afford(self, cost: int) -> bool:
        """Bucket check for an admission of ``cost`` committed tokens. A
        cost larger than the whole bucket capacity is charged at capacity
        so oversized requests can't starve forever."""
        if self.cfg.tenant_budget <= 0:
            return True
        return self.bucket >= min(float(cost), self.cfg.burst)

    def charge(self, cost: int) -> None:
        self.committed_tokens += int(cost)
        if self.cfg.tenant_budget > 0:
            self.bucket -= min(float(cost), self.cfg.burst)

    @property
    def attained(self) -> float:
        return self.committed_tokens / self.weight


def request_cost(req) -> int:
    """Committed tokens an admission signs up for: the context that must
    be prefilled plus the output budget."""
    return int(req.context_len + req.max_new_tokens)


def effective_deadline(req, cfg: QosConfig) -> float:
    """Per-request TTFT deadline in seconds from arrival (0 = none):
    the request's own ``ttft_deadline`` wins over the session SLO."""
    d = getattr(req, "ttft_deadline", 0.0)
    return float(d) if d > 0 else cfg.ttft_slo


class QosState:
    """Mutable per-session QoS state: tenant accounts + admission logic.
    Owned by :class:`~repro_torch.serve.core.EngineCore`; the scheduler holds a
    reference and consults :meth:`admission_order`."""

    def __init__(self, cfg: QosConfig):
        self.cfg = cfg
        self.tenants: Dict[str, TenantState] = {}
        self.n_shed = 0
        self.n_rejected = 0

    def tenant(self, name: str) -> TenantState:
        ts = self.tenants.get(name)
        if ts is None:
            ts = TenantState(name, self.cfg.weights.get(name, 1.0),
                             self.cfg)
            self.tenants[name] = ts
        return ts

    def refill(self, clock: float) -> None:
        for ts in self.tenants.values():
            ts.refill(clock)

    # --- admission ---------------------------------------------------------

    def admission_order(self, pending: Sequence) -> List:
        """Pending requests in service order: weighted fair queueing by
        attained service (ties broken by queue position, i.e. arrival),
        with over-budget tenants filtered out until they refill. With
        ``wfq=False`` the FCFS order is kept and only the budget filter
        applies."""
        affordable = [r for r in pending
                      if self.tenant(r.tenant).can_afford(request_cost(r))]
        if not self.cfg.wfq:
            return affordable
        order = {id(r): i for i, r in enumerate(pending)}
        return sorted(affordable,
                      key=lambda r: (self.tenant(r.tenant).attained,
                                     order[id(r)]))

    def next_affordable_time(self, pending: Sequence,
                             clock: float) -> Optional[float]:
        """Earliest engine-clock time at which some pending request's
        tenant bucket will afford it, or None when there is nothing to
        wait for (budgets off, or a pending request is affordable right
        now — then the blocker is pages, not budget). The engine uses
        this to jump its simulated clock when the pool is otherwise
        idle: with no work running the clock — and therefore every
        bucket refill — would freeze, starving the queue forever. The
        time returned is always later than ``clock``; JAX's can equal it,
        and its engine then jumps to the same clock forever
        (:meth:`TenantState.affording_clock`)."""
        if self.cfg.tenant_budget <= 0:
            return None
        best = None
        for r in pending:
            ts = self.tenant(r.tenant)
            need = min(float(request_cost(r)), self.cfg.burst)
            deficit = need - ts.bucket
            if deficit <= 0:
                return None
            t = clock + deficit / self.cfg.tenant_budget
            if t <= clock:
                t = ts.affording_clock(need, clock)
            best = t if best is None else min(best, t)
        return best

    def on_admit(self, req) -> None:
        ts = self.tenant(req.tenant)
        ts.charge(request_cost(req))
        ts.admitted += 1

    def on_tokens(self, tenant: str, n: int) -> None:
        self.tenant(tenant).served_tokens += int(n)

    # --- deadline shedding -------------------------------------------------

    def unmeetable(self, pending: Sequence, clock: float,
                   prefill_rate: Optional[float],
                   inflight_tokens: int = 0) -> List[tuple]:
        """``(request, reason)`` pairs for pending requests whose TTFT
        deadline is already blown (``"deadline_blown"``), or provably
        unmeetable given the prefill work queued ahead of them at the
        measured prefill throughput (``"deadline_unmeetable"``). Walks
        the WFQ admission order, accumulating each survivor's context as
        backlog for the requests behind it; with no rate measurement yet
        the projection is disabled and only blown deadlines shed."""
        if not self.cfg.shed_late:
            return []
        doomed = []
        backlog = int(inflight_tokens)
        for req in self.admission_order(pending):
            deadline = effective_deadline(req, self.cfg)
            if deadline <= 0:
                backlog += req.context_len
                continue
            latest = req.arrival_time + deadline
            if clock >= latest:
                doomed.append((req, "deadline_blown"))
                continue
            if prefill_rate is not None and prefill_rate > 0:
                eta = clock + (backlog + req.context_len) / prefill_rate
                if eta > latest:
                    doomed.append((req, "deadline_unmeetable"))
                    continue
            backlog += req.context_len
        return doomed

    def on_shed(self, req) -> None:
        self.n_shed += 1
        self.tenant(req.tenant).shed += 1

    def on_reject(self, req) -> None:
        self.n_rejected += 1
        self.tenant(req.tenant).rejected += 1

    # --- introspection -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "shed": self.n_shed,
            "rejected": self.n_rejected,
            "tenants": {
                name: {
                    "weight": ts.weight,
                    "admitted": ts.admitted,
                    "shed": ts.shed,
                    "rejected": ts.rejected,
                    "committed_tokens": ts.committed_tokens,
                    "served_tokens": ts.served_tokens,
                    "bucket": ts.bucket,
                } for name, ts in sorted(self.tenants.items())
            },
        }


class DegradeController:
    """Discrete downshift levels with hysteresis. ``update()`` once per
    engine cycle with the pool pressure signal; the engine then reads the
    level's effects:

    ========  =====================================================
    level     effect (cumulative)
    ========  =====================================================
    0         nothing — full service
    1         speculative draft cap halved; prefill budget halved
    2         + proactively evict index-only prefix pages so every
              active slot keeps one page of headroom (shed *cache*
              before shedding *live work*)
    3         + speculation off (``spec_k -> 0``), prefill budget
              floored at one chunk per cycle
    ========  =====================================================

    A downshift needs ``hysteresis_up`` consecutive pressured cycles
    (utilization >= pressure_hi, or a recompute-preemption happened); a
    recovery needs ``hysteresis_down`` consecutive calm cycles
    (utilization <= pressure_lo and no preemption). The dead zone in
    between resets the pressure streak but does not count as calm, so
    the controller never oscillates on a noisy boundary."""

    def __init__(self, cfg: QosConfig):
        self.cfg = cfg
        self.level = 0
        self.peak_level = 0
        self.downshifts = 0
        self.recoveries = 0
        self.cycles_degraded = 0
        self._hot = 0
        self._calm = 0

    def update(self, utilization: float, preempted: bool) -> int:
        """One cycle's pressure observation; returns the (possibly new)
        level."""
        cfg = self.cfg
        if preempted or utilization >= cfg.pressure_hi:
            self._hot += 1
            self._calm = 0
        elif utilization <= cfg.pressure_lo:
            self._calm += 1
            self._hot = 0
        else:
            self._hot = 0
        if self._hot >= cfg.hysteresis_up and self.level < cfg.max_level:
            self.level += 1
            self.peak_level = max(self.peak_level, self.level)
            self.downshifts += 1
            self._hot = 0
        if self._calm >= cfg.hysteresis_down and self.level > 0:
            self.level -= 1
            self.recoveries += 1
            self._calm = 0
        if self.level > 0:
            self.cycles_degraded += 1
        return self.level

    def spec_k(self, base: int) -> int:
        """Cap on speculative drafts at the current level: halved per
        level, fully off (0) at level 3 — under the worst pressure a
        verify span must never contend for pages with live decode."""
        if self.level == 0:
            return base
        if self.level >= 3:
            return 0
        return max(base >> self.level, 0)

    def prefill_budget(self, base: int) -> int:
        """Per-cycle prefill token budget at the current level. The
        engine always runs at least one chunk per cycle when any budget
        remains, so even a floor of 1 keeps prefill live — just maximally
        deprioritized against decode."""
        return base if self.level == 0 else max(base >> self.level, 1)

    @property
    def evict_ahead(self) -> bool:
        return self.level >= 2

    def stats(self) -> dict:
        return {
            "level": self.level,
            "peak_level": self.peak_level,
            "downshifts": self.downshifts,
            "recoveries": self.recoveries,
            "cycles_degraded": self.cycles_degraded,
        }


# ---------------------------------------------------------------------------
# Goodput under SLA — the headline adversarial-benchmark metric
# ---------------------------------------------------------------------------


def goodput_under_sla(requests: Iterable, wall_s: float,
                      slo: float = 0.0) -> dict:
    """Deadline-met goodput over completed requests: tokens/s counting
    only requests whose TTFT (first token minus arrival) met their
    deadline (``Request.ttft_deadline``, falling back to ``slo``;
    requests with neither always count). Shed / rejected / unfinished
    requests contribute nothing — that is the point of the metric: work
    the client had already given up on is not goodput."""
    met = missed = 0
    good_tokens = 0
    for r in requests:
        deadline = getattr(r, "ttft_deadline", 0.0) or slo
        if r.t_first_token is None:
            missed += 1
            continue
        ttft = r.t_first_token - r.arrival_time
        if deadline > 0 and ttft > deadline:
            missed += 1
            continue
        met += 1
        good_tokens += r.done_tokens
    return {
        "goodput_tokens_per_s": good_tokens / max(wall_s, 1e-9),
        "good_tokens": good_tokens,
        "deadline_met_requests": met,
        "deadline_missed_requests": missed,
        "deadline_met_rate": met / max(met + missed, 1),
    }
