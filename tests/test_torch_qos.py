"""Port of ``tests/test_qos.py`` (DESIGN.md §16): weighted fair queueing,
tenant token budgets, TTFT-deadline shedding, bounded-queue backpressure
and graceful degradation, case by case against ``repro_torch.serve.qos``
and the port's scheduler and engine (on the CPU).

The policy classes are held to the JAX package's on the same inputs.
Decisions that read the engine clock (shedding, bucket refills) are
tested on the host classes with explicit clocks, or on the port's engine
alone: the clock is measured compute time, which differs between the two
engines. The clock-independent engine cases — a default ``QosConfig``,
weighted tenants without deadlines and rejects at ``max_pending``, all
arriving as a burst — give JAX's greedy streams and event sequences."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import QosConfig as JQosConfig  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import StreamingEngine as JStreaming  # noqa: E402
from repro.serve import qos as jqos  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core.cache_layout import PagedLayout  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, QosConfig, Request,
    Scheduler, StreamingEngine, check_event_stream, goodput_under_sla,
)
from repro_torch.serve.core import REJECTED, SHED  # noqa: E402
from repro_torch.serve.qos import (  # noqa: E402
    DegradeController, QosState, RateEstimator, request_cost,
)
from repro_torch.weights import params_from_jax  # noqa: E402
from test_prefix_cache import check_alloc_invariants  # noqa: E402


@pytest.fixture(scope="module")
def smoke_model():
    """(JAX model, JAX params, port cfg, port model, port params): the
    smoke tinyllama on the page-native backends, weights carried over."""
    jcfg = dataclasses.replace(j_reduce(j_get_config("tinyllama-1.1b")),
                               decode_backend="paged_fused",
                               prefill_backend="paged_fused")
    jm = j_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, cfg, get_model(cfg), tp


def _req(rid, *, plen=8, tenant="default", arrival=0.0, deadline=0.0,
         max_new=4, cls=Request):
    return cls(rid=rid, prompt=np.arange(plen, dtype=np.int32),
               max_new_tokens=max_new, arrival_time=arrival,
               tenant=tenant, ttft_deadline=deadline)


def _engine(smoke_model, **kw):
    _, _, _, tm, tp = smoke_model
    return ContinuousBatchingEngine(tm, tp, device="cpu", **kw)


def _events(out):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token, e.reason)
            for e in out["events"]]


def _toks(out):
    return {r.rid: list(r.out_tokens) for r in out["requests"]}


def _qos_counts(res):
    """``result()["qos"]`` without what the engine clock sets (the prefill
    rate estimate)."""
    q = dict(res["qos"])
    q.pop("prefill_rate_est")
    return q


# --- config + primitives ---------------------------------------------------


def test_qos_config_validation():
    with pytest.raises(ValueError):
        QosConfig(max_pending=-1)
    with pytest.raises(ValueError):
        QosConfig(ttft_slo=-0.5)
    with pytest.raises(ValueError):
        QosConfig(pressure_hi=0.5, pressure_lo=0.9)
    with pytest.raises(ValueError):
        QosConfig(weights={"a": 0.0})
    cfg = QosConfig(tenant_budget=100.0)
    assert cfg.burst == 200.0          # default burst = 2x budget
    assert QosConfig(tenant_budget=100.0, tenant_burst=50.0).burst == 50.0
    assert [f.name for f in dataclasses.fields(QosConfig)] == \
        [f.name for f in dataclasses.fields(JQosConfig)]
    assert dataclasses.asdict(QosConfig()) == dataclasses.asdict(JQosConfig())


def test_rate_estimator_ewma():
    est, jest = RateEstimator(), jqos.RateEstimator()
    assert est.rate is None            # no projection before any sample
    for tokens, secs in ((100, 1.0), (300, 1.0), (0, 0.0), (70, 0.3)):
        est.observe(tokens, secs)
        jest.observe(tokens, secs)
        assert est.rate == jest.rate
    est2 = RateEstimator()
    est2.observe(100, 1.0)
    assert est2.rate == pytest.approx(100.0)
    est2.observe(300, 1.0)             # EWMA pulls toward the new sample
    assert 100.0 < est2.rate < 300.0


def test_token_bucket_budget_and_burst():
    st = QosState(QosConfig(tenant_budget=100.0))
    ts = st.tenant("a")
    assert ts.can_afford(150)          # bucket starts full (= burst 200)
    ts.charge(180)
    assert not ts.can_afford(150)      # 20 left, cost 150 > bucket
    st.refill(1.0)                     # +100 tokens after 1s engine time
    assert ts.can_afford(100)
    assert ts.bucket == pytest.approx(120.0)
    # a cost above burst is payable at a full bucket (min(cost, burst)):
    # one giant request must not starve forever
    big = QosState(QosConfig(tenant_budget=10.0))
    assert big.tenant("b").can_afford(10_000)


def test_wfq_admission_order_least_attained_first():
    st = QosState(QosConfig(weights={"heavy": 1.0, "light": 1.0}))
    st.tenant("heavy").committed_tokens = 1000
    pending = [_req(0, tenant="heavy"), _req(1, tenant="heavy"),
               _req(2, tenant="light")]
    order = st.admission_order(pending)
    assert [r.rid for r in order] == [2, 0, 1]   # light first, FCFS ties
    # weights scale attained service: heavy at weight 4 halves back in
    st2 = QosState(QosConfig(weights={"heavy": 4.0}))
    st2.tenant("heavy").committed_tokens = 100
    st2.tenant("light").committed_tokens = 100
    order2 = st2.admission_order([_req(0, tenant="heavy"),
                                  _req(1, tenant="light")])
    assert [r.rid for r in order2] == [0, 1]     # 100/4 < 100/1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_state_matches_jax_on_a_random_stream(seed):
    """QosState and DegradeController against JAX's on one random stream
    of admissions, tokens, refills at explicit clocks, shed/reject calls
    and pressure observations: the same orders, doomed lists, next
    affordable times, levels and stats."""
    rng = np.random.default_rng(seed)
    cfg = dict(tenant_budget=50.0, ttft_slo=0.5, weights={"b": 2.0},
               pressure_hi=0.8, pressure_lo=0.4, hysteresis_up=2,
               hysteresis_down=3)
    st, jst = QosState(QosConfig(**cfg)), jqos.QosState(JQosConfig(**cfg))
    dc = DegradeController(QosConfig(**cfg))
    jdc = jqos.DegradeController(JQosConfig(**cfg))
    clock = 0.0
    for step in range(40):
        clock += float(rng.uniform(0, 0.3))
        reqs = [(int(rng.integers(0, 1000)), str(rng.choice(["a", "b", "c"])),
                 int(rng.integers(4, 80)), float(rng.uniform(0, clock)),
                 float(rng.choice([0.0, 0.2, 1.0])))
                for _ in range(int(rng.integers(1, 6)))]
        mk = lambda cls: [cls(rid=r, prompt=np.arange(n, dtype=np.int32),  # noqa: E731
                              max_new_tokens=3, arrival_time=a, tenant=t,
                              ttft_deadline=d) for r, t, n, a, d in reqs]
        ours, theirs = mk(Request), mk(JRequest)
        st.refill(clock)
        jst.refill(clock)
        assert [r.rid for r in st.admission_order(ours)] == \
            [r.rid for r in jst.admission_order(theirs)]
        assert st.next_affordable_time(ours, clock) == \
            jst.next_affordable_time(theirs, clock)
        rate = None if step < 3 else float(rng.uniform(50, 500))
        assert [(r.rid, why) for r, why in st.unmeetable(ours, clock, rate,
                                                         7)] == \
            [(r.rid, why) for r, why in jst.unmeetable(theirs, clock, rate,
                                                       7)]
        a, ja = ours[0], theirs[0]
        for state, r in ((st, a), (jst, ja)):
            state.on_admit(r)
            state.on_tokens(r.tenant, 3)
            if step % 5 == 0:
                state.on_shed(r)
            if step % 7 == 0:
                state.on_reject(r)
        util, pre = float(rng.uniform(0, 1)), bool(rng.random() < 0.1)
        assert dc.update(util, pre) == jdc.update(util, pre)
        assert dc.spec_k(8) == jdc.spec_k(8)
        assert dc.prefill_budget(64) == jdc.prefill_budget(64)
        assert dc.evict_ahead == jdc.evict_ahead
    assert st.stats() == jst.stats()
    assert dc.stats() == jdc.stats()


def test_budget_filter_excludes_broke_tenants():
    st = QosState(QosConfig(tenant_budget=10.0))
    st.tenant("broke").bucket = 0.0
    pending = [_req(0, tenant="broke"), _req(1, tenant="flush")]
    assert [r.rid for r in st.admission_order(pending)] == [1]


def test_scheduler_wfq_vs_fcfs():
    lay = PagedLayout(page_size=4, num_pages=16, slots=2, pages_per_slot=4)
    heavy_first = [_req(0, tenant="heavy"), _req(1, tenant="light")]
    # FCFS (qos=None): strictly head-of-queue
    s0 = Scheduler(lay)
    for r in heavy_first:
        s0.submit(r)
    assert s0.admissible().rid == 0
    # WFQ: the starved light tenant jumps the queue
    st = QosState(QosConfig())
    st.tenant("heavy").committed_tokens = 500
    s1 = Scheduler(lay, qos=st)
    for r in [_req(0, tenant="heavy"), _req(1, tenant="light")]:
        s1.submit(r)
    got = s1.admissible()
    assert got.rid == 1
    slot = s1.admit(got)                  # non-head admit must not corrupt
    assert s1.active[slot].rid == 1
    assert [r.rid for r in s1.pending] == [0]
    assert st.tenant("light").committed_tokens == request_cost(got)
    check_alloc_invariants(s1.alloc)


def test_unmeetable_projection_and_blown_deadlines():
    st = QosState(QosConfig(ttft_slo=1.0))
    # blown: clock already past arrival + deadline (no rate needed)
    blown = _req(0, arrival=0.0, deadline=1.0)
    doomed = st.unmeetable([blown], clock=2.0, prefill_rate=None)
    assert [(r.rid, why) for r, why in doomed] == [(0, "deadline_blown")]
    # projection: 3 requests x 100-token contexts at 100 tok/s; the
    # third's ETA = (backlog 200 + own 100)/100 = 3s > its 1s deadline
    reqs = [_req(i, plen=100, arrival=0.0, deadline=10.0 if i < 2 else 1.0)
            for i in range(3)]
    doomed = st.unmeetable(reqs, clock=0.0, prefill_rate=100.0)
    assert [(r.rid, why) for r, why in doomed] == \
        [(2, "deadline_unmeetable")]
    # without a rate measurement the projection is disabled
    assert st.unmeetable(reqs, clock=0.0, prefill_rate=None) == []
    # shed_late=False disables shedding entirely
    off = QosState(QosConfig(ttft_slo=1.0, shed_late=False))
    assert off.unmeetable([blown], clock=2.0, prefill_rate=None) == []


def test_degrade_hysteresis_and_knobs():
    cfg = QosConfig(pressure_hi=0.9, pressure_lo=0.5,
                    hysteresis_up=3, hysteresis_down=4)
    d = DegradeController(cfg)
    for _ in range(2):                      # 2 hot cycles: not enough
        assert d.update(0.95, False) == 0
    assert d.update(0.95, False) == 1       # 3rd consecutive: downshift
    assert d.spec_k(8) == 4 and d.prefill_budget(64) == 32
    assert not d.evict_ahead
    for _ in range(3):
        d.update(0.95, False)
    assert d.level == 2 and d.evict_ahead   # sustained: next level
    # the dead zone (between lo and hi) resets the hot streak but is not
    # calm — the level holds
    d.update(0.7, False)
    assert d.level == 2
    for _ in range(3):
        assert d.update(0.2, False) == 2    # calm, but < hysteresis_down
    assert d.update(0.2, False) == 1        # 4th calm cycle: recover
    # a preemption is pressure regardless of utilization
    d2 = DegradeController(cfg)
    for _ in range(3):
        d2.update(0.0, True)
    assert d2.level == 1
    # level 3 turns speculation off and floors the budget
    d3 = DegradeController(cfg)
    for _ in range(9):
        d3.update(1.0, False)
    assert d3.level == 3
    assert d3.spec_k(8) == 0 and d3.prefill_budget(4) == 1
    assert d3.stats()["downshifts"] == 3


def test_goodput_under_sla_metric():
    met = _req(0, deadline=1.0)
    met.t_first_token, met.out_tokens = 0.5, [1, 2, 3]
    late = _req(1, arrival=0.0, deadline=1.0)
    late.t_first_token, late.out_tokens = 2.0, [1, 2, 3, 4]
    never = _req(2, deadline=1.0)           # no first token at all
    g = goodput_under_sla([met, late, never], wall_s=2.0)
    assert g["good_tokens"] == 3 and g["deadline_met_requests"] == 1
    assert g["deadline_missed_requests"] == 2
    assert g["goodput_tokens_per_s"] == pytest.approx(1.5)
    assert g == jqos.goodput_under_sla([met, late, never], wall_s=2.0)
    # no deadline anywhere: everything completed counts
    free = _req(3)
    free.t_first_token, free.out_tokens = 5.0, [1]
    assert goodput_under_sla([free], 1.0)["deadline_met_rate"] == 1.0


# --- engine-level: explicit events, never a silent hang --------------------


def test_bounded_queue_rejects_with_event(smoke_model):
    """Four requests into a queue bounded at two: the last two rejected
    with explicit events on the first pull — and the whole event stream,
    rejects included, equals the JAX engine's."""
    jm, jp, _, _, _ = smoke_model
    eng = _engine(smoke_model, max_slots=2, max_len=64,
                  qos=QosConfig(max_pending=2))
    stream = StreamingEngine(eng)
    rids = [stream.add_request(np.arange(8, dtype=np.int32),
                               max_new_tokens=3) for _ in range(4)]
    # intake 3 and 4 arrive over the bounded queue: explicit rejects
    # surface on the very first pull, ahead of any step events
    first = stream.step()
    pre = [ev for ev in first if ev.kind == "reject"]
    assert [ev.rid for ev in pre] == rids[2:]
    assert all(ev.reason == "queue_full" for ev in pre)
    assert first[:2] == pre
    events = first + list(stream.events())
    terminal = check_event_stream(events)
    assert [terminal[r] for r in rids] == \
        ["finish", "finish", "reject", "reject"]
    res = stream.result()
    assert res["n_rejected"] == 2
    assert all(r.state == REJECTED for r in res["rejected_requests"])
    assert res["qos"]["rejected"] == 2
    # cancelling a rejected rid is the documented no-op
    assert stream.cancel(rids[2]) is False
    check_alloc_invariants(eng.core.sched.alloc)
    # the JAX engine on the same intake
    jstream = JStreaming(JEngine(jm, jp, max_slots=2, max_len=64,
                                 qos=JQosConfig(max_pending=2)))
    for _ in range(4):
        jstream.add_request(np.arange(8, dtype=np.int32), max_new_tokens=3)
    jevents = list(jstream.events())
    key = lambda evs: [(e.kind, e.rid, e.slot, e.ordinal, e.token,  # noqa: E731
                        e.reason) for e in evs]
    assert key(events) == key(jevents)
    assert _qos_counts(res) == _qos_counts(jstream.result())


def test_deadline_shed_emits_events_and_frees_nothing(smoke_model):
    cfg = smoke_model[2]
    eng = _engine(smoke_model, max_slots=2, max_len=64,
                  qos=QosConfig(ttft_slo=1e-4))
    stream = StreamingEngine(eng)
    rng = np.random.default_rng(0)
    # a two-slot engine swallowing 8 near-simultaneous arrivals under a
    # microscopic deadline: the queue tail must shed, not serve late
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, (16,))
                    .astype(np.int32),
                    max_new_tokens=4, arrival_time=i * 1e-5)
            for i in range(8)]
    for r in reqs:
        stream.submit(r)
    events = list(stream.events())
    terminal = check_event_stream(events)
    res = stream.result()
    assert res["n_shed"] > 0
    sheds = [ev for ev in events if ev.kind == "shed"]
    assert {ev.reason for ev in sheds} <= \
        {"deadline_blown", "deadline_unmeetable"}
    assert all(r.state == SHED for r in res["shed_requests"])
    assert res["qos"]["prefill_rate_est"] is not None
    # every request reached exactly one terminal state
    assert sorted(terminal) == list(range(8))
    assert res["n_shed"] + len(res["requests"]) == 8
    check_alloc_invariants(eng.core.sched.alloc)
    assert eng.core.sched.alloc.free_pages == eng.core.layout.num_pages


def test_degrade_engages_under_pool_pressure(smoke_model):
    cfg = smoke_model[2]
    g = cfg.quant.group_size
    # an oversubscribed pool: 3 slots contending for barely more pages
    # than one request needs keeps utilization pinned above pressure_hi
    pages = (48 + 8) // g + 3
    qos = QosConfig(pressure_hi=0.6, pressure_lo=0.3, hysteresis_up=2)
    eng = _engine(smoke_model, max_slots=3, max_len=64, num_pages=pages,
                  qos=qos)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, (24,))
                    .astype(np.int32),
                    max_new_tokens=8, arrival_time=i * 1e-3)
            for i in range(6)]
    res = eng.run(reqs, GenerationConfig())
    deg = res["qos"]["degrade"]
    assert deg["downshifts"] > 0            # pressure engaged the ladder
    assert deg["peak_level"] >= 1
    assert len(res["requests"]) == 6        # degraded, but everyone done
    check_alloc_invariants(eng.core.sched.alloc)


def _burst(cls, vocab, tenants=None, n=6, seed=2):
    rng = np.random.default_rng(seed)
    tenants = tenants or ["default"] * n
    return [cls(rid=i,
                prompt=rng.integers(0, vocab, (int(rng.integers(8, 40)),))
                .astype(np.int32),
                max_new_tokens=int(rng.integers(3, 9)), tenant=tenants[i])
            for i in range(n)]


def test_default_qos_config_outputs_match_plain_engine(smoke_model):
    """A bare ``QosConfig()`` on a single-tenant workload changes
    accounting, not behaviour: greedy outputs equal the qos=None
    engine's, and streams and events equal the JAX engine's under the
    same config."""
    jm, jp, cfg, _, _ = smoke_model
    kw = dict(max_slots=2, max_len=64)
    r1 = _engine(smoke_model, **kw).run(_burst(Request, cfg.vocab_size),
                                        GenerationConfig())
    r2 = _engine(smoke_model, qos=QosConfig(), **kw).run(
        _burst(Request, cfg.vocab_size), GenerationConfig())
    assert _toks(r1) == _toks(r2)
    assert "qos" not in r1 and "chaos" not in r1
    assert r2["qos"]["tenants"]["default"]["admitted"] == 6
    jr = JEngine(jm, jp, qos=JQosConfig(), **kw).run(
        _burst(JRequest, cfg.vocab_size), JGen())
    assert _toks(r2) == _toks(jr)
    assert _events(r2) == _events(jr)
    assert _qos_counts(r2) == _qos_counts(jr)


@pytest.mark.parametrize("chunk", [0, 32], ids=["classic", "chunked"])
def test_weighted_tenants_match_jax(smoke_model, chunk):
    """Three tenants (weights 1 / 1 / 2, no deadlines, no budgets) in one
    burst over two slots: the weighted-fair admission order, streams,
    events and per-tenant accounting equal the JAX engine's, and differ
    from FCFS."""
    jm, jp, cfg, _, _ = smoke_model
    tenants = ["a", "a", "a", "a", "b", "c", "c", "b"]
    q = dict(weights={"a": 1.0, "b": 1.0, "c": 2.0})
    kw = dict(max_slots=2, max_len=64, prefill_chunk=chunk)
    eng = _engine(smoke_model, qos=QosConfig(**q), **kw)
    out = eng.run(_burst(Request, cfg.vocab_size, tenants, n=8, seed=4),
                  GenerationConfig())
    jout = JEngine(jm, jp, qos=JQosConfig(**q), **kw).run(
        _burst(JRequest, cfg.vocab_size, tenants, n=8, seed=4), JGen())
    assert _toks(out) == _toks(jout)
    assert _events(out) == _events(jout)
    assert _qos_counts(out) == _qos_counts(jout)
    admits = [e.rid for e in out["events"] if e.kind == "admit"]
    assert admits != sorted(admits)          # not FCFS
    check_event_stream(out["events"])
    check_alloc_invariants(eng.core.sched.alloc)
    assert eng.core.sched.alloc.free_pages == eng.core.layout.num_pages


def test_idle_engine_jumps_clock_to_bucket_refill(smoke_model):
    """With the pool idle and the queue head blocked only by its tenant's
    token bucket, the engine clock (and so every refill) would stand
    still: the engine must jump to the next affordable time instead of
    raising 'num_pages too small'."""
    cfg = smoke_model[2]
    rng = np.random.default_rng(31)
    eng = _engine(smoke_model, max_slots=2, max_len=64,
                  qos=QosConfig(tenant_budget=10.0))  # burst 20 = one request
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, (16,))
                    .astype(np.int32), max_new_tokens=4)
            for i in range(2)]               # cost 20 each
    res = eng.run(reqs, GenerationConfig())
    assert sorted(r.rid for r in res["requests"]) == [0, 1]
    # rid 1 had to wait out a full bucket refill (20 tokens / 10 tok/s)
    assert res["wall_s"] >= 1.9
    assert res["qos"]["tenants"]["default"]["admitted"] == 2


def test_affordable_time_moves_the_clock_past_a_rounding_deficit():
    """A bucket one ulp short of a request's cost at clock 10, as a refill
    that falls short leaves it: JAX's next affordable time is the clock
    itself, so its idle engine would jump to the same clock forever; the
    port's is later, and a refill there affords the request."""
    cfg = dict(tenant_budget=2000.0)
    st, jst = QosState(QosConfig(**cfg)), jqos.QosState(JQosConfig(**cfg))
    clock, r, jr = 10.0, _req(0, plen=496), _req(0, plen=496, cls=JRequest)
    need = float(jqos.request_cost(jr))
    for state in (st, jst):
        state.refill(clock)
        state.tenant("default").bucket = need - math.ulp(need)
    assert jst.next_affordable_time([jr], clock) == clock
    t = st.next_affordable_time([r], clock)
    assert clock < t < clock + 1e-12
    st.refill(t)
    assert st.tenant("default").can_afford(int(need))


def test_idle_engine_clock_jump_survives_a_rounding_deficit(smoke_model):
    """The engine end of the test above: an idle engine whose one pending
    request's bucket is an ulp short at clock 10 moves its clock, admits
    and finishes the request within a few steps."""
    cfg = smoke_model[2]
    eng = _engine(smoke_model, max_slots=2, max_len=64,
                  qos=QosConfig(tenant_budget=10.0))  # burst 20 = one request
    core = eng.core
    core.reset(GenerationConfig())
    core.clock = 10.0
    core.add_request(Request(rid=0, prompt=np.random.default_rng(32).integers(
        0, cfg.vocab_size, (16,)).astype(np.int32), max_new_tokens=4))
    ts = core.qos.tenant("default")
    ts.refill(core.clock)
    ts.bucket = 20.0 - math.ulp(20.0)        # cost 20
    events = []
    for _ in range(50):
        if not core.has_work:
            break
        events += core.step()
    assert not core.has_work and core.clock > 10.0
    assert [e.kind for e in events if e.kind in ("admit", "finish")] == \
        ["admit", "finish"]


def test_runahead_stays_off_under_qos(smoke_model):
    """The horizon planner never engages under QoS (per-cycle decisions):
    ``runahead=4`` gives no horizon and the streams of ``runahead=0``."""
    cfg = smoke_model[2]
    outs = [_engine(smoke_model, max_slots=2, max_len=64, runahead=h,
                    qos=QosConfig()).run(_burst(Request, cfg.vocab_size),
                                         GenerationConfig())
            for h in (0, 4)]
    assert outs[1]["runahead"]["horizons"] == 0
    assert _events(outs[0]) == _events(outs[1])
