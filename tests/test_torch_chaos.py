"""Port of ``tests/test_chaos.py`` (DESIGN.md §16): deterministic fault
injection through ``repro_torch.serve.chaos``. The engine keeps its
invariants — allocator conservation, dense event ordinals, greedy
survivors identical to a clean run — under every injected fault, and the
injector is inert when disabled or empty.

The injector draws from its own seeded numpy generator, so it is held to
the JAX package's injector draw for draw. Faults are scheduled by engine
cycle, which does not read the clock: under burst arrivals (every request
at t = 0; the engine clock is measured compute time) the cancel-storm
and proposer-fault runs give the JAX engine's streams and events."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.core import cache_layout as jcl  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import ChaosConfig as JChaosConfig  # noqa: E402
from repro.serve import ChaosError as JChaosError  # noqa: E402
from repro.serve import ChaosInjector as JChaosInjector  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.spec import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core.cache_layout import (  # noqa: E402
    PageAllocator, PagedLayout,
)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ChaosConfig, ChaosError, ChaosInjector, ContinuousBatchingEngine,
    GenerationConfig, Request, check_event_stream,
)
from repro_torch.spec import SpecConfig  # noqa: E402
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


def _workload(cls, vocab, n, seed=0, plen=(8, 40), max_new=6):
    """``n`` greedy requests as a burst (every arrival at t = 0)."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(0, vocab, (int(
                    rng.integers(*plen)),)).astype(np.int32),
                max_new_tokens=max_new) for i in range(n)]


def _engine(smoke_model, **kw):
    _, _, _, tm, tp = smoke_model
    return ContinuousBatchingEngine(tm, tp, device="cpu", **kw)


def _toks(res):
    return {r.rid: list(r.out_tokens) for r in res["requests"]}


def _events(out):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token, e.reason)
            for e in out["events"]]


def _draws(inj, err):
    """Twenty proposer calls: True where the injector raised."""
    out = []
    for _ in range(20):
        try:
            inj.maybe_fail_proposer()
            out.append(False)
        except err:
            out.append(True)
    return out


# --- config + injector units ----------------------------------------------


def test_chaos_config_parse_spec_string():
    spec = "exhaust@8,slow@5:0.05,cancel@12:0.5,proposer@0.3"
    cfg = ChaosConfig.parse(spec, seed=7)
    assert cfg.exhaust_at == (8,) and cfg.slow_at == (5,)
    assert cfg.cancel_at == (12,) and cfg.cancel_frac == 0.5
    assert cfg.slow_s == 0.05 and cfg.proposer_fail_rate == 0.3
    assert cfg.seed == 7
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(JChaosConfig.parse(spec, seed=7))
    assert ChaosConfig.parse("exhaust@4:9").exhaust_steps == 9
    with pytest.raises(ValueError):
        ChaosConfig.parse("meteor@3")
    with pytest.raises(ValueError):
        ChaosConfig(cancel_frac=1.5)


def test_injector_is_deterministic_across_resets():
    cfg = ChaosConfig(seed=11, cancel_at=(3,), cancel_frac=0.5,
                      proposer_fail_rate=0.5)
    inj = ChaosInjector(cfg)
    v1 = inj.pick_victims(list(range(10)), 0.5)
    fails1 = _draws(inj, ChaosError)
    inj.reset()
    assert inj.pick_victims(list(range(10)), 0.5) == v1
    assert _draws(inj, ChaosError) == fails1
    assert inj.pick_victims([], 0.9) == []         # no victims, no crash
    assert len(ChaosInjector(cfg).pick_victims([7], 0.01)) == 1  # >= 1


@pytest.mark.parametrize("seed", [0, 11, 42])
def test_injector_matches_jax_draw_for_draw(seed):
    """The same config gives the same actions per cycle, storm victims,
    proposer faults and stats as the JAX package's injector."""
    spec = "exhaust@2:3,slow@2:0.01,cancel@3:0.4,cancel@5,proposer@0.4"
    inj = ChaosInjector(ChaosConfig.parse(spec, seed=seed))
    jinj = JChaosInjector(JChaosConfig.parse(spec, seed=seed))
    for cycle in range(8):
        assert inj.actions(cycle) == jinj.actions(cycle)
        live = list(range(cycle, 3 * cycle + 1))
        assert inj.pick_victims(live, 0.4) == jinj.pick_victims(live, 0.4)
        assert _draws(inj, ChaosError) == _draws(jinj, JChaosError)
    assert inj.stats() == jinj.stats()


def test_allocator_quarantine_preserves_invariants():
    lay = PagedLayout(page_size=4, num_pages=8, slots=2, pages_per_slot=4)
    alloc = PageAllocator(lay)
    assert alloc.alloc(0, 2)
    taken = alloc.quarantine(alloc.free_pages)
    assert taken == 6 and alloc.free_pages == 0
    assert alloc.quarantined_pages == 6
    check_alloc_invariants(alloc)       # quarantine = a legal external pin
    assert alloc.quarantine(3) == 0     # nothing left to take
    assert alloc.release_quarantine() == 6
    assert alloc.free_pages == 6 and alloc.quarantined_pages == 0
    check_alloc_invariants(alloc)


def test_quarantine_soak_matches_jax():
    """Allocations, frees, quarantines and releases in a random order: the
    same page tables, free counts and refcounts as JAX's allocator."""
    kw = dict(page_size=4, num_pages=12, slots=3, pages_per_slot=4)
    a = PageAllocator(PagedLayout(**kw))
    j = jcl.PageAllocator(jcl.PagedLayout(**kw))
    rng = np.random.default_rng(3)
    for _ in range(200):
        op = int(rng.integers(0, 4))
        if op == 0:
            slot, n = int(rng.integers(0, 3)), int(rng.integers(1, 3))
            assert a.alloc(slot, n) == j.alloc(slot, n)
        elif op == 1:
            slot = int(rng.integers(0, 3))
            assert a.free_slot(slot) == j.free_slot(slot)
        elif op == 2:
            n = int(rng.integers(0, 5))
            assert a.quarantine(n) == j.quarantine(n)
        else:
            assert a.release_quarantine() == j.release_quarantine()
        assert a.free_pages == j.free_pages
        assert a.quarantined_pages == j.quarantined_pages
        np.testing.assert_array_equal(a.table().numpy(), j.table_np())
        np.testing.assert_array_equal(a._ref, j._ref)
        check_alloc_invariants(a)


# --- engine-level failure modes -------------------------------------------


def test_chaos_disabled_and_empty_schedule_are_bit_identical(smoke_model):
    """chaos=None and an injector that never fires give the plain
    engine's tokens, events and step counts."""
    cfg = smoke_model[2]
    kw = dict(max_slots=2, max_len=64, num_pages=8)
    r0 = _engine(smoke_model, **kw).run(
        _workload(Request, cfg.vocab_size, 6), GenerationConfig())
    r1 = _engine(smoke_model, chaos=ChaosInjector(
        ChaosConfig(proposer_fail_rate=0.0)), **kw).run(
        _workload(Request, cfg.vocab_size, 6), GenerationConfig())
    assert _toks(r0) == _toks(r1)
    assert _events(r0) == _events(r1)
    assert r0["decode_steps"] == r1["decode_steps"]
    assert r0["total_tokens"] == r1["total_tokens"]
    assert r1["chaos"] == {"exhausts": 0, "slow_steps": 0,
                           "cancel_storms": 0, "storm_cancels": 0,
                           "proposer_faults": 0, "proposer_calls": 0}


def test_forced_exhaustion_recovers_with_invariants(smoke_model):
    """Quarantining every free page mid-run forces the stall/preempt
    path; once the quarantine lifts, every request still completes and
    the allocator balances to the page — the JAX engine's events."""
    jm, jp, cfg, _, _ = smoke_model
    kw = dict(max_slots=2, max_len=64, num_pages=6)
    ch = dict(exhaust_at=(4,), exhaust_steps=3, seed=1)
    eng = _engine(smoke_model, chaos=ChaosInjector(ChaosConfig(**ch)), **kw)
    res = eng.run(_workload(Request, cfg.vocab_size, 5, seed=3),
                  GenerationConfig())
    assert res["chaos"]["exhausts"] == 1
    assert len(res["requests"]) == 5          # everyone survived
    check_event_stream(res["events"])
    check_alloc_invariants(eng.core.sched.alloc)
    assert eng.core.sched.alloc.quarantined_pages == 0
    assert eng.core.sched.alloc.free_pages == eng.core.layout.num_pages
    jres = JEngine(jm, jp, chaos=JChaosInjector(JChaosConfig(**ch)),
                   **kw).run(_workload(JRequest, cfg.vocab_size, 5, seed=3),
                             JGen())
    assert _events(res) == _events(jres)
    assert res["chaos"] == jres["chaos"]


def test_exhaustion_with_empty_slots_spins_not_dies(smoke_model):
    """When a quarantine leaves the engine with pending work, no active
    slot and no future arrival, it spins until the scheduled release
    instead of raising the 'num_pages too small' error meant for an
    undersized pool."""
    cfg = smoke_model[2]
    rng = np.random.default_rng(21)
    eng = _engine(smoke_model, max_slots=1, max_len=64, num_pages=3,
                  chaos=ChaosInjector(ChaosConfig(exhaust_at=(2,),
                                                  exhaust_steps=6, seed=3)))
    # both arrive at t=0; the 1-slot engine holds req 1 pending while the
    # quarantine (cycle 2) grabs the pages req 1 will need after req 0's
    # early finish
    reqs = [Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, (20,))
                    .astype(np.int32), max_new_tokens=2),
            Request(rid=1, prompt=rng.integers(0, cfg.vocab_size, (60,))
                    .astype(np.int32), max_new_tokens=3)]
    res = eng.run(reqs, GenerationConfig())
    assert res["chaos"]["exhausts"] == 1
    assert sorted(r.rid for r in res["requests"]) == [0, 1]
    check_event_stream(res["events"])
    check_alloc_invariants(eng.core.sched.alloc)
    assert eng.core.sched.alloc.quarantined_pages == 0
    assert eng.core.sched.alloc.free_pages == eng.core.layout.num_pages


def test_cancel_storm_survivors_bit_identical(smoke_model):
    """A storm cancels half the live requests mid-run; on a
    preemption-free pool the survivors' greedy outputs equal the clean
    run's token for token, and the stormy run's events equal the JAX
    engine's under the same storm."""
    jm, jp, cfg, _, _ = smoke_model
    kw = dict(max_slots=2, max_len=64)
    ch = dict(cancel_at=(6,), cancel_frac=0.5, seed=2)
    r0 = _engine(smoke_model, **kw).run(
        _workload(Request, cfg.vocab_size, 6, seed=5), GenerationConfig())
    stormy = _engine(smoke_model, chaos=ChaosInjector(ChaosConfig(**ch)),
                     **kw)
    r1 = stormy.run(_workload(Request, cfg.vocab_size, 6, seed=5),
                    GenerationConfig())
    assert r1["chaos"]["cancel_storms"] == 1 and r1["n_cancelled"] > 0
    survivors = _toks(r1)
    baseline = _toks(r0)
    assert survivors                        # the storm spared someone
    for rid, toks in survivors.items():
        assert toks == baseline[rid], f"survivor rid {rid} diverged"
    terminal = check_event_stream(r1["events"])
    cancelled = {r.rid for r in r1["cancelled_requests"]}
    assert {rid for rid, k in terminal.items() if k == "cancel"} == \
        cancelled
    assert len(survivors) + len(cancelled) == 6
    check_alloc_invariants(stormy.core.sched.alloc)
    assert stormy.core.sched.alloc.free_pages == \
        stormy.core.layout.num_pages
    jr = JEngine(jm, jp, chaos=JChaosInjector(JChaosConfig(**ch)), **kw).run(
        _workload(JRequest, cfg.vocab_size, 6, seed=5), JGen())
    assert _events(r1) == _events(jr)
    assert r1["chaos"] == jr["chaos"]


@pytest.mark.parametrize("rate", [1.0, 0.3])
def test_proposer_faults_degrade_to_plain_decode(smoke_model, rate):
    """A proposer that raises costs speculation, never correctness: the
    streams of spec-off decode, the faults counted — at rate 1 nothing is
    ever verified — and the events, spec counts and faults of the JAX
    engine under the same injector."""
    jm, jp, cfg, _, _ = smoke_model
    kw = dict(max_slots=2, max_len=64)
    ch = dict(proposer_fail_rate=rate, seed=4)
    r0 = _engine(smoke_model, **kw).run(
        _workload(Request, cfg.vocab_size, 4, seed=7, max_new=8),
        GenerationConfig())
    r1 = _engine(smoke_model, spec=SpecConfig(mode="ngram", k=4),
                 chaos=ChaosInjector(ChaosConfig(**ch)), **kw).run(
        _workload(Request, cfg.vocab_size, 4, seed=7, max_new=8),
        GenerationConfig())
    assert _toks(r0) == _toks(r1)
    assert r1["proposer_faults"] > 0
    if rate == 1.0:
        assert r1["spec"]["drafted_tokens"] == 0   # nothing ever verified
    check_event_stream(r1["events"])
    jr = JEngine(jm, jp, spec=JSpecConfig(mode="ngram", k=4),
                 chaos=JChaosInjector(JChaosConfig(**ch)), **kw).run(
        _workload(JRequest, cfg.vocab_size, 4, seed=7, max_new=8), JGen())
    assert _events(r1) == _events(jr)
    assert r1["proposer_faults"] == jr["proposer_faults"]
    assert r1["chaos"] == jr["chaos"]
    for k in ("steps", "drafted_tokens", "accepted_tokens"):
        assert r1["spec"][k] == jr["spec"][k], k


def test_slow_steps_only_stretch_the_clock(smoke_model, monkeypatch):
    """Injected slow steps add their seconds to the engine clock and
    nothing else. The clock reads a fake ``time.monotonic`` that advances
    one fixed step per call, so both runs measure the same compute
    whatever the host's load, and the difference is the injected 1.5 s
    exactly."""
    from repro_torch.serve import core as serve_core
    ticks = iter(range(1 << 40))
    monkeypatch.setattr(serve_core.time, "monotonic",
                        lambda: next(ticks) * 2.0 ** -10)
    cfg = smoke_model[2]
    mk = lambda chaos: _engine(smoke_model, max_slots=2, max_len=64,  # noqa: E731
                               chaos=chaos)
    r0 = mk(None).run(_workload(Request, cfg.vocab_size, 4, seed=9),
                      GenerationConfig())
    slow = ChaosInjector(ChaosConfig(slow_at=(2, 3, 4), slow_s=0.5))
    r1 = mk(slow).run(_workload(Request, cfg.vocab_size, 4, seed=9),
                      GenerationConfig())
    assert r1["chaos"]["slow_steps"] == 3
    assert _toks(r0) == _toks(r1)              # tokens untouched
    assert r1["wall_s"] == pytest.approx(r0["wall_s"] + 1.5, abs=1e-9)
    check_event_stream(r1["events"])


def test_streaming_cancel_storm_under_prefix_cache(smoke_model):
    """Storms + prefix sharing: cancelled slots decref adopted pages
    under the index's pins; the allocator must balance and the index
    survive for later adoptions."""
    cfg = smoke_model[2]
    g = cfg.quant.group_size
    rng = np.random.default_rng(13)
    shared = rng.integers(0, cfg.vocab_size, (g,)).astype(np.int32)
    reqs = [Request(rid=i,
                    prompt=np.concatenate([shared, rng.integers(
                        0, cfg.vocab_size, (6,)).astype(np.int32)]),
                    max_new_tokens=5,
                    arrival_time=0.0 if i == 0 else 0.05 + i * 0.002)
            for i in range(6)]
    eng = _engine(smoke_model, max_slots=2, max_len=64, prefix_cache=True,
                  prefill_chunk=g,
                  chaos=ChaosInjector(ChaosConfig(cancel_at=(5, 9),
                                                  cancel_frac=0.5, seed=6)))
    res = eng.run(reqs, GenerationConfig())
    assert res["chaos"]["cancel_storms"] == 2
    check_event_stream(res["events"])
    check_alloc_invariants(eng.core.sched.alloc)
    assert eng.core.sched.alloc.quarantined_pages == 0
    # completed + cancelled account for every request exactly once
    assert len(res["requests"]) + res["n_cancelled"] == 6


def test_runahead_stays_off_under_chaos(smoke_model):
    """An empty injector still keeps the horizon planner off (faults are
    per cycle): ``runahead=4`` gives no horizon and the plain streams."""
    cfg = smoke_model[2]
    kw = dict(max_slots=2, max_len=64, runahead=4)
    r0 = _engine(smoke_model, **kw).run(
        _workload(Request, cfg.vocab_size, 3, seed=1, max_new=10),
        GenerationConfig())
    r1 = _engine(smoke_model, chaos=ChaosInjector(ChaosConfig()), **kw).run(
        _workload(Request, cfg.vocab_size, 3, seed=1, max_new=10),
        GenerationConfig())
    assert r0["runahead"]["horizons"] > 0
    assert r1["runahead"]["horizons"] == 0
    assert _toks(r0) == _toks(r1)
