"""Run-ahead decode in the port (DESIGN.md §18), on the CPU at smoke width.

The port of ``tests/test_runahead.py``, case by case: a horizon of H
micro-steps — each exactly one ``decode_paged`` step plus on-device
sampling — must reproduce the one-token engine token for token, greedy
and sampled, across quant-group boundaries, EOS and budget truncation,
cancels landing an in-flight block, and the fallback configurations.
On top: parity of the port's ``runahead=4`` engine with the JAX engine's
(streams and event sequences), ``decode_runahead_fn`` against H sequential
steps, ``Scheduler.ensure_pages(spans=)`` against JAX's on one allocation
sequence, and the warmup leaving the session generator alone. On the CPU
the engine runs every dispatch eagerly; the CUDA graphs that replay the
same functions on the card are held to the eager steps in
``tests/test_torch_cuda.py``."""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the tests do not crowd
# the cores of the other test workers
torch.set_num_threads(1)

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core.cache_layout import PagedLayout  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, EngineCore, GenerationConfig, Request,
    Scheduler, StreamingEngine, TokenEvent, check_event_stream,
    stream_latency_stats,
)
from repro_torch.serve.core import _sample  # noqa: E402


@pytest.fixture(scope="module")
def smoke_model():
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    m = get_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, m, m.init(generator=gen, device="cpu")


def _requests(cfg, n=2, seed=5, prompt_len=12, max_new=24):
    """All-arrive-at-once decode-bound workload: with ``n`` <= slots the
    queue drains at once and the horizon planner engages. (JAX's test
    spaces arrivals 1 ms apart; the engine clock counts measured compute
    time, so here every request arrives at t = 0 and the schedule does
    not follow the machine's speed.)"""
    rng = np.random.RandomState(seed)
    return [Request(rid=i,
                    prompt=rng.randint(0, cfg.vocab_size,
                                       (prompt_len,)).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


def _clone(reqs):
    return [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens,
                    arrival_time=r.arrival_time) for r in reqs]


def _run(m, params, reqs, *, runahead=0, gen=None, **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 128)
    eng = ContinuousBatchingEngine(m, params, runahead=runahead,
                                   device="cpu", **kw)
    out = eng.run(_clone(reqs), gen or GenerationConfig())
    return eng, out, {r.rid: list(r.out_tokens) for r in out["requests"]}


# ---------------------------------------------------------------------------
# Bit-identity across horizons: greedy and sampled
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h", [2, 4, 8])
def test_greedy_bit_identical_across_horizons(smoke_model, h):
    cfg, m, params = smoke_model
    reqs = _requests(cfg)
    _, base_out, base = _run(m, params, reqs)
    _, out, toks = _run(m, params, reqs, runahead=h)
    assert toks == base, f"runahead h={h} diverged from per-token decode"
    ra = out["runahead"]
    assert ra["horizons"] > 0, "horizon planner never engaged"
    assert ra["tokens"] > 0
    # every token is emitted exactly once whichever path produced it
    assert out["total_tokens"] == base_out["total_tokens"]
    assert out["decode_graphs"] == 0   # the CPU runs every dispatch eagerly


def test_sampled_bit_identical(smoke_model):
    """temperature > 0 + top_k: the horizon must leave the generator where
    the one-token loop leaves it — one draw per step in which any slot is
    live, none after all finish. Staggered budgets finish the slots at
    different micro-steps; a second batch in the same session samples
    after a horizon whose lanes all froze early (the rewind)."""
    cfg, m, params = smoke_model
    gen = GenerationConfig(temperature=0.8, top_k=8, seed=7)
    first = _requests(cfg, n=2, max_new=17)
    first[1].max_new_tokens = 23
    second = [dataclasses.replace(r, rid=r.rid + 2, max_new_tokens=9)
              for r in _clone(_requests(cfg, n=2, seed=6))]

    def session(h):
        stream = StreamingEngine(EngineCore(m, params, max_slots=2,
                                            max_len=128, runahead=h,
                                            device="cpu"), gen)
        events = []
        for batch in (first, second):
            for r in _clone(batch):
                stream.submit(r)
            events += list(stream.events())
        res = stream.result()
        return res, {r.rid: r.out_tokens for r in res["requests"]}, events

    _, base, _ = session(0)
    res, toks, events = session(4)
    assert toks == base, "sampled outputs diverged: the draws moved"
    assert res["runahead"]["horizons"] > 0
    check_event_stream(events)


def test_sampled_eos_in_chained_horizon(smoke_model):
    """A sampled lane hits EOS mid-horizon while the next horizon is
    already chained: the landed block rewinds the generator, and the
    all-frozen successor must leave it there — a later request in the
    same session samples the one-token engine's stream."""
    cfg, m, params = smoke_model
    gen = GenerationConfig(temperature=0.8, top_k=8, seed=5)
    first = _requests(cfg, n=1, max_new=40)
    later = [dataclasses.replace(r, rid=1, max_new_tokens=9)
             for r in _requests(cfg, n=1, seed=8)]

    def session(h, eos):
        stream = StreamingEngine(EngineCore(m, params, max_slots=2,
                                            max_len=128, runahead=h,
                                            device="cpu"),
                                 dataclasses.replace(gen, eos_id=eos))
        for batch in (first, later):
            for r in _clone(batch):
                stream.submit(r)
            list(stream.events())
        return stream.result(), {r.rid: r.out_tokens
                                 for r in stream.result()["requests"]}

    _, free = session(0, -1)
    # token k >= 5 (past the first horizon), first of its kind, on a
    # micro-step other than the horizon's last; decode token k is micro-
    # step (k - 1) % 4 of its horizon
    stream0 = free[0]
    k = next(k for k in range(5, len(stream0))
             if stream0[k] not in stream0[:k] and (k - 1) % 4 != 3)
    _, base = session(0, stream0[k])
    res, toks = session(4, stream0[k])
    assert len(base[0]) == k + 1
    assert toks == base
    assert res["runahead"]["horizons"] > 0


def test_group_boundary_commit_inside_horizon(smoke_model):
    """Lengths crossing a quant-group (page) boundary mid-horizon: the
    horizon's paged appends must flush residual groups at the same
    commit points as the per-token loop."""
    cfg, m, params = smoke_model
    g = cfg.quant.group_size
    # appends cross into a fresh group after 3 decode tokens — inside
    # the first H=8 horizon — and again every g tokens after that
    reqs = _requests(cfg, prompt_len=2 * g - 3, max_new=2 * g + 4)
    _, _, base = _run(m, params, reqs)
    _, out, toks = _run(m, params, reqs, runahead=8)
    assert toks == base, "group-boundary commits inside the horizon diverged"
    assert out["runahead"]["horizons"] > 0


# ---------------------------------------------------------------------------
# EOS mid-horizon: truncation + page reclamation
# ---------------------------------------------------------------------------


def test_eos_mid_horizon_truncates_and_reclaims(smoke_model):
    cfg, m, params = smoke_model
    reqs = _requests(cfg)
    # pick an eos off the greedy stream so it fires mid-run, mid-horizon
    _, _, base = _run(m, params, reqs)
    eos = base[0][len(base[0]) // 2]
    gen = GenerationConfig(eos_id=int(eos))
    _, _, base_toks = _run(m, params, reqs, gen=gen)
    eng, out, toks = _run(m, params, reqs, runahead=8, gen=gen)
    assert toks == base_toks, "EOS truncation diverged from per-token loop"
    assert any(len(t) < r.max_new_tokens
               for t, r in zip(toks.values(), reqs)), \
        "workload never hit EOS — test is vacuous"
    # the horizon ran ahead past EOS on the device; the over-run tokens
    # are dropped at reconcile and the slot's pages reclaimed on drain
    alloc = eng.core.sched.alloc
    assert alloc.free_pages == eng.core.layout.num_pages, \
        "pages leaked after EOS mid-horizon"
    term = check_event_stream(out["events"])
    assert all(k == "finish" for k in term.values())


# ---------------------------------------------------------------------------
# Cancel racing an in-flight horizon
# ---------------------------------------------------------------------------


def test_cancel_while_horizon_in_flight(smoke_model):
    cfg, m, params = smoke_model
    core = EngineCore(m, params, max_slots=2, max_len=128, runahead=4,
                      device="cpu")
    stream = StreamingEngine(core)
    reqs = _requests(cfg, max_new=32)
    for r in reqs:
        stream.submit(r)
    events = []
    for _ in range(200):
        events.extend(stream.step())
        if core._inflight is not None:
            break
    assert core._inflight is not None, "no horizon ever went in flight"
    # cancel must land the in-flight block first: rid 0's horizon tokens
    # surface *before* its cancel event, never after
    assert stream.cancel(reqs[0].rid)
    assert core._inflight is None, "cancel left a horizon in flight"
    while stream.has_work:
        events.extend(stream.step())
    term = check_event_stream(events)
    assert term[reqs[0].rid] == "cancel"
    assert term[reqs[1].rid] == "finish"
    alloc = core.sched.alloc
    assert alloc.free_pages == core.layout.num_pages, \
        "pages leaked after cancel mid-horizon"


# ---------------------------------------------------------------------------
# Event-stream semantics of horizon blocks
# ---------------------------------------------------------------------------


def test_horizon_events_share_timestamps(smoke_model):
    """A landed block emits its kept tokens as one span: shared clock
    stamp, (span, span_ix) metadata, dense ordinals — so the stream
    checkers apply unchanged."""
    cfg, m, params = smoke_model
    reqs = _requests(cfg)
    _, out, _ = _run(m, params, reqs, runahead=4)
    check_event_stream(out["events"])
    spans = [ev for ev in out["events"]
             if ev.kind in ("first_token", "token") and ev.span > 1]
    assert spans, "no multi-token horizon spans in the stream"
    by_key = {}
    for ev in spans:
        by_key.setdefault((ev.rid, ev.t), []).append(ev)
    multi = [evs for evs in by_key.values() if len(evs) > 1]
    assert multi, "horizon tokens never shared a timestamp"
    for evs in multi:
        assert [e.span_ix for e in evs] == list(range(len(evs)))
        assert len({e.span for e in evs}) == 1
    lat = stream_latency_stats(out["events"], reqs)
    assert lat["itl_s"]["n"] > 0
    assert lat["itl_s"]["p50"] >= 0.0   # intra-span gaps clamp to 0
    assert min(_token_gaps(out["events"])) == 0.0


def _token_gaps(events):
    """Per-rid gaps between consecutive token events."""
    last, gaps = {}, []
    for ev in events:
        if ev.kind in ("first_token", "token"):
            if ev.rid in last:
                gaps.append(ev.t - last[ev.rid])
            last[ev.rid] = ev.t
    return gaps


@pytest.mark.parametrize("broken", ["ix_skips", "t_moves", "cut_short"])
def test_check_event_stream_rejects_broken_spans(broken):
    """span_ix runs 0..span-1 on one timestamp, uninterrupted."""
    evs = [TokenEvent("first_token", 0, 0.0, token=1, ordinal=0),
           TokenEvent("token", 0, 1.0, token=2, ordinal=1, span=3,
                      span_ix=0),
           TokenEvent("token", 0, 1.0, token=3, ordinal=2, span=3,
                      span_ix=1),
           TokenEvent("token", 0, 1.0, token=4, ordinal=3, span=3,
                      span_ix=2),
           TokenEvent("finish", 0, 1.0)]
    check_event_stream(evs)
    if broken == "ix_skips":
        evs[2] = dataclasses.replace(evs[2], span_ix=2)
    elif broken == "t_moves":
        evs[3] = dataclasses.replace(evs[3], t=1.5)
        evs[4] = dataclasses.replace(evs[4], t=1.5)
    else:
        del evs[3]
    with pytest.raises(AssertionError):
        check_event_stream(evs)


# ---------------------------------------------------------------------------
# Fallback gates: incompatible configs stay on the per-token path
# ---------------------------------------------------------------------------


def test_fallback_configs_never_engage(smoke_model):
    """The prefix cache keeps the one-token dispatch. (JAX's test also
    runs speculative decoding and QoS here; neither is ported yet.)"""
    cfg, m, params = smoke_model
    reqs = _requests(cfg, n=3, max_new=12)
    _, _, base = _run(m, params, reqs, max_slots=3)
    _, chunked, _ = _run(m, params, reqs, max_slots=3, prefill_chunk=32)
    _, out, toks = _run(m, params, reqs, runahead=4, max_slots=3,
                        prefix_cache=True, prefill_chunk=32)
    assert out["runahead"]["horizons"] == 0, \
        "runahead engaged under the prefix cache"
    assert toks == {r.rid: r.out_tokens for r in chunked["requests"]}
    assert toks == base


def test_oversubscribed_pool_falls_back(smoke_model):
    """When the pool can't pre-reserve a full horizon the planner falls
    back to H=1 (which can stall and preempt) instead of stalling —
    outputs still match the per-token engine on the same undersized
    pool."""
    cfg, m, params = smoke_model
    g = cfg.quant.group_size
    reqs = _requests(cfg, n=2, max_new=16)
    pages = 2 * ((12 + 16) // g + 1)   # just enough to finish, no slack
    kw = dict(max_slots=2, max_len=64, num_pages=pages)
    _, _, base = _run(m, params, reqs, **kw)
    eng, _, toks = _run(m, params, reqs, runahead=8, **kw)
    assert toks == base
    assert eng.core.sched.alloc.free_pages == pages


def test_invalid_runahead_rejected(smoke_model):
    _, m, params = smoke_model
    with pytest.raises(ValueError):
        EngineCore(m, params, max_slots=2, max_len=64, runahead=-1,
                   device="cpu")


# ---------------------------------------------------------------------------
# The warmup leaves the session generator alone
# ---------------------------------------------------------------------------


def test_warmup_keeps_the_sampled_stream(smoke_model):
    """A session warmed up after ``StreamingEngine(core, gen)`` (which
    resets the core) samples the stream of an un-warmed one, as the JAX
    engine's warmup — on its own throwaway key — does."""
    cfg, m, params = smoke_model
    gen = GenerationConfig(temperature=0.8, top_k=8, seed=3)
    reqs = _requests(cfg, n=2, max_new=10)

    def stream(warm, runahead=0):
        core = EngineCore(m, params, max_slots=2, max_len=128,
                          runahead=runahead, device="cpu")
        eng = StreamingEngine(core, gen)
        if warm:
            core.warmup([len(r.prompt) for r in reqs])
        for r in _clone(reqs):
            eng.submit(r)
        list(eng.events())
        return {r.rid: r.out_tokens for r in eng.result()["requests"]}

    assert stream(True) == stream(False)
    assert stream(True, runahead=4) == stream(False)


# ---------------------------------------------------------------------------
# decode_runahead_fn against H sequential one-token steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_decode_runahead_fn_matches_sequential_steps(smoke_model,
                                                     temperature):
    """Three prefilled slots (one crossing a group boundary inside the
    horizon), budgets 2, 6 and 4, an EOS that freezes a lane, six
    micro-steps: the tokens of every live micro-step and every cache
    buffer (the scratch page aside: frozen lanes keep writing it) equal
    those of sequential ``decode_paged`` + ``_sample`` steps whose active
    mask drops finished slots."""
    cfg, m, params = smoke_model
    g = cfg.quant.group_size
    s, h, n = 3, 6, 4
    layout = PagedLayout(page_size=g, num_pages=s * n, slots=s,
                         pages_per_slot=n)
    table = torch.arange(s * n, dtype=torch.int32).reshape(s, n)
    state = m.init_paged_state(layout, "cpu")
    rng = np.random.default_rng(4)
    gen = GenerationConfig(temperature=temperature, top_k=16, seed=11)
    tok0 = []
    for sl, tl in enumerate((g - 2, 20, 2 * g + 5)):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 128)))
        lg, _ = m.prefill_paged(params, toks, state, sl, table[sl], tl)
        tok0.append(int(lg.argmax(-1)[0]))
    budgets = [2, 6, 4]
    ref_state = copy.deepcopy(state)

    # the reference: host loop, one draw per step with a live slot
    ref_gen = torch.Generator()
    ref_gen.manual_seed(gen.seed)
    tok = torch.tensor(tok0, dtype=torch.int64)
    live = [True] * s
    left = list(budgets)
    ref = np.full((h, s), -1)
    eos = None
    for j in range(h):
        if not any(live):
            break
        act = torch.tensor(live)
        lg, _ = m.decode_paged(params, ref_state, tok, table, act)
        nxt = _sample(lg, gen, ref_gen).long()
        if eos is None:
            eos = int(nxt[1])   # freeze slot 1 at its first token
        for sl in range(s):
            if live[sl]:
                ref[j, sl] = int(nxt[sl])
                tok[sl] = nxt[sl]
                left[sl] -= 1
                live[sl] = left[sl] > 0 and int(nxt[sl]) != eos
    assert not any(live)

    run_gen = torch.Generator()
    run_gen.manual_seed(gen.seed)
    toks, tok, done, rem = m.decode_runahead(
        params, state, torch.tensor(tok0, dtype=torch.int64), table,
        torch.ones(s, dtype=torch.bool), run_gen,
        torch.tensor(budgets, dtype=torch.int32),
        torch.zeros(s, dtype=torch.bool), horizon=h,
        temperature=gen.temperature, top_k=gen.top_k, eos_id=eos)
    assert toks.shape == (h, s)
    keep = ref >= 0
    np.testing.assert_array_equal(toks.numpy()[keep], ref[keep])
    assert done.all()
    assert rem.tolist() == [b - int(k) for b, k in
                            zip(budgets, keep.sum(0))]
    scratch = layout.scratch_page
    for got, want in zip(state, ref_state):
        for f in ("key_codes", "value_fp", "key_residual", "lengths"):
            a, b = getattr(got, f), getattr(want, f)
            if f in ("key_codes", "value_fp"):
                a, b = a[:scratch], b[:scratch]
            assert torch.equal(a, b), f
        for k in got.key_scales:
            assert torch.equal(got.key_scales[k][:scratch],
                               want.key_scales[k][:scratch]), k


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as j_get_config
    from repro.configs import reduce_for_smoke as j_reduce
    from repro.models import get_model as j_get_model
    from repro_torch.weights import params_from_jax
    jcfg = dataclasses.replace(j_reduce(j_get_config("tinyllama-1.1b")),
                               decode_backend="paged_fused",
                               prefill_backend="paged_fused")
    jm = j_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, get_model(cfg), tp, cfg


def test_runahead_engine_matches_jax(jax_side):
    """A burst of five requests on three slots at ``runahead=4``: the
    first admissions decode one token a step while the queue drains, the
    rest run horizons. Greedy streams and the event sequences (kind, rid,
    slot, ordinal, token, span, span_ix) equal the JAX engine's. One
    table width (max_len 32 = one page a slot) and one prefill bucket
    keep the JAX side to one compile shape."""
    from repro.serve import ContinuousBatchingEngine as JEngine
    from repro.serve import GenerationConfig as JGen
    from repro.serve import Request as JRequest
    jm, jp, tm, tp, cfg = jax_side
    rng = np.random.default_rng(9)
    spec = [(rng.integers(0, cfg.vocab_size, (int(t),)).astype(np.int32),
             int(b)) for t, b in zip(rng.integers(4, 12, 5),
                                     rng.integers(6, 19, 5))]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=b)
                for i, (p, b) in enumerate(spec)]

    kw = dict(max_slots=3, max_len=32, runahead=4)
    jout = JEngine(jm, jp, **kw).run(reqs(JRequest), JGen())
    tout = ContinuousBatchingEngine(tm, tp, device="cpu", **kw).run(
        reqs(Request), GenerationConfig())

    def events(out):
        return [(e.kind, e.rid, e.slot, e.ordinal, e.token, e.span,
                 e.span_ix) for e in out["events"]]

    assert {r.rid: r.out_tokens for r in tout["requests"]} == \
        {r.rid: r.out_tokens for r in jout["requests"]}
    assert events(tout) == events(jout)
    assert tout["runahead"]["horizons"] == jout["runahead"]["horizons"] > 0
    assert tout["runahead"]["tokens"] == jout["runahead"]["tokens"]
    assert tout["decode_steps"] == jout["decode_steps"]


def test_ensure_pages_spans_matches_jax():
    """One allocation sequence through both schedulers: span reservations
    across page boundaries, the one-token rule, a dry pool shedding
    trailing pages, and a stall when the first append has no page."""
    from repro.core.cache_layout import PagedLayout as JLayout
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler
    g, slots = 8, 3
    kw = dict(page_size=g, num_pages=9, slots=slots, pages_per_slot=5)
    ours, theirs = Scheduler(PagedLayout(**kw)), JScheduler(JLayout(**kw))
    for sched, cls in ((ours, Request), (theirs, JRequest)):
        for rid, tl in enumerate((7, 15, 3)):
            sched.submit(cls(rid=rid, prompt=np.zeros(tl, np.int32)))
            sched.admit(sched.pending[0])
    steps = [
        ([7, 15, 3], {0: 4, 1: 4, 2: 4}),    # 0 and 1 cross into a page
        ([9, 17, 4], None),                   # one-token rule: no page due
        ([16, 17, 8], {0: 4, 2: 2}),          # span and one-token pages
        ([16, 24, 16], {0: 4, 1: 9, 2: 20}),  # 1 sheds a page, 2 stalls
        ([16, 24, 38], {2: 4}),               # clamped at the slot's end
    ]
    for lengths, spans in steps:
        lens = np.asarray(lengths, np.int64)
        got = ours.ensure_pages(lens, spans=spans)
        want = theirs.ensure_pages(lens, spans=spans)
        assert got == want, (lengths, spans)
        np.testing.assert_array_equal(ours.alloc.table().numpy(),
                                      theirs.alloc.table_np())
        assert ours.alloc.free_pages == theirs.alloc.free_pages
    assert ours.alloc.free_pages == 0
