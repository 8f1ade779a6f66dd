"""Port parity for the shared-prefix page cache and chunked prefill:
``repro_torch``'s host state (refcounted allocator, chain hashes, the
PrefixIndex trie), its copy-on-write page copies, and its EngineCore with
``prefill_chunk`` / ``prefix_cache`` against the JAX package
(``decode_backend = prefill_backend = "paged_fused"``).

Engine workloads are those of ``tests/test_paged_prefill.py`` and
``tests/test_prefix_cache.py``. The engine clock counts measured compute
time, so every arrival after t = 0 comes at one time far beyond any time
either engine reaches before it goes idle (the idle clock jump and the
insertion order then fix the order; staggered arrivals would land
between different steps of engines that run at different speeds):
greedy streams, event kinds and ordinals, adopted pages, skipped prefill
tokens and COW splits must all be identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import cache_layout as jcl  # noqa: E402
from repro.core import paged_cache as jpg  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import cache_layout as tcl  # noqa: E402
from repro_torch.core import paged_cache as tpg  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.transformer import copy_state_pages  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, Request,
)
from repro_torch.serve.api import (  # noqa: E402
    StreamingEngine, check_event_stream, stream_latency_stats,
)
from repro_torch.weights import params_from_jax  # noqa: E402


# ---------------------------------------------------------------------------
# Host state: allocator + prefix index under one seeded operation soak
# ---------------------------------------------------------------------------


def _alloc_state(alloc):
    lay = alloc.layout
    return (list(alloc._free),
            [alloc.refcount(p) for p in range(lay.num_pages)],
            [alloc.slot_page_ids(s) for s in range(lay.slots)],
            alloc._table.tolist())


def test_allocator_and_index_soak_matches_jax():
    """Seeded random alloc / adopt / cow / decref / free_slot / incref
    plus PrefixIndex register / match / evict, applied to both packages:
    every return value, refcount, free list, table row and index stat is
    equal after every operation."""
    rng = np.random.default_rng(0)
    g = 4
    kw = dict(page_size=g, num_pages=14, slots=4, pages_per_slot=6)
    ja, ta = jcl.PageAllocator(jcl.PagedLayout(**kw)), \
        tcl.PageAllocator(tcl.PagedLayout(**kw))
    ji = jcl.PrefixIndex(ja.layout, chunk_tokens=2 * g)
    ti = tcl.PrefixIndex(ta.layout, chunk_tokens=2 * g)
    pins: list[int] = []
    # prompts from a small stem set so that chains share prefixes
    stems = [rng.integers(0, 5, (6 * g,)).astype(np.int32) for _ in range(3)]
    seen = {"register": 0, "match": 0, "evict": 0}
    for _ in range(700):
        op = int(rng.integers(0, 8))
        slot = int(rng.integers(0, kw["slots"]))
        if op == 0:
            n = int(rng.integers(1, 3))
            res = [a.alloc(slot, n) for a in (ja, ta)]
        elif op == 1:
            owned = ta.slot_page_ids(int(rng.integers(0, kw["slots"])))
            k = int(rng.integers(0, len(owned) + 1))
            res = [a.adopt(slot, owned[:k]) for a in (ja, ta)]
        elif op == 2:
            res = [a.free_slot(slot) for a in (ja, ta)]
        elif op == 3:
            owned = ta.slot_page_ids(slot)
            if not owned or not ta.can_alloc(1):
                continue
            idx = int(rng.integers(0, len(owned)))
            res = [a.cow(slot, idx) for a in (ja, ta)]
        elif op == 4:
            if pins and rng.random() < 0.5:
                p = pins.pop()
                res = [a.decref(p) for a in (ja, ta)]
            else:
                live = [p for p in range(kw["num_pages"]) if ta.refcount(p)]
                if not live:
                    continue
                p = int(rng.choice(live))
                pins.append(p)
                res = [a.incref(p) for a in (ja, ta)]
        elif op == 5:
            owned = ta.slot_page_ids(slot)
            stem = stems[int(rng.integers(0, len(stems)))]
            toks = np.concatenate([stem[:int(rng.integers(g, 5 * g))],
                                   rng.integers(0, 5, (3,))]).astype(np.int32)
            res = [ji.register(toks, owned, ja), ti.register(toks, owned, ta)]
            seen["register"] += res[1] > 0
        elif op == 6:
            stem = stems[int(rng.integers(0, len(stems)))]
            toks = stem[:int(rng.integers(0, 6 * g))]
            res = [ji.match(toks), ti.match(toks)]
            seen["match"] += bool(res[1])
        else:
            keep = set(ta.slot_page_ids(slot)[:1])
            need = int(rng.integers(1, 4))
            res = [ji.evict(ja, need, keep=keep), ti.evict(ta, need, keep=keep)]
            seen["evict"] += res[1] > 0
        assert res[0] == res[1], (op, res)
        assert _alloc_state(ja) == _alloc_state(ta)
        assert (len(ji), ji.pages, ji.hits, ji.queries, ji.evictions) == \
            (len(ti), ti.pages, ti.hits, ti.queries, ti.evictions)
    assert min(seen.values()) > 0, seen
    ji.drop_all(ja)
    ti.drop_all(ta)
    assert _alloc_state(ja) == _alloc_state(ta)


def test_allocator_errors_match_jax():
    kw = dict(page_size=4, num_pages=4, slots=1, pages_per_slot=6)
    for mod in (jcl, tcl):
        a = mod.PageAllocator(mod.PagedLayout(**kw))
        assert a.alloc(0, 1)
        page = a.page_at(0, 0)
        a.free_slot(0)
        with pytest.raises(ValueError, match="double free"):
            a.decref(page)
        with pytest.raises(ValueError, match="free page"):
            a.incref(page)
        assert a.alloc(0, 2) and a.adopt(0, a.slot_page_ids(0)[:1])
        assert a.free_pages == 2
        assert a.alloc(0, 2) and a.free_pages == 0
        with pytest.raises(RuntimeError, match="empty pool"):
            a.cow(0, 0)


@pytest.mark.parametrize("page_size", [4, 32, 128])
def test_token_page_hashes_byte_equal(page_size):
    rng = np.random.default_rng(page_size)
    toks = rng.integers(0, 32000, (5 * page_size + 3,)).astype(np.int64)
    want = jcl.token_page_hashes(toks, page_size)
    assert tcl.token_page_hashes(toks, page_size) == want
    assert len(want) == 5


# ---------------------------------------------------------------------------
# COW page copies on the device state
# ---------------------------------------------------------------------------


def test_copy_pool_pages_and_state_pages_byte_equal():
    h, d, g, s = 2, 32, 16, 2
    kw = dict(page_size=g, num_pages=6, slots=s, pages_per_slot=3)
    jc = jpg.init_paged_cache(JQuantConfig(group_size=g),
                              jcl.PagedLayout(**kw), h, d, dtype=jnp.float32)
    tc = tpg.init_paged_cache(QuantConfig(group_size=g),
                              tcl.PagedLayout(**kw), h, d,
                              dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(1)
    k = rng.standard_normal((1, h, 3 * g, d)).astype(np.float32)
    v = rng.standard_normal((1, h, 3 * g, d)).astype(np.float32)
    row = np.array([4, 1, 2], np.int32)
    jc = jpg.paged_prefill(jc, jnp.asarray(0), jnp.asarray(row),
                           jnp.asarray(k), jnp.asarray(v), jnp.asarray(40))
    tpg.paged_prefill(tc, 0, torch.from_numpy(row), torch.from_numpy(k),
                      torch.from_numpy(v), 40)
    before = tc.key_residual.clone(), tc.lengths.clone()
    jc = jpg.copy_pool_pages(jc, jnp.asarray(4), jnp.asarray(3))
    assert tpg.copy_pool_pages(tc, 4, 3) is tc
    keep = slice(0, kw["num_pages"])      # the scratch page aside
    np.testing.assert_array_equal(tc.value_fp.numpy()[keep],
                                  np.asarray(jc.value_fp)[keep])
    np.testing.assert_array_equal(tc.key_codes.numpy()[keep],
                                  np.asarray(jc.key_codes)[keep])
    np.testing.assert_array_equal(tc.key_codes.numpy()[3],
                                  tc.key_codes.numpy()[4])
    for name, pool in tc.key_scales.items():
        np.testing.assert_array_equal(pool.numpy()[3], pool.numpy()[4])
    assert torch.equal(tc.key_residual, before[0])
    assert torch.equal(tc.lengths, before[1])
    assert tpg.pool_page_bytes(tc) == jpg.pool_page_bytes(jc)
    # the model-level copy walks every layer's pools
    layers = [tc, tpg.init_paged_cache(QuantConfig(group_size=g),
                                       tcl.PagedLayout(**kw), h, d,
                                       dtype=torch.float32, device="cpu")]
    layers[1].value_fp[1] = 7.0
    copy_state_pages(layers, 1, 5)
    assert torch.equal(layers[0].value_fp[5], layers[0].value_fp[1])
    assert (layers[1].value_fp[5] == 7.0).all()


# ---------------------------------------------------------------------------
# Engine parity: chunked prefill + prefix cache, the JAX workloads
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_reduce(j_get_config("tinyllama-1.1b")),
                               decode_backend="paged_fused",
                               prefill_backend="paged_fused")
    jm = j_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, cfg, get_model(cfg), tp


def _events(out):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token)
            for e in out["events"]]


def _streams(out):
    return {r.rid: list(r.out_tokens) for r in out["requests"]}


def _run_both(models, make_reqs, **eng_kw):
    """Run ``make_reqs(RequestClass)`` through both engines; assert the
    parity contract and return (jax result, port result)."""
    jm, jp, _, tm, tp = models
    jout = JEngine(jm, jp, **eng_kw).run(make_reqs(JRequest), JGen())
    tout = ContinuousBatchingEngine(tm, tp, device="cpu", **eng_kw).run(
        make_reqs(Request), GenerationConfig())
    assert _streams(tout) == _streams(jout)
    assert _events(tout) == _events(jout)
    for key in ("adopted_pages", "fresh_pages", "prefill_tokens_skipped",
                "prefill_tokens_computed", "cow_splits", "decode_steps",
                "prefill_chunk", "prefix_cache"):
        assert tout[key] == jout[key], key
    if jout["prefix_cache"]:
        assert tout["prefix_index"] == jout["prefix_index"]
    return jout, tout


def _paged_prefill_workload(vocab):
    """``tests/test_paged_prefill.py:250``: a 96-token shared prefix plus
    8-40-token tails."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, (96,)).astype(np.int32)
    tails = [rng.integers(0, vocab, (int(rng.integers(8, 40)),))
             .astype(np.int32) for _ in range(5)]

    def reqs(cls):
        return [cls(rid=i, prompt=np.concatenate([shared, tails[i]]),
                    max_new_tokens=6,
                    arrival_time=0.0 if i == 0 else 1000.0)
                for i in range(5)]
    return reqs


def _shared_prefix_requests(cfg, n, prefix_pages=3, seed=0, n_prefixes=1):
    """``tests/test_prefix_cache.py:_shared_prefix_requests`` (request i
    shares prefix ``i % n_prefixes``; one prefix is the JAX workload)."""
    g = cfg.quant.group_size
    rng = np.random.default_rng(seed)
    shared = [rng.integers(0, cfg.vocab_size, (prefix_pages * g,)).astype(
        np.int32) for _ in range(n_prefixes)]
    prompts = [np.concatenate([shared[i % n_prefixes], rng.integers(
        0, cfg.vocab_size, (int(rng.integers(5, 20)),)).astype(np.int32)])
        for i in range(n)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=5,
                    arrival_time=0.0 if i == 0 else 1e4)
                for i, p in enumerate(prompts)]
    return reqs


def test_shared_prefix_chunked_engine_matches_jax(models):
    cfg = models[2]
    _, tout = _run_both(models, _paged_prefill_workload(cfg.vocab_size),
                        max_slots=3, max_len=192, prefill_chunk=32,
                        prefix_cache=True)
    assert tout["adopted_pages"] > 0 and tout["cow_splits"] == 0
    assert tout["prefix_pool_bytes_saved"] == \
        tout["adopted_pages"] * tout["pool_page_bytes"]


def test_prefix_reuse_on_off_matches_jax_and_itself(models):
    """``tests/test_prefix_cache.py:486``: reuse on and off give the same
    streams (adopted pages hold the bytes the unshared run computes), and
    each arm matches JAX."""
    cfg = models[2]
    g = cfg.quant.group_size
    outs = {}
    for reuse in (False, True):
        _, outs[reuse] = _run_both(
            models, _shared_prefix_requests(cfg, 4), max_slots=3,
            max_len=8 * g, prefix_cache=reuse, prefill_chunk=g)
    base, reuse = outs[False], outs[True]
    assert _streams(base) == _streams(reuse)
    assert base["prefill_tokens_skipped"] == 0
    assert reuse["prefill_tokens_skipped"] > 0
    assert reuse["prefix_hit_rate"] > 0
    assert reuse["prefill_tokens_computed"] < base["prefill_tokens_computed"]
    assert reuse["cow_splits"] == 0


def test_chunked_prefill_under_budget_matches_jax(models):
    """``tests/test_prefix_cache.py:513``: chunked prefill alone, one chunk
    of budget per cycle (that test's ``prefill_budget=g`` is the default),
    decode interleaved (as a burst)."""
    cfg = models[2]
    g = cfg.quant.group_size
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (int(rng.integers(8, 4 * g)),))
               .astype(np.int32) for _ in range(6)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]

    _, tout = _run_both(models, reqs, max_slots=3, max_len=6 * g,
                        prefill_chunk=g)
    assert all(r.done_tokens == 6 for r in tout["requests"])
    assert tout["prefill_tokens_computed"] >= sum(len(p) for p in prompts)
    kinds = [e[0] for e in _events(tout)]
    # a decode token lands between two admissions' first tokens
    assert kinds.index("token") < len(kinds) - kinds[::-1].index(
        "first_token") - 1


def test_prefill_budget_of_three_chunks_matches_jax(models):
    """``prefill_budget`` above one chunk: up to three chunks a cycle before
    the decode step, as the JAX engine schedules them (a burst)."""
    cfg = models[2]
    g = cfg.quant.group_size
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (int(rng.integers(8, 4 * g)),))
               .astype(np.int32) for _ in range(6)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]

    _, one = _run_both(models, reqs, max_slots=3, max_len=6 * g,
                       prefill_chunk=g)
    _, three = _run_both(models, reqs, max_slots=3, max_len=6 * g,
                         prefill_chunk=g, prefill_budget=3 * g)
    assert _streams(three) == _streams(one)
    assert three["decode_steps"] < one["decode_steps"]


def test_chunk_window_overrunning_row_matches_jax(models):
    """``tests/test_prefix_cache.py:552``: 5-page rows with 2-page chunks —
    the final chunk's window overruns the row; the streams must not
    depend on the pool capacity."""
    cfg = models[2]
    g = cfg.quant.group_size
    prompt = np.random.default_rng(11).integers(
        0, cfg.vocab_size, (4 * g + 7,)).astype(np.int32)
    outs = []
    for pages_per_slot in (5, 8):
        _, tout = _run_both(
            models, lambda cls: [cls(rid=0, prompt=prompt.copy(),
                                     max_new_tokens=4)],
            max_slots=2, max_len=pages_per_slot * g, prefill_chunk=2 * g)
        outs.append(_streams(tout))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("n_prefixes,num_pages,evicts", [(1, 10, False),
                                                         (3, 7, True)])
def test_eviction_pressure_matches_jax(models, n_prefixes, num_pages,
                                       evicts):
    """``tests/test_prefix_cache.py:574`` (one prefix, 10 pages), and the
    same shape with three rotating prefixes in 7 pages, where admissions
    must evict index-only pages: sharing degrades, never deadlocks, and
    both engines evict the same entries."""
    cfg = models[2]
    g = cfg.quant.group_size
    _, tout = _run_both(
        models, _shared_prefix_requests(cfg, 5, 2, seed=3,
                                        n_prefixes=n_prefixes),
        max_slots=2, max_len=6 * g, num_pages=num_pages, prefix_cache=True,
        prefill_chunk=g)
    assert all(r.done_tokens == r.max_new_tokens for r in tout["requests"])
    assert (tout["prefix_index"]["evictions"] > 0) == evicts


def test_streaming_engine_matches_batch_run(models):
    """``StreamingEngine`` over the port's core on the shared-prefix
    workload: the event stream passes ``check_event_stream`` and the
    streamed tokens equal the batch result."""
    cfg, tm, tp = models[2], models[3], models[4]
    make = _paged_prefill_workload(cfg.vocab_size)
    kw = dict(max_slots=3, max_len=192, prefill_chunk=32, prefix_cache=True,
              device="cpu")
    batch = ContinuousBatchingEngine(tm, tp, **kw).run(make(Request))
    eng = StreamingEngine(ContinuousBatchingEngine(tm, tp, **kw))
    reqs = make(Request)
    for r in reqs:
        eng.submit(r)
    events = list(eng.events())
    terminal = check_event_stream(events)
    assert terminal == {r.rid: "finish" for r in reqs}
    streamed: dict = {}
    for e in events:
        if e.kind in ("first_token", "token"):
            streamed.setdefault(e.rid, []).append(e.token)
    assert streamed == _streams(batch)
    stats = stream_latency_stats(events, reqs)
    assert stats["ttft_s"]["n"] == len(reqs)
    assert stats["itl_s"]["n"] == sum(len(t) - 1 for t in streamed.values())
    assert eng.result()["adopted_pages"] == batch["adopted_pages"] > 0


def test_streaming_cancel_mid_prefill_keeps_index_pages(models):
    """A request cancelled mid-prefill through ``StreamingEngine`` releases
    its slot and its own pages at once; the prefix pages it adopted stay
    pinned by the index, and the session completes the rest."""
    cfg, tm, tp = models[2], models[3], models[4]
    g = cfg.quant.group_size
    eng = StreamingEngine(ContinuousBatchingEngine(
        tm, tp, max_slots=2, max_len=8 * g, prefix_cache=True,
        prefill_chunk=g, device="cpu"))
    core = eng.core
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, (3 * g,)).astype(np.int32)
    donor = eng.add_request(np.concatenate([shared, [1, 2, 3]]), 4)
    events = list(eng.events())                 # the donor registers pages
    pinned = list(core.prefix.pages)
    assert len(pinned) == 3
    victim = eng.add_request(
        np.concatenate([shared, rng.integers(0, cfg.vocab_size, (2 * g,))]),
        4)
    other = eng.add_request(np.concatenate([shared, [4, 5]]), 3)
    while not any(e.kind == "admit" and e.rid == victim for e in events):
        events += eng.step()
    assert victim in {r.rid for r in core.sched.active.values()}
    assert any(r.rid == victim for r in core.sched.active.values()
               if r.prefix_hit_tokens == 3 * g)
    free = core.sched.alloc.free_pages
    assert eng.cancel(victim) and not eng.cancel(victim)
    assert core.sched.alloc.free_pages > free
    assert all(core.sched.alloc.refcount(p) >= 1 for p in pinned)
    events += list(eng.events())
    terminal = check_event_stream(events)
    assert terminal == {donor: "finish", victim: "cancel", other: "finish"}
    res = eng.result()
    assert res["n_cancelled"] == 1
    assert {r.rid for r in res["requests"]} == {donor, other}


def test_cancel_invalidates_hash_memo_across_rid_reuse():
    """Port of ``tests/test_streaming.py``'s scheduler case: cancelling a
    pending request reports slot -1, not active, no freed page, and drops
    its memoized prefix hashes — a later request reusing the rid with an
    equal-length but different prompt does not adopt the cancelled
    prompt's pages."""
    from repro_torch.serve.scheduler import Scheduler
    lay = tcl.PagedLayout(page_size=4, num_pages=16, slots=2,
                          pages_per_slot=8)
    sched = Scheduler(lay, prefix_index=tcl.PrefixIndex(lay, 4),
                      chunk_tokens=4)
    prompt_a = np.arange(12, dtype=np.int32)
    donor = Request(rid=0, prompt=prompt_a)
    sched.submit(donor)
    assert sched.admissible() is donor
    slot = sched.admit(donor)
    sched.register_prefix(slot)     # prompt A's pages enter the index
    sched.finish(slot)
    # rid 5 with prompt A polls admission (hashes memoized), then cancels
    req_a = Request(rid=5, prompt=prompt_a.copy())
    sched.submit(req_a)
    assert sched.admissible() is req_a
    summary = sched.cancel(5)
    assert summary.req is req_a and summary.slot == -1
    assert not summary.was_active and summary.freed_pages == 0
    # rid 5 reused: same length, different tokens — must miss the index
    req_b = Request(rid=5, prompt=np.arange(100, 112, dtype=np.int32))
    sched.submit(req_b)
    assert sched.admissible() is req_b
    sched.admit(req_b)
    assert req_b.prefix_hit_tokens == 0


def test_active_cancel_summary_counts_freed_pages_like_jax():
    """Active cancels over shared prefix pages: a slot that adopted index
    pages frees only its own, a donor whose pages another slot still maps
    frees fewer than it held, a pending cancel frees none — ``slot``,
    ``was_active`` and ``freed_pages`` of every summary equal the JAX
    scheduler's on the same sequence, and so does the allocator."""
    from repro.serve.scheduler import Scheduler as JScheduler
    from repro_torch.serve.scheduler import Scheduler
    kw = dict(page_size=4, num_pages=24, slots=3, pages_per_slot=8)
    lay, jlay = tcl.PagedLayout(**kw), jcl.PagedLayout(**kw)
    sched = Scheduler(lay, prefix_index=tcl.PrefixIndex(lay, 8),
                      chunk_tokens=8)
    jsched = JScheduler(jlay, prefix_index=jcl.PrefixIndex(jlay, 8),
                        chunk_tokens=8)
    shared = np.arange(16, dtype=np.int32)

    def prompt(i, tail):
        return np.concatenate([shared, np.arange(100 * i, 100 * i + tail,
                                                 dtype=np.int32)])

    def both(fn):
        a, b = fn(sched, Request), fn(jsched, JRequest)
        return a, b

    def admit(rid, tail):
        def fn(sc, cls):
            r = cls(rid=rid, prompt=prompt(rid, tail))
            sc.submit(r)
            assert sc.admissible() is r
            return sc.admit(r)
        return both(fn)

    def cancel(rid):
        a, b = both(lambda sc, cls: sc.cancel(rid))
        assert (a.slot, a.was_active, a.freed_pages) == \
            (b.slot, b.was_active, b.freed_pages), rid
        assert a.req.rid == rid
        return a

    s0, _ = admit(0, 5)
    both(lambda sc, cls: sc.register_prefix(s0))   # 2 shared chunks pinned
    admit(1, 9)                                    # adopts the donor's pages
    admit(2, 3)
    donor = cancel(0)                # pages pinned by the index survive
    assert donor.was_active and donor.slot == s0
    assert 0 < donor.freed_pages < lay.pages_for(16 + 5 + 1)
    both(lambda sc, cls: sc.submit(cls(rid=3, prompt=prompt(3, 4))))
    pend = cancel(3)
    assert pend.slot == -1 and not pend.was_active and pend.freed_pages == 0
    adopter = cancel(1)             # frees only its own, not the adopted
    assert adopter.was_active and adopter.freed_pages > 0
    assert cancel(2).freed_pages == lay.pages_for(16 + 3 + 1) - 4
    assert sched.cancel(7) is None and jsched.cancel(7) is None
    assert _alloc_state(sched.alloc) == _alloc_state(jsched.alloc)


@pytest.mark.parametrize("prefix_cache,chunk", [(True, 0), (False, 5),
                                                (True, 33), (False, 64)])
def test_chunk_size_rounds_like_jax(models, prefix_cache, chunk):
    """The chunk the engine runs: page-aligned upwards, and two pages when
    the prefix cache is on and no chunk is given — as the JAX engine."""
    jm, jp, _, tm, tp = models
    want = JEngine(jm, jp, max_len=128, prefix_cache=prefix_cache,
                   prefill_chunk=chunk).prefill_chunk
    got = ContinuousBatchingEngine(tm, tp, max_len=128,
                                   prefix_cache=prefix_cache,
                                   prefill_chunk=chunk, device="cpu")
    assert got.prefill_chunk == want > 0


def test_negative_chunk_raises(models):
    tm, tp = models[3], models[4]
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousBatchingEngine(tm, tp, prefill_chunk=-1, device="cpu")


def test_chunked_engine_requires_paged_prefill_codec(models, monkeypatch):
    """A codec without a page-native chunk prefill is served chunked all
    the same: its capability flag sends every chunk through the gathering
    ``chunk_prefill_attention``, as JAX dispatches (the engine no longer
    refuses it), with the page-native run's greedy streams."""
    from repro_torch.core import paged_cache as tpg
    from repro_torch.core.codecs import PolarCodec
    tm, tp = models[3], models[4]
    reqs = _paged_prefill_workload(models[2].vocab_size)
    kw = dict(max_slots=3, max_len=192, prefill_chunk=32, prefix_cache=True)
    native = ContinuousBatchingEngine(tm, tp, device="cpu", **kw).run(
        reqs(Request), GenerationConfig())
    monkeypatch.setattr(PolarCodec, "supports_paged_prefill", False)
    calls = []
    gathered = tpg.chunk_prefill_attention
    monkeypatch.setattr(tpg, "chunk_prefill_attention",
                        lambda *a, **k: calls.append(1) or gathered(*a, **k))
    monkeypatch.setattr(PolarCodec, "paged_prefill", None)   # never called
    out = ContinuousBatchingEngine(tm, tp, device="cpu", **kw).run(
        reqs(Request), GenerationConfig())
    assert len(calls) == out["prefills"] * tm.cfg.num_layers > 0
    assert _streams(out) == _streams(native)
    assert out["adopted_pages"] == native["adopted_pages"] > 0


def test_cow_guard_splits_a_shared_write_page(models):
    """The copy-on-write guard: when the page a decode append would write
    is shared (here pinned by an outside holder), the engine remaps the
    slot to a fresh page, copies the pool bytes and appends there — the
    greedy stream is that of a run without the pin, and the pinned page
    keeps its bytes."""
    cfg, tm, tp = models[2], models[3], models[4]
    g = cfg.quant.group_size
    prompt = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (g + 5,)).astype(np.int32)

    def run(pin: bool):
        eng = StreamingEngine(ContinuousBatchingEngine(
            tm, tp, max_slots=1, max_len=4 * g, prefix_cache=True,
            device="cpu"))
        core = eng.core
        rid = eng.add_request(prompt, 8)
        events = []
        while not any(e.kind == "token" for e in events):
            events += eng.step()
        if pin:
            slot = core.sched.active[0].slot
            pidx = int(core._lengths[slot]) // g
            page = core.sched.alloc.page_at(slot, pidx)
            core.sched.alloc.incref(page)
            before = [c.value_fp[page].clone() for c in core.state]
        events += list(eng.events())
        out = [e.token for e in events
               if e.rid == rid and e.kind in ("first_token", "token")]
        if pin:
            assert core.cow_splits == 1
            assert core.sched.alloc.refcount(page) == 1   # the pin alone
            for c, b in zip(core.state, before):
                assert torch.equal(c.value_fp[page], b)
        return out

    assert run(pin=True) == run(pin=False)
