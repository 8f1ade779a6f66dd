"""Speculative multi-token decode in the port (DESIGN.md §15), on the CPU
at smoke width, held to the JAX package.

``EngineCore(spec=...)`` must give the streams of plain greedy decode with
any proposer, on both verifiers: the span verifier (``"jnp"`` decode
backend) and the scan verifier on its shadow state (``"paged_fused"``,
the port's default). Against the JAX engine (params carried across from
``m.init(jax.random.PRNGKey(0))``): greedy streams, ``result()["spec"]``
counts and event sequences for ``ngram`` and ``draft``, the all-rejected,
all-accepted and EOS-inside-span cases (``tests/test_spec_decode.py:
186-241``), cancel and preempt mid-speculation with allocator invariants,
and ``span_verify_attention`` / ``paged_append_span`` on numpy inputs.
Inside the port: span verifier == scan verifier on the committed state,
bit for bit; the draft rewind resets ``host_length``; ``runahead=4``
with spec keeps the spec streams; a failing proposer is counted, never
fatal; CPU runs launch no kernel. Every request arrives at t = 0: the
engine clock counts measured compute time, so staggered arrivals would
make the schedule follow the machine's speed. On the CPU every verify
runs eagerly; ``tests/test_torch_cuda.py`` holds the captured verify
graphs to their eager runs on the card."""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the tests do not crowd
# the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import cache_layout as jcl  # noqa: E402
from repro.core import paged_cache as jpg  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.spec.draft import _derive_draft_cfg as j_derive  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import cache_layout as tcl  # noqa: E402
from repro_torch.core import paged_cache as tpg  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, EngineCore, GenerationConfig, Request,
    StreamingEngine, check_event_stream,
)
from repro_torch.serve.graphs import read_counters  # noqa: E402
from repro_torch.spec import (  # noqa: E402
    DraftModelProposer, DraftProposer, NgramProposer, SpecConfig,
    list_proposers, make_proposer, make_scan_verifier, make_span_verifier,
    make_verifier, register_proposer,
)
from repro_torch.spec.draft import _derive_draft_cfg  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402
from test_prefix_cache import check_alloc_invariants  # noqa: E402

#: the two verifiers and the decode backend that selects each
VERIFIERS = {"span": "jnp", "scan": "paged_fused"}
SCRIPTED = "scripted-port-parity"


class _Scripted(DraftProposer):
    """Proposes a scripted continuation per rid: an oracle when fed the
    plain streams, an adversary when fed anything else."""

    name = SCRIPTED
    script: dict = {}

    def propose(self, req, k):
        s = self.script.get(req.rid, [])
        pos = len(req.out_tokens)
        return [int(t) for t in s[pos:pos + k]]


class _JScripted(jspec.DraftProposer):
    name = SCRIPTED

    def propose(self, req, k):
        return _Scripted.propose(self, req, k)

    @property
    def script(self):
        return _Scripted.script


register_proposer(_Scripted, overwrite=True)
jspec.register_proposer(_JScripted, overwrite=True)


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduce(j_get_config("tinyllama-1.1b"))        # decodes on "jnp"
    jm = j_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tms = {v: get_model(dataclasses.replace(cfg, decode_backend=b))
           for v, b in VERIFIERS.items()}
    # the draft proposer's weights, carried across like the target's
    dspec = SpecConfig(mode="draft", k=2)
    djp = j_get_model(j_derive(jcfg, dspec)).init(
        jax.random.PRNGKey(dspec.draft_seed))
    dtp = params_from_jax(jax.tree.map(np.asarray, djp),
                          _derive_draft_cfg(cfg, dspec), device="cpu")
    return {"jm": jm, "jp": jp, "cfg": cfg, "tp": tp, "tms": tms,
            "draft_params": dtp, "jax_runs": {}}


def _prompts(vocab, n=4, seed=3):
    """Single-token prompts (``tests/test_spec_decode.py``): greedy
    continuations fall into short cycles, giving ngram real acceptance."""
    rng = np.random.RandomState(seed)
    return [np.full((36,), rng.randint(0, vocab), np.int32)
            for _ in range(n)]


def _reqs(cls, prompts, max_new):
    return [cls(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _streams(out):
    return {r.rid: list(r.out_tokens) for r in out["requests"]}


def _events(events):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token, e.span, e.span_ix)
            for e in events]


def _spec_counts(out):
    sp = out.get("spec")
    return None if sp is None else (sp["steps"], sp["drafted_tokens"],
                                    sp["accepted_tokens"])


def _jax_run(models, key, prompts, max_new, spec=None, gen=None, **kw):
    """The JAX engine's result for one workload, cached per key."""
    runs = models["jax_runs"]
    if key not in runs:
        kw.setdefault("max_slots", 2)
        kw.setdefault("max_len", 128)
        jspec_cfg = None if spec is None else jspec.SpecConfig(
            **dataclasses.asdict(spec))
        eng = jserve.ContinuousBatchingEngine(models["jm"], models["jp"],
                                              spec=jspec_cfg, **kw)
        runs[key] = eng.run(_reqs(jserve.Request, prompts, max_new),
                            jserve.GenerationConfig(**(gen or {})))
    return runs[key]


def _port_engine(models, verifier, spec=None, cls=ContinuousBatchingEngine,
                 **kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_len", 128)
    eng = cls(models["tms"][verifier], models["tp"], spec=spec,
              device="cpu", **kw)
    core = eng.core if hasattr(eng, "core") else eng
    if spec is not None and spec.mode == "draft":
        core._proposer.params = models["draft_params"]
    return eng


def _port_run(models, verifier, prompts, max_new, spec=None, gen=None,
              **kw):
    eng = _port_engine(models, verifier, spec, **kw)
    return eng.run(_reqs(Request, prompts, max_new),
                   GenerationConfig(**(gen or {})))


def _assert_matches_jax(tout, jout):
    assert _streams(tout) == _streams(jout)
    assert _events(tout["events"]) == _events(jout["events"])
    assert _spec_counts(tout) == _spec_counts(jout)
    assert tout["decode_steps"] == jout["decode_steps"]
    assert tout["proposer_faults"] == jout["proposer_faults"] == 0


# ---------------------------------------------------------------------------
# Greedy streams, spec counts and events against the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
def test_streams_and_spec_counts_match_jax(models, verifier):
    """Plain, ngram (k 4) and draft (k 2) runs: the port's streams, spec
    counts and event sequences equal the JAX engine's, every spec stream
    equals the plain one, and no kernel launched on the CPU."""
    prompts = _prompts(models["cfg"].vocab_size)
    # 36-token prompts + 32 tokens: every stream crosses the group
    # boundary at 64 inside a commit
    base = _jax_run(models, "plain", prompts, 32)
    before = read_counters()
    tbase = _port_run(models, verifier, prompts, 32)
    _assert_matches_jax(tbase, base)
    for mode, k in (("ngram", 4), ("draft", 2)):
        spec = SpecConfig(mode=mode, k=k)
        jout = _jax_run(models, mode, prompts, 32, spec)
        tout = _port_run(models, verifier, prompts, 32, spec)
        assert _streams(tout) == _streams(base), f"{mode} diverged"
        _assert_matches_jax(tout, jout)
        assert tout["spec"]["steps"] > 0 and \
            tout["spec"]["accepted_tokens"] > 0
        assert tout["spec"]["mode"] == mode and tout["spec"]["k"] == k
        assert max(e.span for e in tout["events"]) > 1
        check_event_stream(tout["events"])
    assert read_counters() == before      # CPU tensors launch nothing


# ---------------------------------------------------------------------------
# Acceptance boundaries: all rejected, all accepted, EOS inside a span
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
@pytest.mark.parametrize("case", ["rejected", "accepted", "eos"])
def test_acceptance_boundaries_match_jax(models, case, verifier):
    vocab = models["cfg"].vocab_size
    prompts = _prompts(vocab, n=3)
    new = 16 if case == "eos" else 12
    base = _streams(_jax_run(models, f"plain{new}", prompts, new))
    gen, k = {}, 3
    if case == "rejected":
        # every draft is the target argmax + 1: guaranteed rejection
        _Scripted.script = {rid: [(t + 1) % vocab for t in ts]
                            for rid, ts in base.items()}
    else:
        _Scripted.script = base
    if case == "eos":
        # an eos id that appears mid-output of some request
        eos = next(t for ts in base.values() for t in ts[2:-2])
        gen, k = {"eos_id": int(eos)}, 4
        base = _streams(_jax_run(models, "plain-eos", prompts, new,
                                 gen=gen))
    spec = SpecConfig(mode=SCRIPTED, k=k)
    jout = _jax_run(models, case, prompts, new, spec, gen)
    tout = _port_run(models, verifier, prompts, new, spec, gen)
    assert _streams(tout) == base
    _assert_matches_jax(tout, jout)
    sp = tout["spec"]
    assert sp["drafted_tokens"] > 0
    if case == "rejected":
        assert sp["accepted_tokens"] == 0
    if case == "accepted":
        assert sp["accepted_tokens"] == sp["drafted_tokens"]
        assert sp["mean_accepted_per_step"] > 1.0
    if case == "eos":
        assert any(len(base[r]) < new for r in base)
        for ts in _streams(tout).values():
            assert gen["eos_id"] not in ts[:-1]   # nothing past EOS


# ---------------------------------------------------------------------------
# Cancel / preempt mid-speculation + allocator invariants
# ---------------------------------------------------------------------------


def _stream_session(core, reqs, gen_cls, cancel_rid=None):
    """Drive ``core`` through a StreamingEngine, checking the allocator
    after every step; cancel ``cancel_rid`` the moment a multi-token span
    lands for it. Returns (events, result, preempts)."""
    api = StreamingEngine if isinstance(core, EngineCore) else \
        jserve.StreamingEngine
    stream = api(core, gen_cls())
    for r in reqs:
        stream.submit(r)
    events, cancelled, steps = [], False, 0
    while stream.has_work:
        evs = stream.step()
        events += evs
        check_alloc_invariants(core.sched.alloc)
        if cancel_rid is not None and not cancelled and any(
                e.kind == "token" and e.rid == cancel_rid and e.span > 1
                for e in evs):
            assert stream.cancel(cancel_rid)
            cancelled = True
            check_alloc_invariants(core.sched.alloc)
        steps += 1
        assert steps < 4000
    if cancel_rid is not None:
        assert cancelled, "no speculative span ever landed"
    return events, stream.result()


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
def test_cancel_mid_spec_matches_jax(models, verifier):
    prompts = _prompts(models["cfg"].vocab_size)
    spec = SpecConfig(mode="ngram", k=4)
    if "cancel" not in models["jax_runs"]:
        jcore = jserve.EngineCore(models["jm"], models["jp"], max_slots=2,
                                  max_len=128,
                                  spec=jspec.SpecConfig(mode="ngram", k=4))
        models["jax_runs"]["cancel"] = _stream_session(
            jcore, _reqs(jserve.Request, prompts, 24),
            jserve.GenerationConfig, cancel_rid=1)
    jevents, jres = models["jax_runs"]["cancel"]
    core = _port_engine(models, verifier, spec, cls=EngineCore)
    events, res = _stream_session(core, _reqs(Request, prompts, 24),
                                  GenerationConfig, cancel_rid=1)
    assert _events(events) == _events(jevents)
    assert _streams(res) == _streams(jres)
    assert set(_streams(res)) == {0, 2, 3}
    plain = _streams(_jax_run(models, "plain24", prompts, 24))
    for rid, ts in _streams(res).items():
        assert ts == plain[rid]           # survivors keep the plain streams


@pytest.mark.parametrize("verifier", sorted(VERIFIERS))
def test_preempt_mid_spec_matches_jax(models, verifier):
    """An oversubscribed pool (3 slots growing to 3 pages each, 6 pages)
    forces recompute-preemption with spans in flight."""
    g = models["cfg"].quant.group_size
    prompts = _prompts(models["cfg"].vocab_size)
    kw = dict(max_slots=3, max_len=4 * g, num_pages=6)
    spec = SpecConfig(mode="ngram", k=4)
    if "preempt" not in models["jax_runs"]:
        jcore = jserve.EngineCore(models["jm"], models["jp"],
                                  spec=jspec.SpecConfig(mode="ngram", k=4),
                                  **kw)
        models["jax_runs"]["preempt"] = _stream_session(
            jcore, _reqs(jserve.Request, prompts, 40),
            jserve.GenerationConfig)
    jevents, jres = models["jax_runs"]["preempt"]
    core = _port_engine(models, verifier, spec, cls=EngineCore, **kw)
    events, res = _stream_session(core, _reqs(Request, prompts, 40),
                                  GenerationConfig)
    assert sum(e.kind == "preempt" for e in events) > 0, "pool not tight"
    assert _events(events) == _events(jevents)
    assert _streams(res) == _streams(jres)
    plain = _streams(_jax_run(models, "plain-tight", prompts, 40, **kw))
    assert _streams(res) == plain


# ---------------------------------------------------------------------------
# span_verify_attention / paged_append_span against the JAX functions
# ---------------------------------------------------------------------------


# one compile each instead of op-by-op dispatch of the eager JAX functions
_J_PREFILL = jax.jit(jpg.paged_prefill)
_J_SPAN = jax.jit(jpg.span_verify_attention)
_J_APPEND = jax.jit(jpg.paged_append_span)


def _span_caches(value_bits):
    """The same prefilled paged cache in both packages: 4 slots at lengths
    32, 29, 47 and 20 (``lengths % g`` = 0, g - Q, g - 1 and 4 at g 16,
    Q 3)."""
    h, d, g, s, n = 2, 32, 16, 4, 4
    kw = dict(page_size=g, num_pages=s * n, slots=s, pages_per_slot=n)
    jc = jpg.init_paged_cache(JQuantConfig(group_size=g,
                                           value_bits=value_bits),
                              jcl.PagedLayout(**kw), h, d,
                              dtype=jnp.float32)
    tc = tpg.init_paged_cache(QuantConfig(group_size=g,
                                          value_bits=value_bits),
                              tcl.PagedLayout(**kw), h, d,
                              dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(4)
    table = rng.permutation(s * n).astype(np.int32).reshape(s, n)
    for sl, ln in enumerate((32, 29, 47, 20)):
        k = rng.standard_normal((1, h, n * g, d)).astype(np.float32)
        v = rng.standard_normal((1, h, n * g, d)).astype(np.float32)
        jc = _J_PREFILL(jc, jnp.asarray(sl), jnp.asarray(table[sl]),
                        jnp.asarray(k), jnp.asarray(v), jnp.asarray(ln))
        tpg.paged_prefill(tc, sl, torch.from_numpy(table[sl]),
                          torch.from_numpy(k), torch.from_numpy(v), ln)
    return jc, tc, table, rng


@pytest.mark.parametrize("value_bits", [0, 4])
def test_span_attention_and_append_span_match_jax(value_bits):
    q_n, hq = 3, 4
    jc, tc, table, rng = _span_caches(value_bits)
    s, h, g, d = tc.key_residual.shape
    q = rng.standard_normal((s, hq, q_n, d)).astype(np.float32)
    ks = rng.standard_normal((s, h, q_n, d)).astype(np.float32)
    vs = rng.standard_normal((s, h, q_n, d)).astype(np.float32)
    want = _J_SPAN(jc, jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs),
                   jnp.asarray(table))
    got = tpg.span_verify_attention(tc, torch.from_numpy(q),
                                    torch.from_numpy(ks),
                                    torch.from_numpy(vs),
                                    torch.from_numpy(table))
    assert got.shape == (s, hq, q_n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    # commit: 3 rows at r0 0, 3 at g - Q (flushes), 1 at g - 1 (flushes),
    # none on the last slot
    n_keep = np.array([3, 3, 1, 0], np.int32)
    jc2 = _J_APPEND(jc, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(table),
                    jnp.asarray(n_keep))
    tpg.paged_append_span(tc, torch.from_numpy(ks), torch.from_numpy(vs),
                          torch.from_numpy(table), torch.from_numpy(n_keep))
    live = slice(0, tc.layout.num_pages)           # the scratch page aside
    np.testing.assert_array_equal(tc.lengths.numpy(),
                                  np.asarray(jc2.lengths))
    np.testing.assert_array_equal(tc.lengths.numpy(), [35, 32, 48, 20])
    np.testing.assert_array_equal(tc.key_codes.numpy()[live],
                                  np.asarray(jc2.key_codes)[live])
    # key stats: float32 sqrt/atan2 mins and maxes, ulps apart between
    # the libraries (tests/test_torch_paged_cache.py)
    for name, pool in tc.key_scales.items():
        np.testing.assert_allclose(pool.numpy()[live],
                                   np.asarray(jc2.key_scales[name])[live],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tc.key_residual.float().numpy(),
        np.asarray(jc2.key_residual.astype(jnp.float32)))
    if value_bits:
        # one float32 ulp apart in the scales, so codes within one step
        codes = tc.value_codes.numpy()[live].astype(int)
        assert np.abs(codes - np.asarray(jc2.value_codes)[live]).max() <= 1
        for name in ("value_scale", "value_zero"):
            np.testing.assert_allclose(
                getattr(tc, name).numpy()[live],
                np.asarray(getattr(jc2, name))[live], rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(tc.value_fp.numpy()[live],
                                      np.asarray(jc2.value_fp)[live])


def test_append_span_equals_sequential_appends():
    """One fused span commit leaves the bytes ``n_keep`` masked
    ``paged_append`` calls leave (the scratch page aside)."""
    jc, tc, table, rng = _span_caches(0)
    del jc
    s, h, g, d = tc.key_residual.shape
    ks = torch.from_numpy(rng.standard_normal((s, h, 3, d)).astype(
        np.float32))
    vs = torch.from_numpy(rng.standard_normal((s, h, 3, d)).astype(
        np.float32))
    n_keep = torch.tensor([3, 3, 1, 0], dtype=torch.int32)
    tab = torch.from_numpy(table)
    seq = copy.deepcopy(tc)
    tpg.paged_append_span(tc, ks, vs, tab, n_keep)
    for j in range(3):
        tpg.paged_append(seq, ks[:, :, j:j + 1], vs[:, :, j:j + 1], tab,
                         n_keep > j)
    live = slice(0, tc.layout.num_pages)
    for a, b in zip(tpg._state_buffers(tc), tpg._state_buffers(seq)):
        if a.shape[0] == tc.layout.pool_pages:
            a, b = a[live], b[live]
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Span verifier == scan verifier, committed bytes included
# ---------------------------------------------------------------------------


def test_span_scan_verifier_parity(models):
    """``tests/test_spec_decode.py:113-165``: the span verifier reproduces
    the scan verifier bit for bit — predictions, acceptance counts and
    every committed cache byte outside the scratch page — for spans
    inside the slot's current group, on the ``"jnp"`` backend both
    share."""
    cfg, m, params = models["cfg"], models["tms"]["span"], models["tp"]
    g = cfg.quant.group_size
    s, n = 2, 4
    layout = tcl.PagedLayout(page_size=g, num_pages=s * n, slots=s,
                             pages_per_slot=n)
    pp = layout.pool_pages
    scan_v, span_v = make_scan_verifier(m), make_span_verifier(m)
    assert make_verifier(m) is not None and \
        make_verifier(m).kind == "span" and \
        make_verifier(models["tms"]["scan"]).kind == "scan"
    rng = np.random.RandomState(0)
    table = torch.arange(s * n, dtype=torch.int32).reshape(s, n)
    for plen in (33, 47):
        state = m.init_paged_state(layout, "cpu")
        toks = np.zeros((s, -(-plen // g) * g), np.int64)
        toks[:, :plen] = rng.randint(0, cfg.vocab_size, (s, plen))
        for sl in range(s):
            logits, _ = m.prefill_paged(params, torch.from_numpy(
                toks[sl:sl + 1]), state, sl, table[sl], plen)
            nxt = int(torch.argmax(logits, -1)[0])
        for q in (1, 2, 3):
            span = np.zeros((s, q), np.int64)
            span[:, 0] = nxt
            span[:, 1:] = rng.randint(0, cfg.vocab_size, (s, q - 1))
            args = (torch.from_numpy(span),
                    torch.full((s,), q - 1, dtype=torch.int32), table,
                    torch.ones((s,), dtype=torch.bool))
            c1, c2 = copy.deepcopy(state), copy.deepcopy(state)
            p1, n1, _ = scan_v(params, c1, *args)
            p2, n2, _ = span_v(params, c2, *args)
            assert torch.equal(p1, p2), f"preds plen={plen} q={q}"
            assert torch.equal(n1, n2), f"n_acc plen={plen} q={q}"
            for a, b in zip(c1, c2):
                for x, y in zip(tpg._state_buffers(a), tpg._state_buffers(b)):
                    if x.shape[0] == pp:
                        x, y = x[:pp - 1], y[:pp - 1]
                    assert torch.equal(x, y), f"cache plen={plen} q={q}"
            # the accepted span advanced every slot by n_acc + 1
            assert torch.equal(c1[0].lengths - state[0].lengths, n1 + 1)


# ---------------------------------------------------------------------------
# The draft rewind, run-ahead with spec, faults and config checks
# ---------------------------------------------------------------------------


def test_draft_rewind_resets_host_length(models):
    """A grouped draft (``draft_arch="self"``: the polar-cached target)
    appends its k guesses to its dense cache and rewinds after each
    proposal. The rewind must reset the cache's ``host_length`` (which
    places the next append and decides the group flush) with its device
    ``length``, or the next absorb appends at the wrong rows and later
    proposals differ from a fresh proposer's. (The rollouts stay inside
    the first group: one that crosses a boundary overwrites residual rows
    the rewind cannot restore, in JAX as here, so only draft quality, not
    the stream, may change there.)"""
    cfg, m, params = models["cfg"], models["tms"]["scan"], models["tp"]
    g = cfg.quant.group_size
    spec = SpecConfig(mode="draft", k=4, draft_arch="self")

    def proposer():
        return make_proposer(spec, target_cfg=cfg, target_model=m,
                             target_params=params, max_len=128)

    prop = proposer()
    assert isinstance(prop, DraftModelProposer)
    rng = np.random.RandomState(7)
    req = Request(rid=0, prompt=rng.randint(0, cfg.vocab_size, (g - 12,))
                  .astype(np.int32), max_new_tokens=16)
    for _ in range(3):
        d = prop.propose(req, 4)
        n = req.context_len
        assert n + len(d) < g
        for c in prop._by_rid[0]["caches"]:
            assert c.host_length == n and int(c.length) == n
        assert proposer().propose(req, 4) == d
        req.out_tokens.extend(d[:2])


def test_runahead_with_spec_keeps_spec_streams(models):
    """``runahead=4`` with spec: the horizon planner stays off (drafts are
    proposed per step), so the streams and spec counts are the spec
    run's."""
    prompts = _prompts(models["cfg"].vocab_size)
    spec = SpecConfig(mode="ngram", k=4)
    ref = _port_run(models, "scan", prompts, 16, spec)
    out = _port_run(models, "scan", prompts, 16, spec, runahead=4)
    assert _streams(out) == _streams(ref)
    assert _spec_counts(out) == _spec_counts(ref)
    assert out["runahead"]["horizons"] == 0


class _Failing(DraftProposer):
    name = "failing-port-test"

    def propose(self, req, k):
        raise RuntimeError("proposer fault")


register_proposer(_Failing, overwrite=True)


def test_proposer_fault_counted_never_fatal(models):
    prompts = _prompts(models["cfg"].vocab_size, n=2)
    out = _port_run(models, "scan", prompts, 8,
                    SpecConfig(mode="failing-port-test", k=2))
    plain = _port_run(models, "scan", prompts, 8)
    assert _streams(out) == _streams(plain)
    assert out["proposer_faults"] > 0 and out["spec"]["steps"] == 0
    assert plain["proposer_faults"] == 0 and "spec" not in plain


def test_spec_requires_greedy_and_validates(models):
    core = _port_engine(models, "scan", SpecConfig(mode="ngram"),
                        cls=EngineCore)
    with pytest.raises(ValueError, match="greedy"):
        core.reset(GenerationConfig(temperature=0.7))
    with pytest.raises(ValueError):
        SpecConfig(mode="ngram", k=0)
    with pytest.raises(ValueError):
        SpecConfig(mode="ngram", min_ngram=3, max_ngram=2)
    with pytest.raises(KeyError):
        make_proposer(SpecConfig(mode="no-such-proposer"))
    assert {"ngram", "draft"} <= set(list_proposers())
    off = _port_engine(models, "scan", SpecConfig(mode="off"),
                       cls=EngineCore)
    assert off.spec is None


def test_spec_q_buckets_match_jax(models):
    """Span-width buckets: 1 + pow2 draft counts, capped at k + 1 and the
    group size (``repro/serve/core.py:533-552``)."""
    for k in (1, 2, 3, 4, 7, 40):
        spec = SpecConfig(mode="ngram", k=k)
        ours = _port_engine(models, "scan", spec, cls=EngineCore)
        theirs = jserve.EngineCore.__new__(jserve.EngineCore)
        theirs.spec, theirs.layout = jspec.SpecConfig(mode="ngram", k=k), \
            ours.layout
        assert ours._spec_q_buckets() == theirs._spec_q_buckets()
        for need in range(1, k + 2):
            assert ours._spec_q(need) == theirs._spec_q(need)


def test_ngram_proposer_matches_jax():
    """The copied proposer: identical proposals and feedback ramps on one
    growing context."""
    ours = make_proposer(SpecConfig(mode="ngram", k=4))
    theirs = jspec.make_proposer(jspec.SpecConfig(mode="ngram", k=4))
    assert isinstance(ours, NgramProposer)
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, 6, (12,)).astype(np.int32)
    r1 = Request(rid=5, prompt=prompt, max_new_tokens=64)
    r2 = jserve.Request(rid=5, prompt=prompt, max_new_tokens=64)
    for step in range(40):
        a, b = ours.propose(r1, 4), theirs.propose(r2, 4)
        assert a == b, step
        acc = step % 3
        ours.feedback(5, len(a), min(acc, len(a)))
        theirs.feedback(5, len(b), min(acc, len(b)))
        t = int(rng.randint(0, 6))
        r1.out_tokens.append(t)
        r2.out_tokens.append(t)
