"""Port parity: per-layer ``CachePolicy`` and the baseline codecs through
the port's engines, against the JAX package on shared weights (the fp32
tinyllama smoke config, params through ``params_from_jax``).

``CachePolicy`` itself (``tests/test_codecs.py:279-335``): segments,
lookup, average key bits, the paged group-size refusal, ``map``. Then
``EngineCore`` (``decode_backend = prefill_backend = "paged_fused"`` on
both sides) under uniform int8, ``first_k(1, int8, polar)`` — classic,
and chunked with the shared-prefix cache — and polar on the fixed angle
grid: identical greedy streams and events; ``ServeEngine`` under the
mixed policy: tokens and cache bytes per layer; speculative decode under
the ``int8`` and ``mixed`` policies of ``tests/test_spec_decode.py``, on
both of the port's verifiers, against the JAX engine's (span verifier)
streams, events and spec counts. Every arrival is at t = 0 or at one
late time (the engine clock is measured compute time)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the parity tests do not
# crowd the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.core import codecs as jcodecs  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402
from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.core import codecs as tcodecs  # noqa: E402
from repro_torch.core.quantizers import QuantConfig  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, Request, ServeEngine,
)
from repro_torch.serve.graphs import read_counters  # noqa: E402
from repro_torch.spec import SpecConfig  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

POLICIES = ("int8", "mixed", "fixed")


def _policy_cfg(cfg, policy: str, pkg):
    """``tests/test_spec_decode.py::_policy_cfg`` for either package
    (``pkg`` its codecs module), plus the fixed angle grid."""
    if policy == "fixed":
        return dataclasses.replace(cfg, quant=dataclasses.replace(
            cfg.quant, theta_stats="fixed"))
    int8 = dataclasses.replace(cfg.quant, method="int", key_bits=8)
    if policy == "int8":
        return dataclasses.replace(cfg, quant=int8)
    # mixed: the first layer token-wise int8, the rest grouped polar
    return dataclasses.replace(
        cfg, cache_policy=pkg.CachePolicy.first_k(1, int8, cfg.quant))


@pytest.fixture(scope="module")
def base():
    jcfg = dataclasses.replace(j_reduce(j_get_config("tinyllama-1.1b")),
                               decode_backend="paged_fused",
                               prefill_backend="paged_fused")
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return {"jcfg": jcfg, "jp": jp, "cfg": cfg, "tp": tp, "jax_runs": {}}


def _models(base, policy, **over):
    jcfg = dataclasses.replace(_policy_cfg(base["jcfg"], policy, jcodecs),
                               **over)
    cfg = dataclasses.replace(_policy_cfg(base["cfg"], policy, tcodecs),
                              **over)
    return j_get_model(jcfg), get_model(cfg)


def _events(out):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token, e.span, e.span_ix)
            for e in out["events"]]


def _streams(out):
    return {r.rid: list(r.out_tokens) for r in out["requests"]}


def _jax_run(base, key, jm, reqs, **kw):
    """The JAX engine's result for one workload, cached per key."""
    runs = base["jax_runs"]
    if key not in runs:
        runs[key] = JEngine(jm, base["jp"], **kw).run(reqs(JRequest), JGen())
    return runs[key]


# ---------------------------------------------------------------------------
# CachePolicy
# ---------------------------------------------------------------------------


def test_cache_policy_segments_and_lookup():
    int8 = QuantConfig(method="int", key_bits=8)
    polar = QuantConfig(method="polar")
    pol = tcodecs.CachePolicy.first_k(2, int8, polar)
    assert pol.layer_config(0) == pol.layer_config(1) == int8
    assert pol.layer_config(5) == polar
    assert pol.segments(6) == ((0, 2, int8), (2, 6, polar))
    assert not pol.is_uniform
    uni = tcodecs.CachePolicy.uniform(polar)
    assert uni.is_uniform and uni.segments(4) == ((0, 4, polar),)
    sparse = tcodecs.CachePolicy.per_layer({1: int8}, polar)
    assert sparse.segments(3) == ((0, 1, polar), (1, 2, int8), (2, 3, polar))


def test_cache_policy_avg_bits_and_group_size_match_jax():
    def pols(pkg, qc):
        int8 = qc(method="int", key_bits=8, group_size=128)
        polar = qc(method="polar", group_size=128)
        fixed = qc(method="polar", group_size=128, theta_stats="fixed")
        return (pkg.CachePolicy.first_k(2, int8, polar),
                pkg.CachePolicy.per_layer({3: fixed}, polar),
                pkg.CachePolicy.first_k(
                    1, dataclasses.replace(int8, group_size=64), polar))

    tpol, tsparse, tbad = pols(tcodecs, QuantConfig)
    jpol, jsparse, jbad = pols(jcodecs, jcodecs.QuantConfig)
    expect = (2 * (8 + 32 / 128) + 2 * 4.25) / 4
    assert abs(tpol.avg_key_bits(4, head_dim=128) - expect) < 1e-6
    for t, j in ((tpol, jpol), (tsparse, jsparse), (tbad, jbad)):
        for hd in (64, 128):
            assert t.avg_key_bits(5, hd) == j.avg_key_bits(5, hd)
        assert t.max_group_size() == j.max_group_size()
    assert tpol.page_group_size() == 128
    with pytest.raises(ValueError, match="one group size"):
        tbad.page_group_size()
    assert tbad.max_group_size() == 128   # dense buckets use the largest
    small = tpol.map(lambda q: dataclasses.replace(q, group_size=32))
    assert small.page_group_size() == 32
    assert small.layer_config(0).codec is tcodecs.get_codec("int")


def test_mixed_policy_caches_and_bytes(base):
    """Dense and paged per-layer state under the mixed policy: each layer
    holds its own codec's buffers, and the cache bytes per layer equal
    JAX's segment-averaged figure."""
    from repro.models import transformer as JTF
    jm, tm = _models(base, "mixed")
    tcaches = TF.init_decode_caches(tm.cfg, 2, 64, "cpu")
    jcaches = JTF.init_decode_caches(jm.cfg, batch=2, max_len=64)
    assert [c.cfg.codec.grouped for c in tcaches] == [False, True]
    assert tcaches[0].key_residual is None
    assert TF.per_layer_cache_bytes(tcaches) == \
        JTF.per_layer_cache_bytes(jm.cfg, jcaches)
    # a smoke reduction maps the policy
    red = reduce_for_smoke(dataclasses.replace(
        get_config("tinyllama-1.1b"), cache_policy=tm.cfg.cache_policy))
    assert red.policy.page_group_size() == 32
    # the draft config of speculative decode drops the policy
    from repro_torch.spec.draft import _derive_draft_cfg
    d = _derive_draft_cfg(tm.cfg, SpecConfig(mode="draft"))
    assert d.cache_policy is None and d.prefill_backend == "jnp"


# ---------------------------------------------------------------------------
# EngineCore and ServeEngine against the JAX engines
# ---------------------------------------------------------------------------


def _requests(vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, (int(rng.integers(8, 50)),)).astype(
        np.int32) for _ in range(n)]
    news = [int(rng.integers(3, 12)) for _ in range(n)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, news))]
    return reqs


def _shared_prefix(vocab, g):
    """A 3-page shared prefix, 4 requests, the last 3 arriving late (the
    first registers its pages before they are admitted)."""
    rng = np.random.default_rng(4)
    shared = rng.integers(0, vocab, (3 * g,)).astype(np.int32)
    tails = [rng.integers(0, vocab, (int(rng.integers(5, 20)),)).astype(
        np.int32) for _ in range(4)]

    def reqs(cls):
        return [cls(rid=i, prompt=np.concatenate([shared, t]),
                    max_new_tokens=6, arrival_time=0.0 if i == 0 else 1e4)
                for i, t in enumerate(tails)]
    return reqs


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_core_matches_jax(base, policy):
    jm, tm = _models(base, policy)
    reqs = _requests(tm.cfg.vocab_size)
    kw = dict(max_slots=3, max_len=128)
    jout = _jax_run(base, ("classic", policy), jm, reqs, **kw)
    before = read_counters()
    tout = ContinuousBatchingEngine(tm, base["tp"], device="cpu", **kw).run(
        reqs(Request), GenerationConfig())
    assert read_counters() == before        # CPU tensors launch nothing
    assert _streams(tout) == _streams(jout)
    assert _events(tout) == _events(jout)
    assert tout["decode_steps"] == jout["decode_steps"]
    assert tout["cache_bytes"] > 0


@pytest.mark.parametrize("policy", ["int8", "mixed"])
def test_chunked_prefix_engine_matches_jax(base, policy):
    """Chunked prefill with the shared-prefix cache: the port's streams,
    events and adoption counts equal JAX's, and equal the unshared run's."""
    jm, tm = _models(base, policy)
    g = tm.cfg.policy.page_group_size()
    reqs = _shared_prefix(tm.cfg.vocab_size, g)
    kw = dict(max_slots=3, max_len=192, prefill_chunk=g, prefix_cache=True)
    jout = _jax_run(base, ("prefix", policy), jm, reqs, **kw)
    tout = ContinuousBatchingEngine(tm, base["tp"], device="cpu", **kw).run(
        reqs(Request), GenerationConfig())
    assert _streams(tout) == _streams(jout)
    assert _events(tout) == _events(jout)
    for key in ("adopted_pages", "prefill_tokens_skipped", "cow_splits",
                "decode_steps", "prefill_backend"):
        assert tout[key] == jout[key], key
    assert tout["adopted_pages"] > 0
    unshared = ContinuousBatchingEngine(
        tm, base["tp"], device="cpu", **{**kw, "prefix_cache": False}).run(
        reqs(Request), GenerationConfig())
    assert _streams(unshared) == _streams(tout)


def test_chunked_jnp_prefill_backend_matches_jax(base):
    """``prefill_backend="jnp"`` (full-row gather, no width slicing) under
    the mixed policy: the port equals JAX's ``"jnp"`` engine."""
    jm, tm = _models(base, "mixed", prefill_backend="jnp")
    reqs = _requests(tm.cfg.vocab_size, n=3, seed=2)
    kw = dict(max_slots=2, max_len=128, prefill_chunk=32)
    jout = _jax_run(base, ("chunk-jnp", "mixed"), jm, reqs, **kw)
    tout = ContinuousBatchingEngine(tm, base["tp"], device="cpu", **kw).run(
        reqs(Request), GenerationConfig())
    assert tout["prefill_backend"] == "jnp"
    assert _streams(tout) == _streams(jout)
    assert _events(tout) == _events(jout)


@pytest.mark.parametrize("backend", ["jnp", "paged_fused"])
def test_serve_engine_mixed_matches_jax(base, backend):
    jm, tm = _models(base, "mixed", decode_backend=backend)
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 50)).astype(np.int32)
    jout = JServe(jm, base["jp"], max_len=128).generate(
        {"tokens": jnp.asarray(toks)}, JGen(max_new_tokens=17))
    tout = ServeEngine(tm, base["tp"], max_len=128, device="cpu").generate(
        {"tokens": toks}, GenerationConfig(max_new_tokens=17))
    np.testing.assert_array_equal(tout["tokens"], np.asarray(jout["tokens"]))
    assert tout["cache_bytes_per_layer"] == jout["cache_bytes_per_layer"]
    assert tout["cache_bytes"] == jout["cache_bytes"]


# ---------------------------------------------------------------------------
# speculative decode under the int8 and mixed policies
# ---------------------------------------------------------------------------


def _repetitive(vocab, n=3, seed=3, new=16):
    """Single-token prompts (``tests/test_spec_decode.py``): greedy
    continuations fall into short cycles, giving ngram real acceptance."""
    rng = np.random.RandomState(seed)
    prompts = [np.full((36,), rng.randint(0, vocab), np.int32)
               for _ in range(n)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
    return reqs


@pytest.mark.parametrize("verifier", ["span", "scan"])
@pytest.mark.parametrize("policy", ["int8", "mixed"])
def test_spec_decode_matches_jax(base, policy, verifier):
    """ngram k 4 on the span verifier (``"jnp"``) and the scan verifier
    (``"paged_fused"``): the port's streams equal its plain run's, and
    streams, events and spec counts equal the JAX engine's (span
    verifier, ``"jnp"``)."""
    jm, _ = _models(base, policy, decode_backend="jnp")
    _, tm = _models(base, policy, decode_backend="jnp" if verifier == "span"
                    else "paged_fused")
    reqs = _repetitive(tm.cfg.vocab_size)
    kw = dict(max_slots=2, max_len=128)
    runs = base["jax_runs"]
    key = ("spec", policy)
    if key not in runs:
        runs[key] = JEngine(jm, base["jp"], spec=jspec.SpecConfig(
            mode="ngram", k=4), **kw).run(reqs(JRequest), JGen())
    jout = runs[key]
    plain = ContinuousBatchingEngine(tm, base["tp"], device="cpu", **kw).run(
        reqs(Request), GenerationConfig())
    tout = ContinuousBatchingEngine(
        tm, base["tp"], device="cpu", spec=SpecConfig(mode="ngram", k=4),
        **kw).run(reqs(Request), GenerationConfig())
    assert _streams(tout) == _streams(plain) == _streams(jout)
    assert _events(tout) == _events(jout)
    sp, jsp = tout["spec"], jout["spec"]
    assert (sp["steps"], sp["drafted_tokens"], sp["accepted_tokens"]) == \
        (jsp["steps"], jsp["drafted_tokens"], jsp["accepted_tokens"])
    assert sp["accepted_tokens"] > 0 and tout["proposer_faults"] == 0
