"""The MoE family in the port (``repro_torch/models/moe.py``), on the CPU
at smoke width, held to the JAX package.

``moe_ffn`` against ``repro.models.moe.moe_ffn`` on the smoke reductions
of qwen2-moe-a2.7b (shared expert, gates not renormalised) and dbrx-132b
(``norm_topk``, no shared expert), float32, with and without drops: the
expert indices (JAX's, recorded from its ``jax.lax.top_k``) and the keep
masks (a per-assignment loop over JAX's indices) exactly equal, outputs
within 1e-4; a padded prefill row whose padding moves the real tokens'
drops; the Switch load-balance loss against JAX's ``aux``; ties between
router logits going to the lower expert index; the weights carried
across with the router in fp32, and drawn natively at JAX's shapes; the
derived draft of an MoE target. Then the engines on qwen2-moe smoke with
``decode_backend = prefill_backend = "paged_fused"`` against the JAX
engines: paged classic (dbrx smoke too), chunked prefill with the prefix
cache, ``runahead=4``, ngram speculation (k 4) on both verifiers and the
static ``ServeEngine`` — greedy streams and per-request events
identical. Every arrival is at t = 0: the engine clock counts measured
compute time."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU tensors: one intra-op thread each, so the tests do not crowd
# the cores of the other test workers
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.spec.draft import _derive_draft_cfg as j_derive  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingEngine, GenerationConfig, Request, ServeEngine,
)
from repro_torch.spec import SpecConfig  # noqa: E402
from repro_torch.spec.draft import _derive_draft_cfg  # noqa: E402
from repro_torch.weights import init_params, params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
MOE = ("qwen2-moe-a2.7b", "dbrx-132b")


def _pair(name, **over):
    """(JAX smoke cfg, port smoke cfg) of one MoE config."""
    return (jconfigs.reduce_for_smoke(jconfigs.get_config(name), **over),
            configs.reduce_for_smoke(configs.get_config(name), **over))


@pytest.fixture(scope="module", params=MOE)
def weights(request):
    """(JAX cfg, JAX params, port cfg, port params) of one config's smoke
    reduction on the page-native backends."""
    jcfg, cfg = _pair(request.param, decode_backend="paged_fused",
                      prefill_backend="paged_fused")
    jp = jax.tree.map(np.asarray, j_get_model(jcfg).init(
        jax.random.PRNGKey(0)))
    return jcfg, jp, cfg, params_from_jax(jp, cfg, device="cpu")


def _layer_ffn(jp, i=0):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), jp["layers"]["ffn"])


def _jax_moe(jffn, x, jcfg):
    """JAX's ``moe_ffn`` with the (gates, indices) of its ``top_k``
    recorded: (y, aux, eidx)."""
    seen = []
    top_k = jax.lax.top_k

    def record(x, k):
        out = top_k(x, k)
        seen.append(np.asarray(out[1]))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", record)
        y, aux = JM.moe_ffn(jffn, jnp.asarray(x), jcfg)
    (eidx,) = seen
    return np.asarray(y), float(aux), eidx


def _keep_loop(eidx, cap, e):
    """Keep mask (B, k, T) of the assignments ``eidx`` (B, T, k): slot 0
    of every token first, each taking the next position in its expert
    while the expert has room."""
    b, t, k = eidx.shape
    keep = np.zeros((b, k, t), bool)
    for bi in range(b):
        used = np.zeros(e, int)
        for s in range(k):
            for ti in range(t):
                ex = eidx[bi, ti, s]
                keep[bi, s, ti] = used[ex] < cap
                used[ex] += 1
    return keep


def _port_moe(ffn, x, cfg):
    """The port's ``moe_ffn`` and its routing: (y, eidx, keep)."""
    xt = torch.from_numpy(x)
    _, _, eidx = TM.route(ffn, xt, cfg)
    keep, _ = TM.dispatch(eidx, TM.capacity(x.shape[1], cfg),
                          cfg.num_experts)
    return TM.moe_ffn(ffn, xt, cfg).numpy(), eidx.numpy(), keep.numpy()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_ffn_matches_jax(weights, cf, seed):
    """Two batch rows of 24 tokens: at capacity factor 8 nothing drops, at
    0.25 (capacity 8 of 12 assignments an expert on average) some
    assignments drop. Indices and keep masks equal JAX's exactly, the
    outputs within 1e-4."""
    jcfg, jp, cfg, tp = weights
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=cf)
                 for c in (jcfg, cfg))
    x = np.random.default_rng(seed).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    jy, _, jidx = _jax_moe(_layer_ffn(jp), x, jcfg)
    y, eidx, keep = _port_moe(tp["layers"][0]["ffn"], x, cfg)
    np.testing.assert_array_equal(eidx, jidx)
    np.testing.assert_array_equal(
        keep, _keep_loop(jidx, TM.capacity(24, cfg), cfg.num_experts))
    assert keep.all() == (cf == 8.0)
    np.testing.assert_allclose(y, jy, **TOL)


def test_padding_moves_drops_as_in_jax(weights):
    """A 20-token prompt in a 32-token bucket (capacity 8 either way at
    factor 0.25): the 12 padding rows, all one vector, take their experts'
    room before the real tokens' second slot, so real assignments kept in
    the unpadded row drop in the padded one — in both packages alike."""
    jcfg, jp, cfg, tp = weights
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=0.25)
                 for c in (jcfg, cfg))
    rng = np.random.default_rng(7)
    real = rng.standard_normal((1, 20, cfg.d_model)).astype(np.float32)
    pad = np.broadcast_to(rng.standard_normal(cfg.d_model).astype(
        np.float32), (1, 12, cfg.d_model))
    padded = np.concatenate([real, pad], axis=1)
    assert TM.capacity(20, cfg) == TM.capacity(32, cfg) == 8
    ffn = tp["layers"][0]["ffn"]
    keeps = []
    for x in (real, padded):
        jy, _, jidx = _jax_moe(_layer_ffn(jp), x, jcfg)
        y, eidx, keep = _port_moe(ffn, x, cfg)
        np.testing.assert_array_equal(eidx, jidx)
        np.testing.assert_array_equal(keep, _keep_loop(jidx, 8,
                                                       cfg.num_experts))
        np.testing.assert_allclose(y, jy, **TOL)
        keeps.append(keep[..., :20])
    assert (keeps[0] & ~keeps[1]).any(), "padding moved no drop"


@pytest.mark.parametrize("seed", range(2))
def test_load_balance_loss_matches_jax(weights, seed):
    jcfg, jp, cfg, tp = weights
    x = np.random.default_rng(seed).standard_normal(
        (3, 16, cfg.d_model)).astype(np.float32)
    _, aux, _ = _jax_moe(_layer_ffn(jp, 1), x, jcfg)
    got = TM.load_balance_loss(tp["layers"][1]["ffn"], torch.from_numpy(x),
                               cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), aux, rtol=1e-6, atol=1e-6)


def test_router_ties_go_to_the_lower_index():
    """Equal router logits: a zero router ties all four experts (top 2 =
    experts 0, 1), and logits (0, 2, 1, 2) tie experts 1 and 3 at the top
    (top 2 = 1, 3). The port picks what ``jax.lax.top_k`` picks, and
    ``moe_ffn`` with the tied router equals JAX's."""
    jcfg, cfg = _pair("dbrx-132b")
    d, e = cfg.d_model, cfg.num_experts
    x = np.ones((1, 3, d), np.float32)
    for col, want in ((np.zeros(e), [0, 1]),
                      (np.array([0.0, 2.0, 1.0, 2.0]), [1, 3])):
        router = np.tile(col / d, (d, 1)).astype(np.float32)
        _, _, eidx = TM.route({"router": torch.from_numpy(router)},
                              torch.from_numpy(x), cfg)
        jprobs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router))
        assert eidx.tolist() == [[want] * 3]
        np.testing.assert_array_equal(eidx.numpy(),
                                      np.asarray(jax.lax.top_k(jprobs, 2)[1]))
    jffn = JM.init_moe(jax.random.PRNGKey(1), jcfg)
    jffn["router"] = jnp.asarray(router)
    ffn = {k: torch.from_numpy(np.array(v)) for k, v in jffn.items()}
    xs = np.random.default_rng(2).standard_normal((1, 8, d)).astype(
        np.float32)
    jy, _, jidx = _jax_moe(jffn, np.ones_like(xs), jcfg)
    y, eidx, _ = _port_moe(ffn, np.ones_like(xs), cfg)
    np.testing.assert_array_equal(eidx, jidx)
    np.testing.assert_allclose(y, jy, **TOL)


@pytest.mark.parametrize("name", MOE)
def test_weights_carry_router_in_fp32(name):
    """``params_from_jax`` at bf16: expert and shared-expert matrices in
    bf16 (expert-stacked), the router in fp32 and exactly JAX's; the
    port's own draw has the same tree, shapes and dtypes, and its size is
    ``param_count``."""
    jcfg, cfg = _pair(name, dtype="bfloat16")
    jp = jax.tree.map(np.asarray, j_get_model(jcfg).init(
        jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, cfg, device="cpu")
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    for i, layer in enumerate(tp["layers"]):
        ffn = layer["ffn"]
        assert ffn["router"].dtype == torch.float32
        np.testing.assert_array_equal(ffn["router"].numpy(),
                                      jp["layers"]["ffn"]["router"][i])
        assert [tuple(ffn[n].shape) for n in ("wg", "wu", "wd")] == \
            [(e, d, f), (e, d, f), (e, f, d)]
        assert all(ffn[n].dtype == torch.bfloat16 for n in ("wg", "wu", "wd"))
        assert ("shared" in ffn) == (cfg.num_shared_experts > 0)
        if "shared" in ffn:
            assert ffn["shared"]["wg"].shape == (d, f * cfg.num_shared_experts)
            assert ffn["shared"]["wd"].dtype == torch.bfloat16
    gen = torch.Generator()
    gen.manual_seed(0)
    own = init_params(cfg, generator=gen, device="cpu")

    def leaves(p, pre=""):
        if isinstance(p, dict):
            return {k: v for n, x in p.items()
                    for k, v in leaves(x, f"{pre}/{n}").items()}
        if isinstance(p, list):
            return {k: v for i, x in enumerate(p)
                    for k, v in leaves(x, f"{pre}/{i}").items()}
        return {pre: (tuple(p.shape), p.dtype)}
    assert leaves(own) == leaves(tp)
    assert sum(t.numel() for t in jax.tree.leaves(own)) == \
        cfg.param_count() == jcfg.param_count()
    router = own["layers"][0]["ffn"]["router"]
    assert 0.015 < float(router.std()) < 0.025      # normal * 0.02


@pytest.mark.parametrize("name", MOE)
def test_draft_of_moe_target_is_moe(name):
    """The derived draft of an MoE target keeps the family and its MoE
    fields, as JAX's does, and builds a model."""
    jcfg, cfg = _pair(name)
    spec = SpecConfig(mode="draft", k=2)
    dcfg = _derive_draft_cfg(cfg, spec)
    jd = j_derive(jcfg, jspec.SpecConfig(mode="draft", k=2))
    assert dcfg.family == jd.family == "moe"
    for f in ("num_layers", "num_experts", "top_k", "num_shared_experts",
              "moe_d_ff", "capacity_factor", "norm_topk"):
        assert getattr(dcfg, f) == getattr(jd, f), f
    gen = torch.Generator()
    gen.manual_seed(spec.draft_seed)
    p = get_model(dcfg).init(generator=gen, device="cpu")
    assert "router" in p["layers"][0]["ffn"]


# ---------------------------------------------------------------------------
# the engines against JAX's on the smoke reductions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(weights):
    jcfg, jp, cfg, tp = weights
    return (j_get_model(jcfg), jax.tree.map(jnp.asarray, jp), get_model(cfg),
            tp)


def _requests(cls, vocab, n=4, seed=0, lo=8, hi=40, new=(3, 10)):
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(0, vocab, (int(rng.integers(lo, hi)),))
                .astype(np.int32),
                max_new_tokens=int(rng.integers(*new))) for i in range(n)]


def _events(out):
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token, e.span, e.span_ix)
            for e in out["events"]]


def _match(engines, reqs, spec=None, verifier_backend=None, **kw):
    jm, jp, tm, tp = engines
    jspec_cfg = None if spec is None else jspec.SpecConfig(
        **dataclasses.asdict(spec))
    jout = jserve.ContinuousBatchingEngine(jm, jp, spec=jspec_cfg, **kw).run(
        reqs(jserve.Request), jserve.GenerationConfig())
    tms = [tm] if verifier_backend is None else [
        get_model(dataclasses.replace(tm.cfg, decode_backend=b))
        for b in verifier_backend]
    for m in tms:
        tout = ContinuousBatchingEngine(m, tp, spec=spec, device="cpu",
                                        **kw).run(reqs(Request),
                                                  GenerationConfig())
        assert {r.rid: r.out_tokens for r in tout["requests"]} == \
            {r.rid: r.out_tokens for r in jout["requests"]}
        assert _events(tout) == _events(jout)
        assert tout["decode_steps"] == jout["decode_steps"]
    return jout, tout


def test_paged_engine_matches_jax(engines):
    """The classic engine (whole-prompt prefill in pow2 buckets, padding
    routed): identical greedy streams and events, on both configs."""
    vocab = engines[2].cfg.vocab_size
    _match(engines, lambda cls: _requests(cls, vocab), max_slots=3,
           max_len=64)


@pytest.mark.parametrize("weights", [MOE[0]], indirect=True)
def test_prefix_engine_matches_jax(engines):
    """Chunked prefill (32-token chunks, padding routed) over the prefix
    cache, a shared 32-token head so later admissions adopt pages."""
    vocab = engines[2].cfg.vocab_size
    head = np.random.default_rng(5).integers(0, vocab, (32,)).astype(
        np.int32)

    def reqs(cls):
        out = _requests(cls, vocab, n=3, seed=6)
        for r in out:
            r.prompt = np.concatenate([head, r.prompt])
        return out
    jout, tout = _match(engines, reqs, max_slots=2, max_len=96,
                        prefix_cache=True, prefill_chunk=32)
    assert tout["adopted_pages"] == jout["adopted_pages"] > 0


@pytest.mark.parametrize("weights", [MOE[0]], indirect=True)
def test_runahead_engine_matches_jax(engines):
    """``runahead=4`` on a burst of five requests over three slots (one
    table width, one prefill bucket): streams, events and horizons."""
    vocab = engines[2].cfg.vocab_size
    jout, tout = _match(
        engines, lambda cls: _requests(cls, vocab, n=5, seed=9, lo=4, hi=12,
                                       new=(6, 19)),
        max_slots=3, max_len=32, runahead=4)
    assert tout["runahead"]["horizons"] == jout["runahead"]["horizons"] > 0
    assert tout["runahead"]["tokens"] == jout["runahead"]["tokens"]


@pytest.mark.parametrize("weights", [MOE[0]], indirect=True)
def test_spec_engine_matches_jax(engines):
    """ngram speculation at k = 4 on the span verifier (``"jnp"``) and
    the scan verifier (``"paged_fused"``): streams, events and spec counts
    those of the JAX engine. The span verifier runs the MoE FFN per
    column at t = 1 where JAX runs it over the span: the two route alike
    because a span of k + 1 <= 8 tokens cannot overflow an expert (the
    capacity is at least 8, an expert takes one assignment a token)."""
    tm = engines[2]
    spec = SpecConfig(mode="ngram", k=4)
    assert spec.k + 1 <= TM.capacity(spec.k + 1, tm.cfg)
    assert TM.capacity(1, tm.cfg) == 8
    rng = np.random.RandomState(3)
    prompts = [np.full((36,), rng.randint(0, tm.cfg.vocab_size), np.int32)
               for _ in range(3)]

    def reqs(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=24)
                for i, p in enumerate(prompts)]
    jout, tout = _match(engines, reqs, spec=spec,
                        verifier_backend=("jnp", "paged_fused"),
                        max_slots=2, max_len=64)
    sp, jsp = tout["spec"], jout["spec"]
    assert (sp["steps"], sp["drafted_tokens"], sp["accepted_tokens"]) == \
        (jsp["steps"], jsp["drafted_tokens"], jsp["accepted_tokens"])
    assert sp["steps"] > 0
    assert tout["proposer_faults"] == jout["proposer_faults"] == 0


@pytest.mark.parametrize("weights", [MOE[0]], indirect=True)
def test_static_engine_matches_jax(engines):
    """``ServeEngine`` (dense caches; capacity over each batch row's 40
    prompt tokens at prefill, one token at decode): the greedy tokens and
    the cache bytes equal JAX's."""
    jm, jp, tm, tp = engines
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    jout = jserve.ServeEngine(jm, jp, max_len=64).generate(
        {"tokens": jnp.asarray(toks)}, jserve.GenerationConfig(
            max_new_tokens=17))
    tout = ServeEngine(tm, tp, max_len=64, device="cpu").generate(
        {"tokens": toks}, GenerationConfig(max_new_tokens=17))
    np.testing.assert_array_equal(tout["tokens"], jout["tokens"])
    assert tout["cache_bytes_per_layer"] == jout["cache_bytes_per_layer"]


@pytest.mark.parametrize("weights", [MOE[0]], indirect=True)
@pytest.mark.parametrize("backend, cf, refused", [
    ("jnp", 1.25, True), ("paged_fused", 1.25, False), ("jnp", 2.0, False)])
def test_span_verifier_refuses_spans_past_capacity(engines, backend, cf,
                                                   refused):
    """k = 8 gives span widths up to 9, past the capacity (8) of a 9-token
    span at capacity factor 1.25: JAX's span verifier could drop there
    what the port's per-column routing keeps, so the engine refuses it.
    The scan verifier (one token a step, as JAX's) and a capacity factor
    whose span capacity covers the span build."""
    tm, tp = engines[2], engines[3]
    m = get_model(dataclasses.replace(tm.cfg, decode_backend=backend,
                                      capacity_factor=cf))
    spec = SpecConfig(mode="ngram", k=8)
    assert (9 > TM.capacity(9, m.cfg)) == (cf == 1.25)

    def build():
        return ContinuousBatchingEngine(m, tp, spec=spec, device="cpu",
                                        max_slots=2, max_len=64)
    if refused:
        with pytest.raises(ValueError, match="MoE capacity"):
            build()
    else:
        build()
