"""The port's ``launch/mesh.py`` and ``distributed/`` against the JAX
package, in one process (no world; the cross-process checks are in
``tests/test_torch_mesh_serve.py``).

* ``param_pspec`` / ``logical_rules`` / ``serving_rules`` /
  ``decode_state_pspec`` equal JAX's on ``FakeMesh`` shapes {model: 2},
  {data: 2, model: 2}, {model: 4} and {pod: 2, data: 16, model: 16}, for
  every param and decode-state leaf of every config (both sides fed the
  same (path, shape) pairs from ``jax.eval_shape``: no weights drawn);
* ``softmax_stats`` / ``combine_softmax_stats`` / ``finalize_softmax``
  equal JAX's (1e-6; masked and all-masked rows exact);
* a head shard's paged decode plans its kernel splits from the model's
  KV-head count (the unsharded call's plan);
* ``leaf_pspec`` / ``cache_pspecs`` equal JAX's and ``shard_paged_state``
  keeps head block r of a fragmented cache, every codec;
* the mesh, the context and the engines' refusals (a data axis > 1;
  the hybrid, encoder-decoder and SSM families on
  ``ServeEngine(mesh=)``);
* on a (1, 1) mesh: ``runahead=4`` taken and left unused, spec on both
  verifiers with the meshless streams, ``ServeEngine(mesh=)`` with the
  meshless tokens; shadow and gathered views keep the head
  block, and the dense fused route plans #5's splits for the model's
  KV heads.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import list_configs as j_list_configs  # noqa: E402
from repro.distributed import collectives as jcol  # noqa: E402
from repro.distributed import serving as jsrv  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs import reduce_for_smoke  # noqa: E402
from repro_torch.core import paged_cache as pgc  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed import serving as dsrv  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels import paged_decode as pdk  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    EngineCore, GenerationConfig, Request, ServeEngine,
)
from repro_torch.spec import SpecConfig  # noqa: E402
from test_sharding import FakeMesh  # noqa: E402
from test_torch_mesh_serve import _to_jax  # noqa: E402
from test_distributed_serving import CODEC_CONFIGS as J_CODECS  # noqa: E402
from torch_mesh_worker import (  # noqa: E402
    CODEC_CONFIGS, build_fragmented_cache, decode_q,
)

MESHES = ({"model": 2}, {"data": 2, "model": 2}, {"model": 4},
          {"pod": 2, "data": 16, "model": 16})
BATCHES = (1, 8, 256)


def _leaves(tree):
    """(JAX path string, shape) of every leaf of a ``jax.eval_shape`` tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jsh._path_str(p), tuple(x.shape)) for p, x in flat]


@pytest.fixture(scope="module")
def shapes():
    """Per config: its params' and its decode state's (path, shape) pairs
    at full size (abstract: ``jax.eval_shape``)."""
    out = {}
    for name in j_list_configs():
        m = j_get_model(j_get_config(name))
        out[name] = (_leaves(jax.eval_shape(m.init, jax.random.PRNGKey(0))),
                     _leaves(jax.eval_shape(
                         lambda m=m: m.init_decode_state(8, 1024))))
    return out


def test_config_tables_agree():
    assert list_configs() == j_list_configs()
    assert sh._TP_RULES == jsh._TP_RULES
    assert sh._NO_FSDP.pattern == jsh._NO_FSDP.pattern


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_param_pspecs_match_jax(shapes, mesh_shape):
    mesh = FakeMesh(mesh_shape)
    for name, (params, _) in shapes.items():
        jcfg, cfg = j_get_config(name), get_config(name)
        for path, shape in params:
            want = jsh.param_pspec(path, shape, mesh, jcfg)
            got = sh.param_pspec(path, shape, mesh, cfg)
            assert got == want and tuple(got) == tuple(want), \
                (name, path, shape, got, want)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_logical_and_serving_rules_match_jax(mesh_shape):
    mesh = FakeMesh(mesh_shape)
    for name in list_configs():
        jcfg, cfg = j_get_config(name), get_config(name)
        for b in BATCHES:
            assert sh.logical_rules(cfg, mesh, b) == \
                jsh.logical_rules(jcfg, mesh, b), (name, b)
            got = sh.serving_rules(cfg, mesh, b)
            assert got == jsh.serving_rules(jcfg, mesh, b), (name, b)
            assert got["seq"] is None


@pytest.mark.parametrize("mesh_shape", MESHES, ids=str)
def test_decode_state_and_batch_pspecs_match_jax(shapes, mesh_shape):
    mesh = FakeMesh(mesh_shape)
    for name, (_, state) in shapes.items():
        for path, shape in state:
            for b in BATCHES:
                assert sh.decode_state_pspec(path, shape, mesh, b) == \
                    jsh.decode_state_pspec(path, shape, mesh, b), \
                    (name, path, shape, b)
    specs = {"tokens": jax.ShapeDtypeStruct((8, 128), jnp.int32),
             "mask": jax.ShapeDtypeStruct((8,), jnp.bool_)}
    for b in BATCHES:
        assert sh.batch_pspecs(specs, mesh, b) == \
            jsh.batch_pspecs(specs, mesh, b)


def test_pspec_trees_walk_port_params_and_state():
    """The tree forms over the port's own params (per-layer lists: the
    negative axes give the stacked leaves' specs) and paged state."""
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    model = get_model(cfg)
    params = model.init(device="cpu")
    mesh = FakeMesh({"data": 2, "model": 2})
    specs = sh.param_pspecs(params, mesh, cfg)
    assert specs["layers"][1]["attn"]["wq"] == \
        sh.param_pspec("layers/1/attn/wq", params["layers"][1]["attn"][
            "wq"].shape, mesh, cfg)
    assert specs["layers"][0]["attn"]["wo"][-2] == "model"
    state = sh.decode_state_pspecs(
        model.init_paged_state(pgc.PagedLayout(
            page_size=32, num_pages=8, slots=2, pages_per_slot=4), "cpu"),
        mesh, 2)
    assert state[0]["lengths"] == sh.decode_state_pspec(
        "0/lengths", (2,), mesh, 2)


def _stats_inputs():
    rng = np.random.default_rng(3)
    s = rng.standard_normal((3, 2, 5)).astype(np.float32)
    s[1, 0, :] = -1e30             # all masked (the finite sentinel)
    s[2, 1, :2] = -np.inf          # partly masked
    v = rng.standard_normal((3, 2, 5, 4)).astype(np.float32)
    return s, v


def test_softmax_stats_and_merges_match_jax():
    s, v = _stats_inputs()
    jt = jcol.softmax_stats(jnp.asarray(s), jnp.asarray(v))
    tt = col.softmax_stats(torch.from_numpy(s), torch.from_numpy(v))
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert float(tt[1][1, 0]) == 0.0 and not tt[2][1, 0].any()
    s2 = np.concatenate([s[1:], s[:1]])
    v2 = np.concatenate([v[1:], v[:1]])
    jt2 = jcol.softmax_stats(jnp.asarray(s2), jnp.asarray(v2))
    tt2 = col.softmax_stats(torch.from_numpy(s2), torch.from_numpy(v2))
    jc = jcol.combine_softmax_stats(jt, jt2)
    tc = col.combine_softmax_stats(tt, tt2)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        col.finalize_softmax(tc[1], tc[2]).numpy(),
        np.asarray(jcol.finalize_softmax(jc[1], jc[2])), rtol=1e-6,
        atol=1e-6)
    # a dead block against a dead block: zero mass, zero output, no NaN
    dead = col.softmax_stats(torch.full((1, 3), -1e30), torch.ones((1, 3, 2)))
    out = col.finalize_softmax(*col.combine_softmax_stats(dead, dead)[1:])
    assert torch.equal(out, torch.zeros((1, 2)))


def _model_mesh(n: int, r: int) -> tmesh.Mesh:
    """Rank r's view of a (1, n) mesh, without a world (no collective)."""
    return tmesh.Mesh({"data": 1, "model": n}, {"data": 0, "model": r},
                      {"data": [r], "model": list(range(n))})


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_keeps_head_block_and_specs_match_jax(n):
    """Every codec: the specs JAX gives each pool leaf, and rank r's shard
    holds block r of every head-axis leaf and the other leaves whole."""
    for tcfg, jcfg in zip(CODEC_CONFIGS, J_CODECS, strict=True):
        cache, _ = build_fragmented_cache(tcfg)
        jspecs = jsrv.cache_pspecs(_to_jax(cache, jcfg))
        tspecs = dsrv.cache_pspecs(cache)
        for f in dsrv._FIELDS:
            assert tspecs[f] == getattr(jspecs, f), (tcfg, f)
        for r in range(n):
            shard = dsrv.shard_paged_state(cache, _model_mesh(n, r))
            assert shard.head_shard == (r, n)
            assert shard.kv_heads == cache.kv_heads == 4
            for f in dsrv._FIELDS:
                whole, part = getattr(cache, f), getattr(shard, f)
                pairs = (whole.items() if isinstance(whole, dict)
                         else [(None, whole)])
                for k, x in pairs:
                    y = part[k] if k is not None else part
                    if x is None:
                        assert y is None
                        continue
                    spec = dsrv.leaf_pspec(x, 4)
                    assert spec == jsrv.leaf_pspec(
                        jnp.zeros(x.shape), 4), (f, k)
                    if spec == ():
                        assert torch.equal(x, y)
                    else:
                        b = 4 // n
                        assert torch.equal(x[:, r * b:(r + 1) * b], y)
                        assert y.is_contiguous()
                    assert y.data_ptr() != x.data_ptr()


def test_paged_state_shardings_replicate_indivisible_heads():
    cache, _ = build_fragmented_cache(CODEC_CONFIGS[4], hkv=2)
    specs = dsrv.paged_state_shardings([cache], FakeMesh({"model": 4}))[0]
    assert all(v == () for k, v in specs.items() if not isinstance(v, dict)
               and v is not None)
    assert dsrv.shard_paged_state(cache, _model_mesh(4, 1)) is cache
    specs = dsrv.paged_state_shardings(cache, FakeMesh({"model": 2}))
    assert specs["key_codes"] == (None, "model", None, None)


def test_head_shard_plans_splits_from_the_model_kv_heads(monkeypatch):
    """A head shard's paged decode passes the model's KV heads to the
    split planner: at 8 slots x 8 pages the shard's own 4 heads would
    plan 8 splits, the model's 8 plan 4 — the unsharded call's, whose
    partials then merge in the same order."""
    assert pdk.plan_splits(8, 8, 8) == 4 and pdk.plan_splits(8, 4, 8) == 8
    assert pdk.split_ranges(8, pdk.plan_splits(8, 8, 8)) == \
        [(0, 2), (2, 4), (4, 6), (6, 8)]
    from repro_torch.kernels import ops
    seen = []
    real = ops.polar_paged_decode_attention_grouped

    def spy(*a, **kw):
        seen.append(kw["plan_heads"])
        return real(*a, **kw)
    monkeypatch.setattr(ops, "polar_paged_decode_attention_grouped", spy)
    cache, table = build_fragmented_cache(CODEC_CONFIGS[4], hkv=8)
    q = decode_q(hq=16)
    whole = pgc.paged_decode_attention(cache, q, table)
    for r in range(2):
        shard = dsrv.shard_paged_state(cache, _model_mesh(2, r))
        out = pgc.paged_decode_attention(shard, q[:, 8 * r:8 * (r + 1)],
                                         table)
        assert torch.equal(out, whole[:, 8 * r:8 * (r + 1)])
    assert seen == [8, 8, 8]


def test_mesh_outside_a_world():
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model")
    assert mesh.group("model") is None and mesh.capturable("model")
    assert tmesh.make_host_mesh(4).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="world has 1"):
        tmesh.make_mesh((1, 2), ("data", "model"))
    with pytest.raises(ValueError, match="timeout_s"):
        tmesh.init_world(0, 1, "file:///nonexistent", "gloo", timeout_s=600)
    for shape in MESHES:
        fake = FakeMesh(shape)
        assert tmesh.data_axes(fake) == jmesh.data_axes(fake)
        assert tmesh.model_axis_size(fake) == jmesh.model_axis_size(fake)
    x = torch.arange(6.0).reshape(2, 3)
    assert col.allgather_concat(x, mesh, "model", axis=1) is x


def test_sharding_context_and_dispatch():
    """No context: the plain path. A (1, 1) mesh with ``kv_heads`` mapped:
    a head shard takes the sharded path (identity gather here), bitwise
    equal. A head shard outside its context raises rather than attending
    over some of the heads."""
    assert ctx.current_mesh() is None and ctx.resolve(["heads"]) is None
    cache, table = build_fragmented_cache(CODEC_CONFIGS[4])
    q = decode_q()
    ref = pgc.paged_decode_attention(cache, q, table, backend="jnp")
    assert torch.equal(dsrv.dispatch_paged_decode_attention(
        cache, q, table, backend="jnp"), ref)
    mesh = _model_mesh(1, 0)
    shard = dsrv.shard_paged_state(cache, mesh)
    with ctx.use_sharding(mesh, {"kv_heads": "model", "heads": "model"}):
        assert ctx.current_mesh() is mesh
        assert ctx.resolve(["batch", "heads", None]) == (None, "model", None)
        assert dsrv._active_head_axis(shard, 8) == (mesh, "model")
        assert dsrv._active_head_axis(cache, 8) == (None, None)
        assert torch.equal(dsrv.dispatch_paged_decode_attention(
            shard, q, table, backend="jnp"), ref)
    assert ctx.current_mesh() is None
    with pytest.raises(ValueError, match="mesh context"):
        dsrv.dispatch_paged_decode_attention(shard, q, table)
    with ctx.use_sharding(mesh, {"kv_heads": None}):
        with pytest.raises(ValueError, match="mesh context"):
            dsrv._active_head_axis(shard, 8)
    x = torch.ones(2)
    assert ctx.shard(x, ["batch"]) is x


@pytest.fixture(scope="module")
def smoke():
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    model = get_model(cfg)
    return cfg, model, model.init(device="cpu")


def _streams(core, reqs):
    core.reset()
    for r in reqs:
        core.add_request(r)
    list(core.events())
    return {r.rid: list(r.out_tokens) for r in core.completed}


def test_engine_one_position_mesh_replays_meshless(smoke):
    """``EngineCore(mesh=make_mesh((1, 1)))`` takes the head-sharded
    dispatch (one block, identity collectives) and gives the meshless
    streams, one-shot and chunked + prefix cache."""
    cfg, model, params = smoke

    def reqs():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (int(
            rng.integers(8, 60)),)).astype(np.int32), max_new_tokens=6)
            for i in range(4)]
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    for kw in ({}, {"prefill_chunk": 64, "prefix_cache": True}):
        base = EngineCore(model, params, max_slots=3, max_len=128,
                          device="cpu", **kw)
        core = EngineCore(model, params, max_slots=3, max_len=128,
                          device="cpu", mesh=mesh, **kw)
        assert core.head_shard == (0, 1)
        assert all(c.head_shard == (0, 1) for c in core.state)
        assert _streams(core, reqs()) == _streams(base, reqs())
        res = core.result()
        assert res["head_shard"] == (0, 1) and res["graphs"] is False


def test_engine_refuses_unported_mesh_options(smoke):
    """A data axis > 1 (both engines) and a mesh without a ``model`` axis
    are refused; ``runahead`` and ``spec`` are taken under a mesh, as
    JAX's engine takes them."""
    _, model, params = smoke
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    dp = tmesh.Mesh({"data": 2, "model": 1}, {"data": 0, "model": 0},
                    {"data": [0, 1], "model": [0]})
    with pytest.raises(ValueError, match="data axis > 1 in the paged"):
        EngineCore(model, params, device="cpu", mesh=dp)
    with pytest.raises(ValueError, match="data axis > 1 in the static"):
        ServeEngine(model, params, 64, device="cpu", mesh=dp)
    no_model = tmesh.Mesh({"data": 1}, {"data": 0}, {"data": [0]})
    with pytest.raises(ValueError, match="no 'model' axis"):
        EngineCore(model, params, device="cpu", mesh=no_model)
    assert EngineCore(model, params, device="cpu", mesh=mesh,
                      runahead=4).runahead == 4
    assert EngineCore(model, params, device="cpu", mesh=mesh,
                      spec=SpecConfig(mode="ngram", k=2)).spec.k == 2


def test_collectives_refuse_a_wide_axis_without_a_group():
    """A rank's view of a 2-wide axis built without a world has no group:
    a gather over it raises rather than return the rank's block alone."""
    x = torch.ones((2, 3))
    with pytest.raises(ValueError, match="no process group"):
        col.allgather_concat(x, _model_mesh(2, 0), "model", axis=1)
    with pytest.raises(ValueError, match="no process group"):
        col.merge_softmax_stats(x[:, 0], x[:, 0], x, _model_mesh(2, 1),
                                "model")


def _mesh_reqs(cfg, n=4, new=6):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (int(
        rng.integers(8, 60)),)).astype(np.int32), max_new_tokens=new)
        for i in range(n)]


def test_runahead_under_a_mesh_takes_the_one_token_step(smoke):
    """``runahead=4`` under a mesh: no horizon is captured or dispatched
    (JAX's planner has ``self.mesh is None``), the streams are those of
    ``runahead=0``, and ``result()["runahead"]`` reports the horizon
    unused."""
    cfg, model, params = smoke
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    base = EngineCore(model, params, max_slots=3, max_len=128, device="cpu",
                      mesh=mesh)
    core = EngineCore(model, params, max_slots=3, max_len=128, device="cpu",
                      mesh=mesh, runahead=4)
    core.warmup([60])
    assert not core._runahead_want()
    assert _streams(core, _mesh_reqs(cfg)) == _streams(base, _mesh_reqs(cfg))
    ra = core.result()["runahead"]
    assert (ra["h"], ra["horizons"], ra["tokens"]) == (4, 0, 0)
    assert ra["dispatch_gap_ewma_s"] == 0.0


@pytest.mark.parametrize("verifier", ["jnp", "paged_fused"])
def test_spec_under_a_mesh_of_one_keeps_meshless_streams(smoke, verifier):
    """Both verifiers (span on ``"jnp"``, scan on ``"paged_fused"``) under
    a (1, 1) mesh: the head-sharded dispatch and commits give the
    meshless spec engine's streams and spec counts; the scan verifier's
    shadow state keeps the head block."""
    cfg, _, params = smoke
    model = get_model(dataclasses.replace(cfg, decode_backend=verifier))
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    spec = SpecConfig(mode="ngram", k=4)
    prompts = [np.full((36,), t, np.int32) for t in (5, 17, 300)]

    def run(m):
        core = EngineCore(model, params, max_slots=3, max_len=128,
                          device="cpu", mesh=m, spec=spec)
        core.reset()
        for i, p in enumerate(prompts):
            core.add_request(Request(rid=i, prompt=p, max_new_tokens=24))
        list(core.events())
        res = core.result()
        return core, ({r.rid: list(r.out_tokens) for r in core.completed},
                      res["spec"]["steps"], res["spec"]["accepted_tokens"])
    core, got = run(mesh)
    _, want = run(None)
    assert got == want and got[2] > 0
    if verifier == "paged_fused":
        shadows = core._graphs.verifier._shadows
        assert shadows and all(c.head_shard == (0, 1)
                               for c in shadows[0][1])


def test_static_engine_under_a_mesh_of_one(smoke):
    """``ServeEngine(mesh=)``: the caches hold head block (0, 1) and the
    tokens and cache bytes are the meshless engine's."""
    cfg, model, params = smoke
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 40))}
    gen = GenerationConfig(max_new_tokens=8)
    base = ServeEngine(model, params, 96, device="cpu").generate(batch, gen)
    eng = ServeEngine(model, params, 96, device="cpu", mesh=mesh)
    out = eng.generate(batch, gen)
    assert eng.head_shard == (0, 1) and out["head_shard"] == (0, 1)
    np.testing.assert_array_equal(out["tokens"], base["tokens"])
    assert out["cache_bytes"] == base["cache_bytes"]


@pytest.mark.parametrize("name", ["recurrentgemma-9b", "seamless-m4t-medium",
                                  "mamba2-2.7b"])
def test_static_engine_refuses_unported_families_under_a_mesh(name):
    """The hybrid, encoder-decoder and SSM families under a mesh are
    refused by name (ROADMAP queue 1)."""
    cfg = reduce_for_smoke(get_config(name))
    model = get_model(cfg)
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match=repr(cfg.family)):
        ServeEngine(model, {}, 64, device="cpu", mesh=mesh)


def test_shadow_and_gathered_views_keep_the_head_block():
    """``empty_like_cache`` (the scan verifier's shadow) and
    ``gather_view`` (the gathered decode route) keep a shard's
    ``head_shard``, so ``kv_heads`` — what #2 and #5 plan their splits
    for — stays the model's."""
    cfg = CODEC_CONFIGS[4]
    cache, table = build_fragmented_cache(cfg)
    shard = dsrv.shard_paged_state(cache, _model_mesh(2, 1))
    for c in (pgc.empty_like_cache(shard), pgc.gather_view(shard, table)):
        assert c.head_shard == (1, 2) and c.kv_heads == 4


def test_dense_fused_decode_plans_for_the_model_kv_heads(monkeypatch):
    """The dense cache's fused route (#5) hands the model's KV heads to
    the split planner, as the paged route (#2) does, so that a head shard
    sums each head in the splits of the whole call."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.quantizers import QuantConfig
    from repro_torch.kernels import polar_attention as pak
    seen = []
    real = pak.polar_decode_attention_grouped

    def spy(*a, plan_heads=None, **kw):
        seen.append(plan_heads)
        return real(*a, plan_heads=plan_heads, **kw)
    monkeypatch.setattr(pak, "polar_decode_attention_grouped", spy)
    qc = QuantConfig(method="polar", group_size=8)
    for shard, heads in ((None, 4), ((1, 2), 2)):
        c = kvc.init_cache(qc, 2, 4, 16, 32, dtype=torch.float32,
                           device="cpu", head_shard=shard)
        assert c.num_kv_heads == heads and c.kv_heads == 4
        kvc.prefill(c, torch.randn(2, heads, 20, 16),
                    torch.randn(2, heads, 20, 16))
        kvc.fused_decode_attention(c, torch.randn(2, 2 * heads, 16))
    assert seen == [4, 4]
    with pytest.raises(ValueError, match="head block"):
        kvc.init_cache(qc, 2, 4, 16, 32, device="cpu", head_shard=(0, 3))
