"""Head-sharded paged serving across processes on the CPU (DESIGN.md §17):
the port's ``distributed/serving.py`` and ``EngineCore(mesh=)`` over a
gloo world of 2 and of 4 processes, held to the JAX package.

One process group per world size, spawned once for this module
(``tests/torch_mesh_worker.py``, both worlds at once while the JAX
references are computed here); every check runs inside it and each test
reads one check's results. The checks:

* every group of the mesh carries the world's timeout;
* sharded decode and chunk prefill (every codec, ``"jnp"`` and
  ``"paged_fused"``) against the unsharded port call, bitwise, and the
  ``"jnp"`` routes against JAX's single-device ``paged_decode_attention``
  / ``paged_prefill_attention`` within 1e-6 (the plain PyTorch ops sum in
  another order than XLA's; measured equal to within a few float32
  ulps);
* appends on a head shard, 9 steps across a flush, against the same
  appends on the whole pools, bitwise;
* the GQA fallback: 2 KV heads split at world 2, replicated at world 4;
* ``context_parallel_decode``, both merges, within JAX's own atol = rtol
  = 2e-5 of the single-device path, the empty slot exactly zero;
* ``ef_allreduce_mean``: each participant's contribution and new error
  equal JAX's ``ef_allreduce_mean`` on a one-device mesh fed that
  participant's leaf (1e-6), and the mean their average (1e-6);
* ``EngineCore(mesh=)`` greedy streams equal JAX's meshless engine on
  JAX's ``_engine_requests`` (one-shot, and chunked 64 + prefix cache);
  each rank's pool bytes are the meshless engine's over the split; a run
  with arrivals after t = 0 and a sampled run give the same streams,
  events and clocks on every rank (all-gathered in the workers).
"""
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.core import paged_cache as jpgc  # noqa: E402
from repro.distributed.collectives import (  # noqa: E402
    ef_allreduce_mean as j_ef,
)
from repro.launch.mesh import make_mesh as j_make_mesh  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.core.cache_layout import PagedLayout as JLayout  # noqa: E402
from test_distributed_serving import (  # noqa: E402
    CODEC_CONFIGS as J_CODECS, _decode_q, _engine_outputs, _engine_requests,
    _tag,
)
from torch_mesh_worker import build_fragmented_cache  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_mesh_worker.py"
WORLDS = (2, 4)
#: seconds a world may take (its ranks take ~15 s on one core each)
WORLD_TIMEOUT_S = 240
#: the world's collective timeout; not the port's default (60 s), so that
#: a group left on the default would show
GROUP_TIMEOUT_S = 90.0
#: sharded "jnp" routes against JAX's: the same float32 math summed in
#: another order
JAX_TOL = 1e-6


def _spawn(job_path: Path, world: int) -> list:
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT / "src"), str(ROOT / "tests")])}
    procs = []
    for rank in range(world):
        log = open(job_path.parent / f"rank_{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(WORKER), str(job_path), str(rank),
             str(world)], env=env, stdout=log, stderr=subprocess.STDOUT,
            cwd=ROOT), log))
    return procs


def _collect(job_path: Path, procs: list) -> list:
    results, failed = [], []
    for rank, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=WORLD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append((rank, rc, (job_path.parent /
                                      f"rank_{rank}.log").read_text()))
            continue
        with open(job_path.parent / f"result_{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    assert not failed, "\n".join(f"rank {r} exited {rc}:\n{log}"
                                 for r, rc, log in failed)
    return results


def _request_specs(reqs) -> list:
    return [(r.rid, [int(t) for t in r.prompt], r.max_new_tokens)
            for r in reqs]


def _to_jax(cache, jcfg):
    """The port's paged cache as JAX's, buffer for buffer."""
    def a(x):
        if x is None:
            return None
        if x.dtype == torch.bfloat16:   # exact: bf16 -> fp32 -> bf16
            return jax.numpy.asarray(x.float().numpy(), jax.numpy.bfloat16)
        return jax.numpy.asarray(x.numpy())
    lay = cache.layout
    return jpgc.PagedKVCache(
        key_codes=a(cache.key_codes),
        key_scales={k: a(v) for k, v in cache.key_scales.items()},
        key_residual=a(cache.key_residual), value_codes=a(cache.value_codes),
        value_scale=a(cache.value_scale), value_zero=a(cache.value_zero),
        value_fp=a(cache.value_fp), lengths=a(cache.lengths), cfg=jcfg,
        layout=JLayout(page_size=lay.page_size, num_pages=lay.num_pages,
                       slots=lay.slots, pages_per_slot=lay.pages_per_slot))


def _jax_refs(jcfg, jm, jp) -> dict:
    """JAX's single-device paged attention on the caches the workers build
    (``build_fragmented_cache``, the port's draw-for-draw copy of JAX's
    function of that name, converted buffer for buffer), and JAX's
    meshless engine."""
    from torch_mesh_worker import CODEC_CONFIGS
    refs = {"kernels": {}}
    rng = np.random.default_rng(7)
    # jitted: one compile per codec instead of one per eager op
    decode = jax.jit(functools.partial(jpgc.paged_decode_attention,
                                       backend="jnp"))
    prefill = jax.jit(functools.partial(jpgc.paged_prefill_attention,
                                        backend="jnp"), static_argnums=(5, 6))
    for cfg, tcfg in zip(J_CODECS, CODEC_CONFIGS, strict=True):
        assert _tag(cfg) == f"{tcfg.method}+v{tcfg.value_bits}"
        tcache, ttable = build_fragmented_cache(tcfg)
        cache = _to_jax(tcache, cfg)
        table = jax.numpy.asarray(ttable.numpy())
        q = _decode_q()
        refs["kernels"][(_tag(cfg), "decode")] = np.asarray(
            decode(cache, q, table))
        qp, kp, vp = (jax.numpy.asarray(rng.standard_normal(
            (1, h, 16, 16)), jax.numpy.float32) for h in (8, 4, 4))
        refs["kernels"][(_tag(cfg), "prefill")] = np.asarray(
            prefill(cache, qp, kp, vp, table[0], 32, 13))
    refs["engine"] = {
        "oneshot": _engine_outputs(jm, jp, _engine_requests(jcfg)),
        "prefix": _engine_outputs(
            jm, jp, _engine_requests(jcfg, shared_prefix=64, seed=5),
            prefill_chunk=64, prefix_cache=True)}
    return refs


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{"worlds": {world: [rank results]}, "refs": the JAX references}."""
    jcfg = j_reduce(j_get_config("tinyllama-1.1b"))
    jm = j_get_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    base = {"params": jax.tree.map(np.asarray, jp),
            "timeout_s": GROUP_TIMEOUT_S,
            "requests": _request_specs(_engine_requests(jcfg)),
            "requests_sp": _request_specs(
                _engine_requests(jcfg, shared_prefix=64, seed=5))}
    started = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"mesh{world}")
        job = d / "job.pkl"
        with open(job, "wb") as f:
            pickle.dump({**base, "init_method": f"file://{d / 'rdzv'}"}, f)
        started[world] = (job, _spawn(job, world))
    refs = _jax_refs(jcfg, jm, jp)
    worlds = {w: _collect(job, procs) for w, (job, procs) in started.items()}
    return {"worlds": worlds, "refs": refs}


def _ranks(mesh_runs, world):
    res = mesh_runs["worlds"][world]
    assert [r["coords"]["model"] for r in res] == list(range(world))
    return res


@pytest.mark.parametrize("world", WORLDS)
def test_every_mesh_group_has_the_world_timeout(mesh_runs, world):
    """``make_mesh`` gives each group it creates the timeout of
    ``init_world`` (a group without one would wait up to 30 min on
    diverged ranks)."""
    for res in _ranks(mesh_runs, world):
        assert res["timeouts"], "no group read back"
        assert res["timeouts"] == [GROUP_TIMEOUT_S] * len(res["timeouts"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("site", ["decode", "prefill"])
def test_sharded_attention_matches_unsharded_and_jax(mesh_runs, world, site):
    """Every codec, both backends: the gathered heads of every rank equal
    the unsharded port call bit for bit, and the ``"jnp"`` route is
    within 1e-6 of JAX's single-device call."""
    refs = mesh_runs["refs"]["kernels"]
    for res in _ranks(mesh_runs, world):
        for (tag, s, backend), (got, whole) in res["kernels"].items():
            if s != site:
                continue
            assert np.array_equal(got, whole), (tag, site, backend)
            if backend == "jnp":
                np.testing.assert_allclose(got, refs[(tag, site)],
                                           rtol=JAX_TOL, atol=JAX_TOL,
                                           err_msg=f"{tag} {site}")


@pytest.mark.parametrize("world", WORLDS)
def test_append_on_head_shard_matches_whole_pools(mesh_runs, world):
    for rank, res in enumerate(_ranks(mesh_runs, world)):
        for tag, r in res["append"].items():
            assert r["head_shard"] == (rank, world)
            assert r["heads"] == 4 // world
            assert all(r["equal"].values()), (tag, r["equal"])
            np.testing.assert_array_equal(r["lengths"], [46, 5, 30])


@pytest.mark.parametrize("world", WORLDS)
def test_gqa_fallback_replicates_where_heads_do_not_divide(mesh_runs, world):
    """2 KV heads: one a rank at world 2; at world 4 every rank holds the
    whole pools, every spec is replicated and the plain path runs."""
    for rank, res in enumerate(_ranks(mesh_runs, world)):
        fb = res["fallback"]
        assert fb["equal"]
        if world == 4:
            assert fb["head_shard"] is None and fb["pool_heads"] == 2
            assert fb["replicated_specs"] and fb["active_axis"] is None
        else:
            assert fb["head_shard"] == (rank, 2) and fb["pool_heads"] == 1
            assert not fb["replicated_specs"]
            assert fb["active_axis"] == "model"


@pytest.mark.parametrize("world", WORLDS)
def test_context_parallel_decode_matches_jax(mesh_runs, world):
    refs = mesh_runs["refs"]["kernels"]
    for res in _ranks(mesh_runs, world):
        for (tag, merge), out in res["context_parallel"].items():
            ref = refs[(tag, "decode")]
            assert np.all(np.isfinite(out)), (tag, merge)
            np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5,
                                       err_msg=f"{tag}/{merge}")
            assert np.array_equal(out[1], np.zeros_like(ref[1])), (tag, merge)


@pytest.fixture(scope="module")
def j_ef_one():
    """JAX's ``ef_allreduce_mean`` on one participant: ``_ef_leaf`` under a
    one-member named axis (a size-1 ``vmap``), jitted once per leaf shape
    — a one-device mesh's math without a ``shard_map`` compile per call
    (held to the public function on participant 0 within 1e-6: XLA fuses
    the two programs differently, 1e-7 apart)."""
    from repro.distributed.collectives import _ef_leaf
    f = jax.jit(jax.vmap(lambda g, e: _ef_leaf(g, e, "dp"), axis_name="dp"))

    def one(g, e):   # g, e: this participant's leaf (...)
        mean, err = f(g[None, None], e[None, None])
        return np.asarray(mean[0]), np.asarray(err[0, 0])
    return one


@pytest.mark.parametrize("world", WORLDS)
def test_ef_allreduce_mean_matches_jax_per_participant(mesh_runs, world,
                                                       j_ef_one):
    """Each participant's dequantized contribution and new error equal
    JAX's on a one-participant mesh fed its leaf, over two steps (the
    second carries the first's error), and the collective's mean is the
    contributions' average (1e-6)."""
    res = _ranks(mesh_runs, world)
    tol = dict(rtol=1e-6, atol=1e-6)
    if world == WORLDS[0]:
        g = res[0]["ef"]["g"]
        leaves = {"w": g["w"][None], "b": [g["b"][0][None]]}
        jmean, jerr = j_ef(leaves, jax.tree.map(np.zeros_like, leaves),
                           j_make_mesh((1,), ("dp",)))
        for key, jm_, je_ in (("w", jmean["w"], jerr["w"]),
                              ("b", jmean["b"][0], jerr["b"][0])):
            leaf = g[key] if key == "w" else g["b"][0]
            m1, e1 = j_ef_one(leaf, np.zeros_like(leaf))
            np.testing.assert_allclose(m1, np.asarray(jm_), **tol)
            np.testing.assert_allclose(e1, np.asarray(je_)[0], **tol)
    contribs = []
    for r in res:
        ef = r["ef"]
        w, b = ef["g"]["w"], ef["g"]["b"][0]
        m_w, e_w = j_ef_one(w, np.zeros_like(w))
        m_b, e_b = j_ef_one(b, np.zeros_like(b))
        np.testing.assert_allclose(ef["contrib_w"], m_w, **tol)
        np.testing.assert_allclose(ef["new_err_w"], e_w, **tol)
        np.testing.assert_allclose(ef["err"]["w"], e_w, **tol)
        np.testing.assert_allclose(ef["err"]["b"], e_b, **tol)
        m2_w, e2_w = j_ef_one(w, e_w)
        np.testing.assert_allclose(ef["err2_w"], e2_w, **tol)
        contribs.append((m_w, m_b, m2_w))
    for r in res:
        for i, got in enumerate((r["ef"]["mean"]["w"], r["ef"]["mean"]["b"],
                                 r["ef"]["mean2_w"])):
            np.testing.assert_allclose(
                got, np.mean([c[i] for c in contribs], 0), **tol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("run", ["oneshot", "prefix"])
def test_mesh_engine_streams_match_jax_meshless(mesh_runs, world, run):
    """Smoke tinyllama (4 / 2 heads): pools split one KV head a rank at
    world 2, replicated at world 4; greedy streams == JAX's meshless
    engine either way, the decode steps eager (CPU)."""
    want = mesh_runs["refs"]["engine"][run]
    assert want and all(want.values())
    for rank, res in enumerate(_ranks(mesh_runs, world)):
        e = res["engine"][run]
        assert e["streams"] == want, (world, rank, run)
        assert e["head_shard"] == ((rank, 2) if world == 2 else None)
        assert e["graphs"] is False


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_engine_pool_bytes_split_over_heads(mesh_runs, world):
    """Each rank's cache bytes: the meshless engine's pools over the
    split, the per-slot lengths whole (2 layers x 3 slots x int32)."""
    lengths = 2 * 3 * 4
    for res in _ranks(mesh_runs, world):
        e = res["engine"]
        whole = e["sampled_meshless_bytes"] - lengths
        got = e["oneshot"]["cache_bytes"] - lengths
        assert got * (2 if world == 2 else 1) == whole


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("run", ["arrivals", "sampled"])
def test_mesh_engine_ranks_agree(mesh_runs, world, run):
    """Arrivals after t = 0 (the clock advances by rank 0's measurement)
    and temperature sampling (generators seeded alike, sampling from the
    same gathered logits): the same streams, events and clocks on every
    rank; the sampled streams also equal the meshless port engine's."""
    res = _ranks(mesh_runs, world)
    assert all(r["engine"]["ranks_agree"] for r in res)
    first = res[0]["engine"][run]
    assert first["streams"] and all(first["streams"].values())
    for r in res[1:]:
        assert r["engine"][run]["streams"] == first["streams"]
        assert r["engine"][run]["events"] == first["events"]
    if run == "sampled":
        assert first["streams"] == res[0]["engine"]["sampled_meshless"]
