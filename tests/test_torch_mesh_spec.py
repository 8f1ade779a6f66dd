"""Speculative decode and run-ahead on ``EngineCore(mesh=)`` across
processes on the CPU (DESIGN.md §15, §17, §18), held to the JAX package.

A gloo world of 2 processes is spawned once for this module
(``tests/torch_mesh_worker.py``, a job of kind ``"spec"``: the smoke
tinyllama's 2 KV heads, one a rank) while the JAX references are
computed here. The checks:

* greedy streams, ``result()["spec"]`` counts, decode steps and events
  of both verifiers (span on ``"jnp"``, scan on ``"paged_fused"``) with
  the ngram and the draft proposer (k 2; JAX's draft weights carried
  across) equal JAX's meshless spec engine's on every rank; the
  scan verifier's shadow state holds the rank's head block;
* ``runahead=4`` gives the streams and events of ``runahead=0`` and
  reports the horizon unused, as JAX's engine reports it on a mesh.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import serve as jserve  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.launch.mesh import make_mesh as j_make_mesh  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.spec.draft import _derive_draft_cfg as j_derive  # noqa: E402
from test_distributed_serving import _engine_requests  # noqa: E402
from test_torch_mesh_serve import (  # noqa: E402
    GROUP_TIMEOUT_S, _collect, _request_specs, _spawn,
)
from torch_mesh_worker import _events  # noqa: E402

WORLD = 2
SPEC = {"ngram": 2, "draft": 2}
VERIFIERS = ("span", "scan")


def _spec_prompts(vocab, n=4, seed=3):
    """``tests/test_torch_spec.py``'s single-token prompts: greedy
    continuations fall into short cycles, giving ngram real acceptance."""
    rng = np.random.RandomState(seed)
    return [np.full((36,), rng.randint(0, vocab), np.int32)
            for _ in range(n)]


def _jax_refs(jm, jp) -> dict:
    refs = {}
    prompts = _spec_prompts(jm.cfg.vocab_size)
    for mode, k in SPEC.items():
        eng = jserve.ContinuousBatchingEngine(
            jm, jp, max_slots=2, max_len=128,
            spec=jspec.SpecConfig(mode=mode, k=k))
        out = eng.run([jserve.Request(rid=i, prompt=p, max_new_tokens=32)
                       for i, p in enumerate(prompts)])
        refs[mode] = {
            "streams": {r.rid: [int(t) for t in r.out_tokens]
                        for r in out["requests"]},
            "events": _events(out["events"]),
            "counts": (out["spec"]["steps"], out["spec"]["drafted_tokens"],
                       out["spec"]["accepted_tokens"]),
            "decode_steps": out["decode_steps"]}
    # JAX's engine takes runahead on a mesh, and its horizon planner is
    # off there even with nothing in the way (no request, no prefill):
    # what it reports is the unused horizon
    core = jserve.EngineCore(jm, jp, max_slots=3, max_len=128, runahead=4,
                             mesh=j_make_mesh((1, 1), ("data", "model")))
    ra = core.result()["runahead"]
    refs["runahead"] = (core._runahead_want(), ra["h"], ra["horizons"],
                        ra["tokens"])
    return refs


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{"ranks": [rank results], "refs": the JAX references}."""
    jcfg = j_reduce(j_get_config("tinyllama-1.1b"))
    jm = j_get_model(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    dspec = jspec.SpecConfig(mode="draft", k=SPEC["draft"])
    djp = j_get_model(j_derive(jcfg, dspec)).init(
        jax.random.PRNGKey(dspec.draft_seed))
    d = tmp_path_factory.mktemp("spec")
    path = d / "job.pkl"
    with open(path, "wb") as f:
        pickle.dump({"kind": "spec", "timeout_s": GROUP_TIMEOUT_S,
                     "spec": SPEC,
                     "init_method": f"file://{d / 'rdzv'}",
                     "params": jax.tree.map(np.asarray, jp),
                     "draft_params": jax.tree.map(np.asarray, djp),
                     "spec_prompts": _spec_prompts(jcfg.vocab_size),
                     "requests": _request_specs(_engine_requests(jcfg))}, f)
    procs = _spawn(path, WORLD)
    refs = _jax_refs(jm, jp)
    ranks = _collect(path, procs)
    assert [r["coords"]["model"] for r in ranks] == list(range(WORLD))
    return {"ranks": ranks, "refs": refs}


@pytest.mark.parametrize("mode", sorted(SPEC))
@pytest.mark.parametrize("verifier", VERIFIERS)
def test_spec_under_a_mesh_matches_jax_meshless(mesh_runs, verifier, mode):
    """Each rank's streams, events, spec counts and decode steps equal
    JAX's meshless spec engine's; every rank speculated on its head
    block."""
    want = mesh_runs["refs"][mode]
    assert want["counts"][2] > 0
    for rank, res in enumerate(mesh_runs["ranks"]):
        got = res["spec"][(verifier, mode)]
        assert got["head_shard"] == (rank, WORLD)
        assert got["streams"] == want["streams"], (verifier, mode, rank)
        assert got["events"] == want["events"], (verifier, mode, rank)
        assert got["counts"] == want["counts"]
        assert got["decode_steps"] == want["decode_steps"]
        assert got["proposer_faults"] == 0
        if verifier == "scan":
            assert got["shadow_blocks"] and set(got["shadow_blocks"]) == \
                {(rank, WORLD)}


def test_runahead_under_a_mesh_equals_runahead_0(mesh_runs):
    """``runahead=4`` under the mesh: the streams and events of
    ``runahead=0``, and the horizon reported unused as JAX's engine
    reports it on a mesh."""
    gate, *want = mesh_runs["refs"]["runahead"]
    assert gate is False and want == [4, 0, 0]
    for res in mesh_runs["ranks"]:
        ra = res["runahead"]
        assert ra[4]["streams"] == ra[0]["streams"]
        assert ra[4]["events"] == ra[0]["events"]
        assert ra[0]["runahead"] is None
        got = ra[4]["runahead"]
        assert [got["h"], got["horizons"], got["tokens"]] == want
