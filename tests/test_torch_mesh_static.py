"""The static engine under a mesh, ``ServeEngine(mesh=)`` (which installs
``serving_rules``), across processes on the CPU (DESIGN.md §17),
held to the JAX package.

Gloo worlds of 2 and 4 processes are spawned once for this module
(``tests/torch_mesh_worker.py``, jobs of kind ``"static"``) while JAX's
meshless ``ServeEngine`` runs here. On every rank of both worlds the
tokens equal JAX's — tinyllama on both decode routes (#6's score route
and #5's fused one; 2 KV heads: split at 2, the GQA fallback at 4), the
qwen2-moe smoke reduction (4 KV heads: split at 2 and at 4) and
paligemma (1 KV head: the fallback) —, and each rank's linear-cache
bytes are the meshless state's over the split where the KV heads divide,
all of them where they do not.
"""
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from test_torch_mesh_serve import (  # noqa: E402
    GROUP_TIMEOUT_S, _collect, _spawn,
)

WORLDS = (2, 4)
#: (config, decode backend) -> (batch, new tokens, max_len): tinyllama's
#: prompt crosses a group flush while it decodes (g 32: positions 50..66)
STATIC = {("tinyllama-1.1b", "jnp"): (50, 17, 128),
          ("tinyllama-1.1b", "paged_fused"): (50, 17, 128),
          ("qwen2-moe-a2.7b", "jnp"): (40, 8, 64),
          ("paligemma-3b", "jnp"): (20, 6, 64)}


def _static_cases() -> dict:
    """Each case's numpy batch (the VLM with its patches) and JAX's
    config."""
    cases = {}
    for i, ((name, backend), (t, new, max_len)) in enumerate(STATIC.items()):
        jcfg = dataclasses.replace(j_reduce(j_get_config(name)),
                                   decode_backend=backend)
        rng = np.random.default_rng(i)
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, t)).astype(
            np.int32)}
        if jcfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (2, jcfg.frontend_tokens, jcfg.frontend_dim)).astype(
                    np.float32)
        cases[(name, backend)] = {"batch": batch, "new": new,
                                  "max_len": max_len, "jcfg": jcfg}
    return cases


def _jax_refs(cases, params) -> dict:
    refs = {}
    for key, case in cases.items():
        eng = jserve.ServeEngine(j_get_model(case["jcfg"]),
                                 params[key[0]][0], max_len=case["max_len"])
        refs[key] = eng.generate(
            {k: jnp.asarray(v) for k, v in case["batch"].items()},
            jserve.GenerationConfig(max_new_tokens=case["new"]))["tokens"]
    return refs


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{"worlds": {world: [rank results]}, "refs": the JAX references}."""
    cases = _static_cases()
    params = {}
    for name, _ in cases:
        if name not in params:
            m = j_get_model(j_reduce(j_get_config(name)))
            p = jax.jit(m.init)(jax.random.PRNGKey(0))
            params[name] = (p, jax.tree.map(np.asarray, p))
    job = {"kind": "static", "timeout_s": GROUP_TIMEOUT_S,
           "static": {k: {f: c[f] for f in ("batch", "new", "max_len")}
                      for k, c in cases.items()},
           "static_params": {n: p[1] for n, p in params.items()}}
    started = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"static{world}")
        path = d / "job.pkl"
        with open(path, "wb") as f:
            pickle.dump({**job, "init_method": f"file://{d / 'rdzv'}"}, f)
        started[world] = (path, _spawn(path, world))
    refs = _jax_refs(cases, params)
    worlds = {w: _collect(path, procs)
              for w, (path, procs) in started.items()}
    return {"worlds": worlds, "refs": refs}


def _ranks(mesh_runs, world):
    res = mesh_runs["worlds"][world]
    assert [r["coords"]["model"] for r in res] == list(range(world))
    return res


@pytest.mark.parametrize("case", sorted(STATIC), ids="-".join)
@pytest.mark.parametrize("world", WORLDS)
def test_static_engine_under_a_mesh_matches_jax_meshless(mesh_runs, world,
                                                         case):
    """``ServeEngine(mesh=)``: tokens equal JAX's
    meshless ``ServeEngine``; the caches hold the rank's head block where
    the KV heads divide the ranks, every head otherwise."""
    want = mesh_runs["refs"][case]
    kv = j_reduce(j_get_config(case[0])).num_kv_heads
    for rank, res in enumerate(_ranks(mesh_runs, world)):
        got = res["static"][case]
        np.testing.assert_array_equal(got["tokens"], np.asarray(want))
        assert got["head_shard"] == ((rank, world) if kv % world == 0
                                     else None)


@pytest.mark.parametrize("world", WORLDS)
def test_static_cache_bytes_split_over_heads(mesh_runs, world):
    """Each rank's linear-cache bytes (the whole length scalars left out)
    are exactly the meshless state's over the split where the KV heads
    divide, and all of them where they do not."""
    for res in _ranks(mesh_runs, world):
        for case, got in res["static"].items():
            kv = j_reduce(j_get_config(case[0])).num_kv_heads
            n = world if kv % world == 0 else 1
            assert got["bytes"] * n == got["meshless_bytes"], (case, world)
