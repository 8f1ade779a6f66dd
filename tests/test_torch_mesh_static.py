"""The static engine under a mesh, ``ServeEngine(mesh=)`` (which installs
``serving_rules``), across processes on the CPU (DESIGN.md §17),
held to the JAX package.

Gloo worlds of 2 and 4 processes are spawned once for this module
(``tests/torch_mesh_worker.py``, jobs of kind ``"static"``) while JAX's
meshless ``ServeEngine`` runs here, once a config. On every rank of both
worlds the tokens equal JAX's — tinyllama on both decode routes (#6's
score route and #5's fused one; 2 KV heads: split at 2, the GQA fallback
at 4), the qwen2-moe smoke reduction (4 KV heads: split at 2 and at 4),
paligemma (1 KV head: the fallback), recurrentgemma (1 KV head: whole
rings, the RG-LRU width split at 2 and 4; and with 2 KV heads, rings
split at 2), seamless (4 KV heads: self and cross caches split at 2 and
4, frames from numpy) and mamba2 (16 SSD heads: split at 2 and 4). The
prefill's and every decode step's logits are bit-equal to the port's
meshless engine (run once a case, in a rank of the world of 2), and each
rank's state bytes are the meshless state's parts over the split where
the placement (``registry.state_split_axes``, held to JAX's rules in
``tests/test_torch_distributed.py``) splits them and whole where it does
not. The params are the port's init (``weights.params_to_jax`` for JAX),
so no JAX init is compiled; JAX's references compile two at a time.
"""
import dataclasses
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import reduce_for_smoke as j_reduce  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import mamba2 as j_m2  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.registry import state_split_axes  # noqa: E402
from repro_torch.weights import params_to_jax  # noqa: E402
from test_torch_mesh_serve import (  # noqa: E402
    GROUP_TIMEOUT_S, _collect, _spawn,
)
from torch_mesh_worker import (  # noqa: E402
    STATIC_OVERRIDES, _cfg, static_cfg_kw, static_model_key,
)

WORLDS = (2, 4)
#: the world whose ranks also run the meshless engine, a case a rank
MESHLESS_WORLD = 2
#: threads that compile JAX's references at once
JAX_THREADS = 2
#: (config, decode backend[, override tag]) -> (batch, new tokens,
#: max_len): tinyllama's prompt crosses a group flush while it decodes
#: (g 32: positions 50..66); recurrentgemma's 70-token prompt wraps its
#: 64-slot ring at prefill; seamless's self cache flushes at 31; mamba2's
#: prompt is a chunk and a ragged one
STATIC = {("tinyllama-1.1b", "jnp"): (50, 17, 128),
          ("tinyllama-1.1b", "paged_fused"): (50, 17, 128),
          ("qwen2-moe-a2.7b", "jnp"): (40, 8, 64),
          ("paligemma-3b", "jnp"): (20, 6, 64),
          ("recurrentgemma-9b", "jnp"): (70, 8, 128),
          ("recurrentgemma-9b", "jnp", "kv2"): (70, 8, 128),
          ("seamless-m4t-medium", "paged_fused"): (20, 17, 64),
          ("mamba2-2.7b", "jnp"): (40, 8, 64)}


def _jcfg(key):
    """JAX's config of a static case."""
    return dataclasses.replace(j_reduce(j_get_config(key[0])),
                               decode_backend=key[1],
                               **(STATIC_OVERRIDES[key[2]]
                                  if len(key) > 2 else {}))


def _static_cases() -> dict:
    """Each case's numpy batch (the VLM with its patches) and JAX's
    config."""
    cases = {}
    for i, (key, (t, new, max_len)) in enumerate(STATIC.items()):
        jcfg = _jcfg(key)
        rng = np.random.default_rng(i)
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, t)).astype(
            np.int32)}
        front = {"vlm": "patches", "encdec": "frames"}.get(jcfg.family)
        if front:
            batch[front] = rng.standard_normal(
                (2, jcfg.frontend_tokens, jcfg.frontend_dim)).astype(
                    np.float32)
        cases[key] = {"batch": batch, "new": new, "max_len": max_len,
                      "jcfg": jcfg}
    return cases


def _jax_refs(cases, params) -> dict:
    """JAX's meshless ``ServeEngine`` tokens of every case, one engine a
    case, the engines' compiles side by side."""
    def ref(key):
        case = cases[key]
        eng = jserve.ServeEngine(j_get_model(case["jcfg"]),
                                 params[static_model_key(key)][0],
                                 max_len=case["max_len"])
        return eng.generate(
            {k: jnp.asarray(v) for k, v in case["batch"].items()},
            jserve.GenerationConfig(max_new_tokens=case["new"]))["tokens"]
    with ThreadPoolExecutor(JAX_THREADS) as pool:
        return dict(zip(cases, pool.map(ref, cases)))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """{"worlds": {world: [rank results]}, "refs": the JAX references,
    "meshless": {case: the port's meshless tokens and logits}}."""
    cases = _static_cases()
    params = {}
    for key in cases:
        name = static_model_key(key)
        if name not in params:
            cfg = _cfg(key[0], **static_cfg_kw(key))
            p = params_to_jax(get_model(cfg).init(
                torch.Generator().manual_seed(0), "cpu"), cfg)
            params[name] = (jax.tree.map(jnp.asarray, p), p)
    job = {"kind": "static", "timeout_s": GROUP_TIMEOUT_S,
           "meshless_world": MESHLESS_WORLD,
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
    meshless = {k: g["meshless"] for res in worlds[MESHLESS_WORLD]
                for k, g in res["static"].items() if "meshless" in g}
    assert sorted(meshless) == sorted(cases)
    return {"worlds": worlds, "refs": refs, "meshless": meshless}


def _ranks(mesh_runs, world):
    res = mesh_runs["worlds"][world]
    assert [r["coords"]["model"] for r in res] == list(range(world))
    return res


class _ShapeMesh:
    """A (1, ``world``) mesh's shape, all the placement reads."""

    def __init__(self, world: int):
        self.shape = {"data": 1, "model": world}
        self.axis_names = tuple(self.shape)


def _splits(key, world: int) -> dict:
    """Whether each logical axis of a case's state splits over ``world``
    ranks (``registry.state_split_axes``)."""
    cfg = _cfg(key[0], **static_cfg_kw(key))
    return {k: a is not None
            for k, a in state_split_axes(cfg, _ShapeMesh(world)).items()}


def _case_id(key) -> str:
    return "-".join(key)


@pytest.mark.parametrize("case", sorted(STATIC), ids=_case_id)
@pytest.mark.parametrize("world", WORLDS)
def test_static_engine_under_a_mesh_matches_jax_meshless(mesh_runs, world,
                                                         case):
    """``ServeEngine(mesh=)``: tokens equal JAX's meshless ``ServeEngine``;
    the caches hold the rank's head block where the KV heads divide the
    ranks, every head otherwise, and the recurrent states the rank's
    block of the width or heads where ``serving_rules`` splits them."""
    want = mesh_runs["refs"][case]
    split = _splits(case, world)
    # mamba2 has no caches, whatever JAX's rule makes of its 0 KV heads
    assert ("kv_heads" in split) == (_jcfg(case).family != "ssm")
    for rank, res in enumerate(_ranks(mesh_runs, world)):
        got = res["static"][case]
        np.testing.assert_array_equal(got["tokens"], np.asarray(want))
        assert got["head_shard"] == ((rank, world) if split.get("kv_heads")
                                     else None)
        assert got["state_blocks"] == {
            k: (rank, world) if v else None for k, v in split.items()
            if k != "kv_heads"}


@pytest.mark.parametrize("case", sorted(STATIC), ids=_case_id)
@pytest.mark.parametrize("world", WORLDS)
def test_static_logits_under_a_mesh_equal_meshless(mesh_runs, world, case):
    """The mesh engine's prefill logits and every decode step's are bit
    for bit the port's meshless engine's: a rank computes its block's
    channels and heads with the meshless ops, and the gather is exact."""
    base = mesh_runs["meshless"][case]
    np.testing.assert_array_equal(base["tokens"],
                                  np.asarray(mesh_runs["refs"][case]))
    for rank, res in enumerate(_ranks(mesh_runs, world)):
        got = res["static"][case]
        assert len(got["logits"]) == len(base["logits"]) == STATIC[case][1]
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(got["logits"], base["logits"]))
        assert all(np.array_equal(a, b) for a, b in
                   zip(got["logits"], base["logits"])), (rank, diff)
        np.testing.assert_array_equal(got["tokens"], base["tokens"])


def _want_part(key, part: str, meshless: int, world: int) -> int:
    """A rank's bytes of one state part: the meshless part over the split
    where its logical axis splits, whole where it does not; the SSM's conv
    window holds the block's ``xin`` channels and every B/C channel."""
    split = _splits(key, world)
    if part in ("kv", "ring", "self", "cross"):
        return meshless // world if split["kv_heads"] else meshless
    if part in ("rg_conv", "rg_h"):
        return meshless // world if split["rec_width"] else meshless
    if part == "ssd":
        return meshless // world if split["ssm_heads"] else meshless
    assert part == "ssd_conv", part
    dm = j_m2.dims(_jcfg(key))
    n = world if split["ssm_heads"] else 1
    return meshless // dm.conv_dim * (dm.d_inner // n
                                      + 2 * dm.ngroups * dm.dstate)


@pytest.mark.parametrize("world", WORLDS)
def test_static_cache_bytes_split_over_heads(mesh_runs, world):
    """Each rank's state bytes by part (the whole length scalars left
    out): the caches' (linear, ring, the encoder-decoder's self and cross)
    are the meshless state's over the split where the KV heads divide and
    all of them where they do not; the RG-LRU conv windows and h over the
    split of the width; the SSD states over the split of the heads; the
    SSM's conv windows the block's ``xin`` channels and the whole B/C."""
    for res in _ranks(mesh_runs, world):
        for case, got in res["static"].items():
            assert sorted(got["parts"]) == sorted(got["meshless_parts"])
            for part, n in got["parts"].items():
                assert n == _want_part(case, part,
                                       got["meshless_parts"][part], world), \
                    (case, world, part, n, got["meshless_parts"][part])
