"""One rank of the CPU mesh-serving checks (``tests/test_torch_mesh_serve.py``)
and the cache constructors the port's distributed tests share.

Run as ``python tests/torch_mesh_worker.py JOB RANK WORLD`` with ``src`` on
``PYTHONPATH``: it joins a gloo world of WORLD processes through a file
rendezvous beside JOB (a pickle the test wrote), runs every check of
:func:`run_checks` (or, for a job of kind ``"spec"`` or ``"static"``,
of :func:`run_engine_checks`: ``tests/test_torch_mesh_spec.py`` and
``tests/test_torch_mesh_static.py``) as rank
RANK of a (1, WORLD) mesh and pickles its results to ``result_<RANK>.pkl``
beside JOB. It imports torch and the
port only; the test compares the results with the JAX package. Any
exception fails the rank (non-zero exit, traceback on stderr).
"""
from __future__ import annotations

import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import paged_cache as pgc
from repro_torch.core.cache_layout import PagedLayout
from repro_torch.core.quantizers import QuantConfig

#: ``tests/test_distributed_serving.py::CODEC_CONFIGS``: every codec, page
#: == group of 8, and polar with 4-bit values
CODEC_CONFIGS = [
    QuantConfig(method="none", group_size=8),
    QuantConfig(method="int", group_size=8),
    QuantConfig(method="kivi", group_size=8),
    QuantConfig(method="zipcache", group_size=8),
    QuantConfig(method="polar", group_size=8),
    QuantConfig(method="polar", group_size=8, value_bits=4),
]


def tag(cfg: QuantConfig) -> str:
    return f"{cfg.method}+v{cfg.value_bits}"


def build_fragmented_cache(cfg, *, hkv=4, d=16, lens=(37, 0, 21), seed=0):
    """``tests/test_distributed_serving.py::build_fragmented_cache`` in the
    port, draw for draw: a paged cache filled by real appends over a
    permuted page table (slot 0 ends mid-group, slot 1 is empty, slot 2 is
    short), on the CPU. Returns (cache, table)."""
    lay = PagedLayout(page_size=8, num_pages=24, slots=len(lens),
                      pages_per_slot=6)
    rng = np.random.default_rng(seed)
    cache = pgc.init_paged_cache(cfg, lay, hkv, d, dtype=torch.float32,
                                 device="cpu")
    table = np.full((lay.slots, lay.pages_per_slot), -1, np.int32)
    perm, off = rng.permutation(lay.num_pages), 0
    for s, ln in enumerate(lens):
        k = -(-ln // lay.page_size)
        table[s, :k] = perm[off:off + k]
        off += k
    table = torch.from_numpy(table)
    for t in range(max(lens)):
        active = torch.tensor([t < ln for ln in lens])
        k_new = torch.from_numpy(rng.standard_normal(
            (lay.slots, hkv, 1, d)).astype(np.float32))
        v_new = torch.from_numpy(rng.standard_normal(
            (lay.slots, hkv, 1, d)).astype(np.float32))
        cache = pgc.paged_append(cache, k_new, v_new, table, active)
    return cache, table


def decode_q(hq=8, d=16, slots=3, seed=1) -> torch.Tensor:
    """``tests/test_distributed_serving.py::_decode_q``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((slots, hq, d)).astype(
        np.float32))


def prefill_inputs(seed=7, tc=16, d=16, hq=8, hkv=4):
    """The chunk of ``check_prefill_parity``: q, k, v drawn per codec from
    one generator (call :func:`next` once per codec, in order)."""
    rng = np.random.default_rng(seed)
    while True:
        yield tuple(torch.from_numpy(rng.standard_normal(
            (1, h, tc, d)).astype(np.float32)) for h in (hq, hkv, hkv))


def _np(x):
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# the rank's checks
# ---------------------------------------------------------------------------


def _kernel_parity(mesh) -> dict:
    """Sharded decode and chunk prefill per codec and backend, with the
    unsharded port call beside them."""
    from repro_torch.distributed import serving as dsrv
    out = {}
    pre = prefill_inputs()
    for cfg in CODEC_CONFIGS:
        cache, table = build_fragmented_cache(cfg)
        shard = dsrv.shard_paged_state(cache, mesh)
        q = decode_q()
        qp, kp, vp = next(pre)
        row = table[0]
        for backend in ("jnp", "paged_fused"):
            dec_backend = "jnp" if backend == "jnp" else "paged_fused"
            out[(tag(cfg), "decode", backend)] = (
                _np(dsrv.sharded_paged_decode_attention(
                    shard, q, table, mesh=mesh, backend=dec_backend)),
                _np(pgc.paged_decode_attention(cache, q, table,
                                               backend=dec_backend)))
            out[(tag(cfg), "prefill", backend)] = (
                _np(dsrv.sharded_paged_prefill_attention(
                    shard, qp, kp, vp, row, 32, 13, mesh=mesh,
                    backend=backend)),
                _np(pgc.paged_prefill_attention(cache, qp, kp, vp, row, 32,
                                                13, backend=backend)))
    return out


def _append_parity(mesh) -> dict:
    """Nine appends that cross a flush on the rank's head shard against
    the same appends on the whole pools: the rank's block of every leaf
    and the lengths, bitwise."""
    from repro_torch.distributed import serving as dsrv
    rng = np.random.default_rng(11)
    out = {}
    for cfg in (CODEC_CONFIGS[4], CODEC_CONFIGS[5]):
        cache, table = build_fragmented_cache(cfg)
        shard = dsrv.shard_paged_state(cache, mesh)
        for t in range(9):
            active = torch.tensor([True, t % 2 == 0, True])
            k = torch.from_numpy(rng.standard_normal((3, 4, 1, 16)).astype(
                np.float32))
            v = torch.from_numpy(rng.standard_normal((3, 4, 1, 16)).astype(
                np.float32))
            cache = pgc.paged_append(cache, k, v, table, active)
            shard = pgc.paged_append(shard, dsrv.local_heads(shard, k),
                                     dsrv.local_heads(shard, v), table,
                                     active)
        want = dsrv.shard_paged_state(cache, mesh)
        equal = {}
        for f in dsrv._FIELDS:
            a, b = getattr(want, f), getattr(shard, f)
            if isinstance(a, dict):
                for k in a:
                    equal[f"{f}/{k}"] = torch.equal(a[k], b[k])
            elif a is not None:
                equal[f] = torch.equal(a, b)
        out[tag(cfg)] = {"equal": equal, "head_shard": shard.head_shard,
                         "lengths": _np(shard.lengths),
                         "heads": shard.key_codes.shape[1]}
    return out


def _fallback(mesh) -> dict:
    """hkv 2 with 4 query heads: sharded at world 2, replicated (the GQA
    fallback) at world 4, and the same output either way."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed import serving as dsrv
    cfg = QuantConfig(method="polar", group_size=8)
    cache, table = build_fragmented_cache(cfg, hkv=2)
    q = decode_q(hq=4)
    placed = dsrv.shard_paged_state(cache, mesh)
    specs = dsrv.paged_state_shardings(cache, mesh)
    with ctx.use_sharding(mesh, {"kv_heads": "model"}):
        active = dsrv._active_head_axis(placed, 4)
        got = dsrv.dispatch_paged_decode_attention(placed, q, table,
                                                   backend="jnp")
    ref = pgc.paged_decode_attention(cache, q, table, backend="jnp")
    return {"head_shard": placed.head_shard,
            "pool_heads": placed.key_codes.shape[1],
            "replicated_specs": all(
                sp == () for v in specs.values() if v is not None
                for sp in (v.values() if isinstance(v, dict) else [v])),
            "active_axis": None if active[0] is None else active[1],
            "equal": torch.equal(got, ref)}


def _context_parallel(mesh) -> dict:
    from repro_torch.distributed import serving as dsrv
    out = {}
    for cfg in (CODEC_CONFIGS[0], CODEC_CONFIGS[4], CODEC_CONFIGS[5]):
        cache, table = build_fragmented_cache(cfg)
        q = decode_q()
        for merge in ("psum", "allgather"):
            out[(tag(cfg), merge)] = _np(dsrv.context_parallel_decode(
                cache, q, table, mesh=mesh, merge=merge))
    return out


def _ef(mesh, rank: int, axis: str = "model") -> dict:
    """int8 error feedback over the model axis: this rank's leaves (two
    steps, the second carrying the first's error), its contribution and
    new error from :func:`ef_quantize`, and the collective's mean."""
    from repro_torch.distributed.collectives import (ef_allreduce_mean,
                                                     ef_quantize)
    rng = np.random.default_rng(100 + rank)
    g = {"w": rng.standard_normal((4, 8)).astype(np.float32),
         "b": [rng.standard_normal((8,)).astype(np.float32) * 1e-3]}
    e = {"w": np.zeros((4, 8), np.float32), "b": [np.zeros((8,), np.float32)]}
    tg = {"w": torch.from_numpy(g["w"]), "b": [torch.from_numpy(g["b"][0])]}
    te = {"w": torch.from_numpy(e["w"]), "b": [torch.from_numpy(e["b"][0])]}
    mean, err = ef_allreduce_mean(tg, te, mesh, axis=axis)
    contrib, new_err = ef_quantize(tg["w"], te["w"])
    mean2, err2 = ef_allreduce_mean(tg, err, mesh, axis=axis)
    return {"g": g, "mean": {"w": _np(mean["w"]), "b": _np(mean["b"][0])},
            "err": {"w": _np(err["w"]), "b": _np(err["b"][0])},
            "contrib_w": _np(contrib), "new_err_w": _np(new_err),
            "mean2_w": _np(mean2["w"]), "err2_w": _np(err2["w"])}


def _engine_runs(job: dict, mesh) -> dict:
    """The smoke tinyllama on ``EngineCore(mesh=)``: JAX's
    ``_engine_requests`` one-shot and chunked 64 + prefix cache, a run
    with arrivals after t = 0, and a sampled run; each rank's streams and
    its events' clocks are all-gathered and compared on every rank."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.models import get_model
    from repro_torch.serve import (
        ContinuousBatchingEngine, GenerationConfig, Request,
    )
    from repro_torch.weights import params_from_jax
    cfg = reduce_for_smoke(get_config("tinyllama-1.1b"))
    model = get_model(cfg)
    params = params_from_jax(job["params"], cfg, device="cpu")

    def reqs(name, gap=0.0):
        return [Request(rid=rid, prompt=np.asarray(p, np.int32),
                        max_new_tokens=n, arrival_time=i * gap)
                for i, (rid, p, n) in enumerate(job[name])]

    def run(name, gen=None, gap=0.0, mesh_=mesh, **kw):
        eng = ContinuousBatchingEngine(model, params, max_slots=3,
                                       max_len=128, device="cpu", mesh=mesh_,
                                       **kw)
        res = eng.run(reqs(name, gap), gen)
        streams = {r.rid: [int(t) for t in r.out_tokens]
                   for r in res["requests"]}
        events = [(e.kind, e.rid, e.token, e.t) for e in res["events"]]
        return {"streams": streams, "events": events,
                "head_shard": res["head_shard"], "graphs": res["graphs"],
                "cache_bytes": res["cache_bytes"]}

    out = {"oneshot": run("requests"),
           "prefix": run("requests_sp", prefill_chunk=64, prefix_cache=True),
           "arrivals": run("requests", gap=0.05),
           "sampled": run("requests", GenerationConfig(
               temperature=0.8, top_k=8, seed=7))}
    meshless = run("requests", GenerationConfig(
        temperature=0.8, top_k=8, seed=7), mesh_=None)
    out["sampled_meshless"] = meshless["streams"]
    out["sampled_meshless_bytes"] = meshless["cache_bytes"]
    mine = {k: (v["streams"], v["events"]) for k, v in out.items()
            if isinstance(v, dict) and "events" in v}
    every = [None] * mesh.shape["model"]
    dist.all_gather_object(every, mine)
    out["ranks_agree"] = all(x == every[0] for x in every)
    return out


def _group_timeouts(mesh) -> list:
    """The timeout, in seconds, of every group of this rank's mesh, read
    back from its gloo backend."""
    cpu = torch.device("cpu")
    return [g._get_backend(cpu).options._timeout.total_seconds()
            for g in (*mesh.groups.values(), *mesh.host_groups.values())]


def _cfg(name: str, **kw):
    import dataclasses
    from repro_torch.configs import get_config, reduce_for_smoke
    return dataclasses.replace(reduce_for_smoke(get_config(name)), **kw)


def _events(events) -> list:
    return [(e.kind, e.rid, e.slot, e.ordinal, e.token, e.span, e.span_ix)
            for e in events]


def _spec_runs(job: dict, mesh) -> dict:
    """Speculative decode under the mesh on both verifiers (span on
    ``"jnp"``, scan on ``"paged_fused"``) with each proposer of
    ``job["spec"]`` (mode -> k; the draft model's weights JAX's, carried
    across): streams, events, spec counts, decode steps; the scan
    verifier's shadow head blocks."""
    from repro_torch.models import get_model
    from repro_torch.serve import ContinuousBatchingEngine, Request
    from repro_torch.spec import SpecConfig
    from repro_torch.spec.draft import _derive_draft_cfg
    from repro_torch.weights import params_from_jax
    out = {}
    for verifier, backend in (("span", "jnp"), ("scan", "paged_fused")):
        cfg = _cfg("tinyllama-1.1b", decode_backend=backend)
        model = get_model(cfg)
        params = params_from_jax(job["params"], cfg, device="cpu")
        for mode, k in job["spec"].items():
            spec = SpecConfig(mode=mode, k=k)
            eng = ContinuousBatchingEngine(model, params, max_slots=2,
                                           max_len=128, device="cpu",
                                           mesh=mesh, spec=spec)
            if mode == "draft":
                eng.core._proposer.params = params_from_jax(
                    job["draft_params"], _derive_draft_cfg(cfg, spec),
                    device="cpu")
            res = eng.run([Request(rid=i, prompt=np.asarray(p, np.int32),
                                   max_new_tokens=32)
                           for i, p in enumerate(job["spec_prompts"])])
            sp = res["spec"]
            shadows = getattr(eng.core._graphs.verifier, "_shadows", [])
            out[(verifier, mode)] = {
                "streams": {r.rid: list(r.out_tokens)
                            for r in res["requests"]},
                "events": _events(res["events"]),
                "counts": (sp["steps"], sp["drafted_tokens"],
                           sp["accepted_tokens"]),
                "decode_steps": res["decode_steps"],
                "proposer_faults": res["proposer_faults"],
                "head_shard": res["head_shard"],
                "shadow_blocks": [c.head_shard for _, sh in shadows
                                  for c in sh]}
    return out


def _runahead_runs(job: dict, mesh) -> dict:
    """``runahead=4`` and ``0`` under the mesh on JAX's
    ``_engine_requests``: streams, events and the reported horizon."""
    from repro_torch.models import get_model
    from repro_torch.serve import ContinuousBatchingEngine, Request
    from repro_torch.weights import params_from_jax
    cfg = _cfg("tinyllama-1.1b")
    model = get_model(cfg)
    params = params_from_jax(job["params"], cfg, device="cpu")
    out = {}
    for h in (0, 4):
        eng = ContinuousBatchingEngine(model, params, max_slots=3,
                                       max_len=128, device="cpu", mesh=mesh,
                                       runahead=h)
        res = eng.run([Request(rid=rid, prompt=np.asarray(p, np.int32),
                               max_new_tokens=n)
                       for rid, p, n in job["requests"]])
        out[h] = {"streams": {r.rid: list(r.out_tokens)
                              for r in res["requests"]},
                  "events": _events(res["events"]),
                  "runahead": res.get("runahead")}
    return out


def _linear_bytes(state) -> int:
    """The per-layer linear caches' bytes, the whole length scalars
    left out."""
    from repro_torch.utils import tree_bytes
    return sum(tree_bytes(c) - c.length.numel() * c.length.element_size()
               for c in state)


def _static_runs(job: dict, mesh) -> dict:
    """``ServeEngine(mesh=)`` on every static case
    (config, decode backend, batch): tokens, the head block, and the
    rank's linear-cache bytes beside the meshless state's."""
    from repro_torch.models import get_model
    from repro_torch.serve import GenerationConfig, ServeEngine
    from repro_torch.weights import params_from_jax
    out = {}
    for key, case in job["static"].items():
        name, backend = key
        cfg = _cfg(name, decode_backend=backend)
        model = get_model(cfg)
        params = params_from_jax(job["static_params"][name], cfg,
                                 device="cpu")
        b = case["batch"]["tokens"].shape[0]
        eng = ServeEngine(model, params, case["max_len"], device="cpu",
                          mesh=mesh)
        res = eng.generate(case["batch"], GenerationConfig(
            max_new_tokens=case["new"]))
        # a () int32 length a layer, whole on every rank
        lengths = 4 * cfg.num_layers
        out[key] = {"tokens": res["tokens"], "head_shard": res["head_shard"],
                    "bytes": res["cache_bytes"] - lengths,
                    "meshless_bytes": _linear_bytes(model.init_decode_state(
                        b, case["max_len"], "cpu"))}
    return out


def run_engine_checks(job: dict, rank: int, world: int) -> dict:
    """The engines under the mesh that :func:`run_checks` leaves out: a
    job of kind ``"spec"`` runs speculation and run-ahead, one of kind
    ``"static"`` the static engine under the serving rules."""
    from repro_torch.launch.mesh import init_world, make_mesh
    torch.set_num_threads(1)
    init_world(rank, world, job["init_method"], "gloo",
               timeout_s=job["timeout_s"])
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        if job["kind"] == "static":
            return {"coords": mesh.coords, "static": _static_runs(job, mesh)}
        return {"coords": mesh.coords, "spec": _spec_runs(job, mesh),
                "runahead": _runahead_runs(job, mesh)}
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def run_checks(job: dict, rank: int, world: int) -> dict:
    from repro_torch.launch.mesh import init_world, make_mesh
    torch.set_num_threads(1)
    init_world(rank, world, job["init_method"], "gloo",
               timeout_s=job["timeout_s"])
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        return {"coords": mesh.coords,
                "timeouts": _group_timeouts(mesh),
                "kernels": _kernel_parity(mesh),
                "append": _append_parity(mesh),
                "fallback": _fallback(mesh),
                "context_parallel": _context_parallel(mesh),
                "ef": _ef(mesh, rank),
                "engine": _engine_runs(job, mesh)}
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    job_path, rank, world = Path(argv[0]), int(argv[1]), int(argv[2])
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    try:
        run = run_engine_checks if "kind" in job else run_checks
        res = run(job, rank, world)
    except Exception:
        traceback.print_exc()
        return 1
    with open(job_path.parent / f"result_{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
