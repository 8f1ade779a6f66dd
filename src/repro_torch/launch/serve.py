"""Serving launcher: batched generation over the PolarQuant cache (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --batch 4 --prompt-len 64 --gen 32 \\
        --quant polar --rho-bits 4 --theta-bits 4 --value-bits 0

It takes every flag of the JAX launcher, with its names, defaults and
summary lines (``--engine static|cb``, ``--prefill-chunk``,
``--prefix-cache``, ``--stream``, ``--spec-mode`` / ``--spec-k``, the QoS
and chaos flags, ``--runahead``, ``--int8-layers``, the codec flags,
``--mesh-shape``), plus ``--device``: it runs on the CUDA card unless
``--device`` names another device (``--device cpu`` runs the plain
PyTorch versions of the kernels); with no card and no device named it
raises. ``--decode-backend`` takes ``jnp``, ``gathered`` and
``paged_fused``, ``--prefill-backend`` ``jnp`` and ``paged_fused``; JAX's
``ref``, ``interpret`` and ``pallas`` name TPU execution modes and are
refused by name (in the port the tensors' device picks kernel or plain
version).

The params are the port's own seeded init (``Model.init`` with a
``torch.Generator`` seeded by ``--seed``); the requests, the shared
prefix and the frontend features are drawn from
``np.random.default_rng(--seed)`` exactly as JAX's launcher draws them,
so both launchers serve the same requests. :func:`build` makes the
config, model and params and :func:`serve` runs one arm on them, so a
caller can hand :func:`serve` other params (for example JAX's, crossed
with ``repro_torch.weights.params_from_jax``).

``--mesh-shape DxM`` runs one process per mesh position, launched by
``python -m torch.distributed.run``::

    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \\
        -m repro_torch.launch.serve --arch tinyllama-1.1b --smoke \\
        --engine cb --mesh-shape 1x2

Each rank reads ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` from the launcher, joins the world through
``launch/mesh.py``'s ``init_world`` and serves with its block of the KV
heads (DESIGN.md §17). The backend is NCCL when every rank of the node
has a card of its own, gloo otherwise (several ranks on one card, or the
CPU), and is printed; only rank 0 prints. A mesh of one position
(``1x1``) needs no launcher. A data axis > 1 is refused by the engines
(ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs, reduce_for_smoke
from repro_torch.models import get_model
from repro_torch.serve import (
    ContinuousBatchingEngine, GenerationConfig, Request, ServeEngine,
)
from repro_torch.utils import resolve_device

#: JAX's execution modes of one kernel (TPU, Pallas interpreter, jnp
#: oracle); the port takes only the backends that name a computation
TPU_MODES = ("ref", "interpret", "pallas")
#: the environment ``python -m torch.distributed.run`` gives each rank
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def parse_args(argv=None) -> argparse.Namespace:
    """JAX's flags, names and defaults, plus ``--device``, parsed from
    ``argv``; JAX's TPU execution modes and a malformed ``--mesh-shape``
    are refused. Resolved once here: ``world`` (the launcher's view of
    this process, or None), ``rank_device`` and ``backend`` (the world's
    process-group backend)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Batched generation over the PolarQuant cache.")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=list_configs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--quant", default="polar",
                    choices=["polar", "kivi", "int", "zipcache", "none"])
    ap.add_argument("--rho-bits", type=int, default=4)
    ap.add_argument("--theta-bits", type=int, default=4)
    ap.add_argument("--value-bits", type=int, default=0)
    ap.add_argument("--group-size", type=int, default=0,
                    help="0 = keep config default")
    ap.add_argument("--int8-layers", type=int, default=0,
                    help="mixed policy: run the first N layers at int8 "
                         "(KVTuner-style) and the rest at --quant")
    ap.add_argument("--decode-backend", default="jnp",
                    choices=["jnp", "gathered", "paged_fused", *TPU_MODES],
                    help="decode-attention backend (paged_fused = "
                         "page-native fused kernel on the paged path); "
                         "ref, interpret and pallas are TPU execution "
                         "modes of the JAX package and are refused")
    ap.add_argument("--prefill-backend", default="jnp",
                    choices=["jnp", "paged_fused", *TPU_MODES],
                    help="chunked-prefill attention backend (cb engine "
                         "with --prefill-chunk; paged_fused = page-native "
                         "fused kernel over the quantized prefix pages); "
                         "ref, interpret and pallas are refused")
    ap.add_argument("--engine", default="static", choices=["static", "cb"],
                    help="static = one-shot batched ServeEngine; cb = "
                         "continuous batching over the paged cache")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="cb engine: chunked-prefill size in tokens "
                         "(0 = one-shot prefill; rounded up to the page "
                         "size)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cb engine: shared-prefix page reuse (implies "
                         "chunked prefill)")
    ap.add_argument("--stream", action="store_true",
                    help="cb engine: serve through the streaming API, "
                         "printing tokens as they arrive and per-token "
                         "TTFT/ITL percentiles")
    ap.add_argument("--spec-mode", default="off",
                    choices=["off", "ngram", "draft"],
                    help="cb engine: speculative multi-token decode — "
                         "ngram self-speculation or a smaller draft model "
                         "(greedy outputs stay bit-identical to off)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per speculative step")
    ap.add_argument("--shared-prefix-len", type=int, default=64,
                    help="cb engine: common system-prompt length prepended "
                         "to every request (demo workload for "
                         "--prefix-cache)")
    ap.add_argument("--tenant-budget", type=float, default=0.0,
                    help="cb engine: per-tenant token-bucket budget in "
                         "tokens/s of engine time (0 = unlimited); enables "
                         "QoS weighted-fair admission")
    ap.add_argument("--ttft-slo", type=float, default=0.0,
                    help="cb engine: session TTFT deadline in seconds — "
                         "requests whose deadline is blown or unmeetable "
                         "are shed with an explicit event (0 = off)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="cb engine: bounded admission queue — intake over "
                         "this depth rejects with an explicit event "
                         "(0 = unbounded)")
    ap.add_argument("--runahead", type=int, default=0,
                    help="cb engine: run-ahead fused decode horizon H — "
                         "batch H decode micro-steps with on-device "
                         "sampling into one dispatch in decode-bound "
                         "stretches (0/1 = off; greedy outputs stay "
                         "bit-identical; unused under a mesh)")
    ap.add_argument("--chaos", default="",
                    help="cb engine: deterministic fault injection spec, "
                         "e.g. 'exhaust@8,slow@5:0.05,cancel@12:0.5,"
                         "proposer@0.3' (see repro_torch.serve.chaos)")
    ap.add_argument("--mesh-shape", default="",
                    help="serve over a process mesh, e.g. '1x2' = (data=1, "
                         "model=2): KV caches and attention heads split "
                         "over the model axis where divisible (DESIGN.md "
                         "§17); one process per position, launched by "
                         "python -m torch.distributed.run")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: the CUDA card; "
                         "under a launcher with a card a rank, the rank's "
                         "card)")
    args = ap.parse_args(argv)
    for flag in ("decode_backend", "prefill_backend"):
        b = getattr(args, flag)
        if b in TPU_MODES:
            ap.error(f"--{flag.replace('_', '-')} {b!r} is a TPU execution "
                     "mode of the JAX package; the port takes "
                     + ("jnp, gathered or paged_fused"
                        if flag == "decode_backend" else "jnp or paged_fused")
                     + " (the tensors' device picks kernel or plain "
                     "version)")
    args.mesh = _mesh_shape(args.mesh_shape) if args.mesh_shape else None
    args.world = _world(args)
    args.rank_device, args.backend = _device(args, args.world)
    return args


def _mesh_shape(text: str) -> tuple[int, int]:
    try:
        shape = tuple(int(x) for x in text.split("x"))
    except ValueError:
        raise SystemExit(f"bad --mesh-shape {text!r}; "
                         "expected e.g. '1x2' (data x model)")
    if len(shape) != 2:
        raise SystemExit("--mesh-shape takes two axes: data x model")
    return shape


def _world(args) -> dict | None:
    """The launcher's view of this process (rank, world size, local rank)
    for a mesh of more than one position, None for none or one. A mesh
    of several positions without the launcher's variables exits with how
    to launch it."""
    if args.mesh is None:
        return None
    n = args.mesh[0] * args.mesh[1]
    if n == 1 and "WORLD_SIZE" not in os.environ:
        return None
    missing = [v for v in LAUNCHER_VARS if v not in os.environ]
    if missing:
        raise SystemExit(
            f"--mesh-shape {args.mesh_shape} runs one process per mesh "
            f"position ({n}), and {', '.join(missing)} are not set; launch "
            f"it with: python -m torch.distributed.run --nproc_per_node {n} "
            f"-m repro_torch.launch.serve --mesh-shape {args.mesh_shape} ...")
    world = int(os.environ["WORLD_SIZE"])
    if world != n:
        raise SystemExit(f"--mesh-shape {args.mesh_shape} holds {n} "
                         f"positions but the launcher started {world} "
                         "processes")
    return {"rank": int(os.environ["RANK"]), "size": world,
            "local": int(os.environ.get("LOCAL_RANK", os.environ["RANK"])),
            "local_size": int(os.environ.get("LOCAL_WORLD_SIZE", world))}


def _device(args, world: dict | None) -> tuple[torch.device, str]:
    """(this rank's device, the world's backend): the named device, or the
    card — each rank its own when the node has a card for every local
    rank (NCCL), else the first for all (gloo)."""
    if args.device is not None or world is None:
        return resolve_device(args.device), "gloo"
    dev = resolve_device(None)
    if torch.cuda.device_count() >= world["local_size"]:
        return torch.device("cuda", world["local"]), "nccl"
    return dev, "gloo"


def build(args) -> tuple:
    """(cfg, model, params) of ``args``: the config with the codec flags
    and backends applied, and the port's seeded init on the serving
    device."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    qkw = dict(method=args.quant, rho_bits=args.rho_bits,
               theta_bits=args.theta_bits, value_bits=args.value_bits)
    if args.group_size:
        qkw["group_size"] = args.group_size
    quant = dataclasses.replace(cfg.quant, **qkw)
    policy = None
    if args.int8_layers > 0:
        from repro_torch.core import CachePolicy
        policy = CachePolicy.first_k(
            args.int8_layers,
            dataclasses.replace(quant, method="int", key_bits=8),
            quant)
    cfg = dataclasses.replace(cfg, quant=quant, cache_policy=policy,
                              decode_backend=args.decode_backend,
                              prefill_backend=args.prefill_backend)
    model = get_model(cfg)
    gen = torch.Generator(device=args.rank_device)
    gen.manual_seed(args.seed)
    params = model.init(generator=gen, device=args.rank_device)
    return cfg, model, params


def _join_mesh(args) -> tuple:
    """(mesh, the world's backend, whether this call started the world):
    (None, None, False) without ``--mesh-shape``; a world of one position
    needs no launcher."""
    if args.mesh is None:
        return None, None, False
    from repro_torch.launch.mesh import init_world, make_mesh
    world = args.world
    if world is None:
        return make_mesh(args.mesh, ("data", "model")), None, False
    if args.backend == "nccl":
        torch.cuda.set_device(world["local"])
    init_world(world["rank"], world["size"], "env://", args.backend,
               timeout_s=120)
    try:
        return make_mesh(args.mesh, ("data", "model")), args.backend, True
    except BaseException:
        import torch.distributed as dist
        dist.destroy_process_group()
        raise


def serve(args, cfg, model, params) -> int:
    """Serve one arm of ``args`` on ``params`` (on their device) and print
    JAX's summary lines, the first sequence last. Under a mesh only rank 0
    prints."""
    import torch.distributed as dist
    device = params["embed"].device
    mesh, backend, started = _join_mesh(args)
    try:
        rank0 = not started or dist.get_rank() == 0

        def say(*a, **kw):
            if rank0:
                print(*a, **kw)
        if mesh is not None:
            data, model_n = args.mesh
            say(f"[serve] mesh data={data} model={model_n} over "
                f"{data * model_n} processes (backend "
                f"{backend or 'none: one position'}; kv_heads="
                f"{cfg.num_kv_heads}: "
                f"{'head-sharded' if cfg.num_kv_heads % model_n == 0 else 'replicated fallback'})")
        return _serve(args, cfg, model, params, device, mesh, say)
    finally:
        if started:
            dist.destroy_process_group()


def _serve(args, cfg, model, params, device, mesh, say) -> int:
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (args.batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (args.batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(
                np.float32)

    say(f"[serve] {cfg.name} quant={args.quant} bits/key-elem="
        f"{cfg.policy.avg_key_bits(cfg.num_layers, cfg.head_dim):.2f}")
    gen = GenerationConfig(max_new_tokens=args.gen,
                           temperature=args.temperature, seed=args.seed)
    if args.engine == "cb":
        return _serve_cb(args, cfg, model, params, device, mesh, say, rng,
                         batch, gen)
    eng = ServeEngine(model, params, max_len=args.max_len, device=device,
                      mesh=mesh)
    out = eng.generate(batch, gen)
    say(f"[serve] prefill {out['prefill_s'] * 1e3:.1f}ms  "
        f"decode {out['tokens_per_s']:.1f} tok/s  "
        f"cache {out['cache_bytes'] / 2**20:.2f} MiB")
    say(f"[serve] first sequence: {out['tokens'][0].tolist()}")
    return 0


def _serve_cb(args, cfg, model, params, device, mesh, say, rng, batch,
              gen) -> int:
    shared = rng.integers(0, cfg.vocab_size,
                          (args.shared_prefix_len,)).astype(np.int32)
    # the first request arrives alone so its prefill registers the shared
    # prefix's pages before the rest admit (the engine clock is compute
    # time: the idle gap is jumped, not slept)
    reqs = [Request(rid=i,
                    prompt=np.concatenate([shared, batch["tokens"][i]]),
                    max_new_tokens=args.gen,
                    arrival_time=0.0 if i == 0 else 100.0 + 0.01 * i)
            for i in range(args.batch)]
    spec = None
    if args.spec_mode != "off":
        from repro_torch.spec import SpecConfig
        spec = SpecConfig(mode=args.spec_mode, k=args.spec_k)
    qos = None
    if args.tenant_budget > 0 or args.ttft_slo > 0 or args.max_pending > 0:
        from repro_torch.serve import QosConfig
        qos = QosConfig(tenant_budget=args.tenant_budget,
                        ttft_slo=args.ttft_slo, max_pending=args.max_pending)
        say(f"[serve] qos: budget={args.tenant_budget} tok/s  "
            f"ttft-slo={args.ttft_slo}s  max-pending={args.max_pending}")
    chaos = None
    if args.chaos:
        from repro_torch.serve import ChaosConfig, ChaosInjector
        chaos = ChaosInjector(ChaosConfig.parse(args.chaos, seed=args.seed))
        say(f"[serve] chaos: {chaos.cfg}")
    eng = ContinuousBatchingEngine(
        model, params, max_slots=args.batch, max_len=args.max_len,
        device=device, mesh=mesh, prefix_cache=args.prefix_cache,
        prefill_chunk=args.prefill_chunk, spec=spec, qos=qos, chaos=chaos,
        runahead=args.runahead)
    eng.warmup([r.prompt_len for r in reqs] + [args.max_len], gen)
    if args.stream:
        return _serve_stream(eng, reqs, gen, say)
    out = eng.run(reqs, gen)
    say(f"[serve] cb decode {out['tokens_per_s']:.1f} tok/s  "
        f"p50 {out['p50_latency_s'] * 1e3:.1f}ms  "
        f"cache {out['cache_bytes'] / 2**20:.2f} MiB  "
        f"prefill-chunk {out['prefill_chunk']}")
    if "qos" in out:
        say(f"[serve] qos: {out['n_shed']} shed  "
            f"{out['n_rejected']} rejected  "
            f"prefill-rate-est {out['qos']['prefill_rate_est']}")
    if "chaos" in out:
        say(f"[serve] chaos: {out['chaos']}")
    if "spec" in out:
        sp = out["spec"]
        say(f"[serve] spec mode={sp['mode']} k={sp['k']}  "
            f"acceptance {sp['acceptance_rate'] * 100:.1f}%  "
            f"mean accepted/step {sp['mean_accepted_per_step']:.2f}")
    if "runahead" in out:
        ra = out["runahead"]
        say(f"[serve] runahead h={ra['h']}  "
            f"{ra['horizons']} horizons  "
            f"{ra['tokens']} horizon tokens  "
            f"dispatch-gap ewma {ra['dispatch_gap_ewma_s'] * 1e3:.2f}ms")
    if args.prefix_cache:
        say(f"[serve] prefix hit rate "
            f"{out['prefix_hit_rate'] * 100:.1f}%  "
            f"({out['prefill_tokens_skipped']} prompt tokens "
            f"skipped, {out['adopted_pages']} pages adopted, "
            f"{out['prefix_pool_bytes_saved'] / 2**20:.2f} MiB "
            "pool bytes shared)")
    first = out["requests"][0].out_tokens
    say(f"[serve] first sequence: {first}")
    return 0


def _serve_stream(eng, reqs, gen, say) -> int:
    from repro_torch.serve import StreamingEngine, stream_latency_stats
    stream = StreamingEngine(eng, gen)
    for r in reqs:
        stream.submit(r)
    texts: dict[int, list] = {r.rid: [] for r in reqs}
    events = []
    for ev in stream.events():
        events.append(ev)
        if ev.kind in ("first_token", "token"):
            texts[ev.rid].append(ev.token)
            say(f"[stream] t={ev.t * 1e3:8.1f}ms rid={ev.rid} "
                f"slot={ev.slot} +{ev.token}")
        elif ev.kind == "preempt":
            # the victim's last streamed token is retracted and re-sampled
            # when it resumes
            if texts[ev.rid]:
                texts[ev.rid].pop()
            say(f"[stream] t={ev.t * 1e3:8.1f}ms rid={ev.rid} "
                f"preempt (-{ev.token})")
        else:
            say(f"[stream] t={ev.t * 1e3:8.1f}ms rid={ev.rid} {ev.kind}")
    out = stream.result()
    lat = stream_latency_stats(events, reqs)
    say(f"[serve] streamed {out['total_tokens']} tokens  "
        f"{out['tokens_per_s']:.1f} tok/s  "
        f"ttft p50 {lat['ttft_s']['p50'] * 1e3:.1f}ms "
        f"p99 {lat['ttft_s']['p99'] * 1e3:.1f}ms  "
        f"itl p50 {lat['itl_s']['p50'] * 1e3:.1f}ms "
        f"p99 {lat['itl_s']['p99'] * 1e3:.1f}ms")
    if "spec" in out:
        sp = out["spec"]
        say(f"[serve] spec mode={sp['mode']} k={sp['k']}  "
            f"acceptance {sp['acceptance_rate'] * 100:.1f}%  "
            f"({sp['accepted_tokens']}/{sp['drafted_tokens']} drafts)")
        say(f"[serve] spec mean accepted/step "
            f"{sp['mean_accepted_per_step']:.2f} over "
            f"{sp['steps']} speculative steps")
    say(f"[serve] first sequence: {texts[reqs[0].rid]}")
    return 0


def main(argv=None) -> int:
    """Parse ``argv``, :func:`build` and :func:`serve`."""
    args = parse_args(argv)
    cfg, model, params = build(args)
    return serve(args, cfg, model, params)


if __name__ == "__main__":
    raise SystemExit(main())
