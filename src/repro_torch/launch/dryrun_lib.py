"""Dry-run library (port of ``repro/launch/dryrun_lib.py``): one rank's
step of every (arch x shape) on the production mesh, without a card.

JAX lowers and compiles each cell for 512 placeholder CPU devices and
reads the compiled program's memory and cost analyses. The port has no
compiled program: :func:`run_cell` opens a ``torch.distributed`` world
of ``prod(mesh)`` ranks on the ``fake`` backend (every collective
completes at once and moves nothing), as rank ``rank`` (default 0),
builds the mesh, and runs the cell's step once on ``meta`` tensors (the
rank's blocks of the state at their shapes, no values) under
``launch/op_cost.OpCounter``, which counts FLOPs, bytes, transcendentals,
the collectives and the peak of the live bytes as the step runs. The
world is closed in a ``finally``; a world already up is refused.

Each cell runs the port's own per-rank program at the published widths
and the shape's full size:

* **train** — ``make_train_step(mesh=)`` (FSDP over the data axes x
  tensor parallelism over ``model``) on the rank's ``train_state_pspecs``
  blocks and its ``batch_pspecs`` rows: JAX's placement
  (``placement: "train_pspecs"``);
* **prefill / decode** — ``Model.prefill`` / ``Model.decode`` on the
  static engine's decode state under the port's serving placement
  (``ServeEngine(mesh=)``'s ``static_blocks``, DESIGN.md §17;
  ``placement: "serving"``): params whole on every rank, caches and
  attention per KV-head block over ``model`` (every head where they do
  not divide), the heads gathered before ``wo``; the hybrid's RG-LRU
  states per block of the width and the SSM's states per block of the
  SSD heads, gathered before the mixers' output projections; the rank's
  rows of the batch split over the data axes as ``batch_pspecs`` splits
  them and no collective over them (each data line is an independent
  replica). A decode cell decodes the token at position ``seq_len - 1``
  of a cache of ``seq_len`` (its host length, the one stated static
  value; that token completes its group, so the step includes the
  group's encode — JAX's lowered step holds the flush branch too); the
  encoder-decoder's cross caches hold the ``frontend_tokens`` frames.
  JAX lowers these cells under FSDP params and a cache sequence split
  over ``model`` (a GSPMD decision the port has no counterpart of): the
  record prints the argument bytes a device holds under that placement,
  from the port's resolvers, as ``jax_argument_bytes``; the record's
  ``state_blocks`` are the rank's blocks of the state.

Statuses: ``ok``; ``skip`` — JAX's :func:`should_skip` (``long_500k``
needs sub-quadratic attention); ``refused`` — a cell the port cannot
place yet, with the port's own error
(:class:`~repro_torch.utils.NotPorted`: the train cells of the hybrid,
encoder-decoder and SSM families, whose tensor parallelism over
``model`` in training is not ported). Anything else raises: the CLI
reports the cell as failed.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import ctx
from repro_torch.distributed.sharding import (
    batch_pspecs, batch_rows, decode_state_pspecs, param_pspecs,
    serving_rules,
)
from repro_torch.kernels import work as W
from repro_torch.launch.mesh import (
    entry_axes, make_mesh, make_production_mesh,
)
from repro_torch.launch.op_cost import OpCounter, _leaves, _storages
from repro_torch.models.registry import Model, get_model
from repro_torch.train.train_step import (
    StepConfig, lower_train_step, train_state_pspecs,
)
from repro_torch.utils import NotPorted

# The hardware model: one dry-run rank is one card, an NVIDIA H100 SXM5
# 80 GB at its 700 W board limit (NVIDIA's data sheet), never a TPU.
PEAK_FLOPS = W.PEAK_FLOPS["bf16"]     # dense bf16 tensor cores, FLOP/s
HBM_BW = W.HBM_BYTES_PER_S            # HBM3, bytes/s
LINK_BW = W.NVLINK_BYTES_PER_S        # NVLink 4, bytes/s each way
HBM_BYTES = 80e9                      # device memory
HARDWARE = {"card": "NVIDIA H100 SXM5 80GB, 700 W", "peak_flops": PEAK_FLOPS,
            "hbm_bytes_per_s": HBM_BW, "link_bytes_per_s": LINK_BW,
            "hbm_bytes": HBM_BYTES}

#: the production meshes (``launch/mesh.make_production_mesh``)
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class SkipCell(Exception):
    pass


class RefusedCell(Exception):
    """A cell the port cannot place yet (the port's own error text)."""


def should_skip(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: long_500k requires sub-quadratic "
                "attention (skip noted in DESIGN.md §5)")
    return None


def _fake_store():
    """The ``fake`` backend's store. It lives in an internal module of
    torch's tests, imported here and nowhere else."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # pragma: no cover - depends on the build
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} does not ship") from e
    return FakeStore()


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``torch.distributed`` world of ``world_size`` ranks on the
    ``fake`` backend, as ``rank``; destroyed on exit. A world already up
    (a real one, or a leaked fake one) is refused."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already up: the "
                           "dry run opens its own fake world")
    dist.init_process_group("fake", store=_fake_store(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_mesh(mesh):
    """The mesh of ``mesh`` ("single", "multi" or {axis: size}) in the
    world that is up."""
    if mesh in ("single", "multi"):
        return make_production_mesh(multi_pod=mesh == "multi")
    return make_mesh(tuple(mesh.values()), tuple(mesh))


# ---------------------------------------------------------------------------
# bytes a device holds under a spec
# ---------------------------------------------------------------------------


def _spec_bytes(shape: tuple, itemsize: int, spec, mesh) -> int:
    n = math.prod(shape)
    for entry in spec:
        for a in entry_axes(entry):
            n //= mesh.shape[a]
    return n * itemsize


def _tree_spec_bytes(shapes, specs, mesh) -> int:
    """Bytes a device holds of ``shapes`` (a tree with ``.shape`` /
    ``.dtype`` leaves) under the matching tree of specs."""
    if isinstance(shapes, dict):
        return sum(_tree_spec_bytes(shapes[k], specs[k], mesh)
                   for k in shapes)
    if isinstance(shapes, (list, tuple)) and not hasattr(shapes, "shape"):
        return sum(_tree_spec_bytes(a, b, mesh)
                   for a, b in zip(shapes, specs))
    return _spec_bytes(tuple(shapes.shape), shapes.dtype.itemsize, specs,
                       mesh)


def _stacked_state_shapes(state) -> list:
    """JAX's decode state leaves from the port's per-layer state (caches,
    RG-LRU or SSD states, the encoder-decoder's dict): every layer's
    leaves with a stacked axis of one. JAX stacks each run of alike
    layers; the spec never splits the stacked axis, so the per-device
    bytes are the same."""
    from repro_torch.utils import ShapeDtype
    return [ShapeDtype((1,) + tuple(t.shape), t.dtype)
            for t in _leaves(state)]


def jax_argument_bytes(model: Model, shape: ShapeConfig, mesh,
                       step_cfg: StepConfig = StepConfig()) -> int:
    """The argument bytes a device holds in JAX's lowering of the cell:
    the train state under ``train_state_pspecs`` (params in
    ``param_dtype``, fp32 moments, the step), or fp32 params under
    ``param_pspecs`` and the decode state under ``decode_state_pspecs``;
    the batch under ``batch_pspecs``. Shapes and the port's resolvers
    only."""
    from repro_torch.train.sharded import state_shapes
    cfg, gb = model.cfg, shape.global_batch
    specs = model.input_specs(shape)
    batch = sum(_spec_bytes(tuple(v.shape), v.dtype.itemsize, sp, mesh)
                for v, sp in zip(specs.values(),
                                 batch_pspecs(specs, mesh, gb).values()))
    if shape.kind == "train":
        st = state_shapes(cfg, step_cfg.param_dtype)
        return _tree_spec_bytes(st, train_state_pspecs(st, mesh, cfg),
                                mesh) + batch
    params = state_shapes(cfg, "float32").params
    pbytes = _tree_spec_bytes(params, param_pspecs(params, mesh, cfg), mesh)
    leaves = _stacked_state_shapes(model.decode_state_specs(shape))
    sbytes = sum(_spec_bytes(lf.shape, lf.dtype.itemsize, sp, mesh)
                 for lf, sp in zip(leaves, decode_state_pspecs(
                     leaves, mesh, gb)))
    if shape.kind == "decode":
        batch = _spec_bytes((gb,), 4, batch_pspecs(
            {"token": specs["token"]}, mesh, gb)["token"], mesh)
    return pbytes + sbytes + batch


def _tensor_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    return sum(_storages(tree).values())


# ---------------------------------------------------------------------------
# lowering per shape kind
# ---------------------------------------------------------------------------


def _set_decode_lengths(state, seq_len: int, frames: int) -> None:
    """A decode cell's host lengths: ``seq_len - 1`` tokens in every self
    cache (a list's caches, linear or ring, or the encoder-decoder's
    ``"self"`` list), ``frames`` in its cross caches; the RG-LRU and SSD
    states hold no length."""
    from repro_torch.core.kv_cache import KVCache
    parts = state.items() if isinstance(state, dict) else [("self", state)]
    for name, layers in parts:
        for layer in layers:
            if isinstance(layer, KVCache):
                layer.host_length = frames if name == "cross" else seq_len - 1


def _serving_step(model: Model, shape: ShapeConfig, mesh, device="meta"):
    """The prefill or decode step of ``shape`` on this rank under the
    serving placement, as :func:`lower_train_step`'s callable (on
    ``device``: meta, or zeros and fresh params elsewhere)."""
    from repro_torch.models.registry import state_block_kwargs
    from repro_torch.serve.core import static_blocks
    cfg = model.cfg
    blocks = static_blocks(cfg, mesh)
    rows = batch_rows(mesh, shape.global_batch)
    specs = model.input_specs(shape)

    def run() -> OpCounter:
        params = model.init(device=device)
        state = model.init_decode_state(rows, shape.seq_len, device,
                                        **state_block_kwargs(blocks))
        inputs = {k: torch.zeros((rows,) + tuple(v.shape[1:]),
                                 dtype=v.dtype, device=device)
                  for k, v in specs.items()}
        if shape.kind == "decode":
            _set_decode_lengths(state, shape.seq_len, cfg.frontend_tokens)
        # the state the rank holds, before a step replaces a recurrent
        # layer's entry by views of its own buffers
        state_bytes = _tensor_bytes(state)
        with ctx.use_sharding(mesh, serving_rules(cfg, mesh, rows)), \
                OpCounter() as counter:
            counter.hold(params, state, inputs)
            if shape.kind == "prefill":
                out = model.prefill(params, inputs, state)
            else:
                out = model.decode(params, state, inputs["token"])
        counter.record = counter.memory((params, state, inputs), out)
        counter.parts = {"params_bytes": _tensor_bytes(params),
                         "state_bytes": state_bytes,
                         "batch_bytes": _tensor_bytes(inputs)}
        return counter

    run.rows = rows
    run.blocks = blocks
    return run


def lower_cell(arch: str, shape_name: str, mesh,
               step_cfg: StepConfig = StepConfig()):
    """Lower one (arch x shape) on ``mesh`` (a built mesh in the world
    that is up): a callable that runs the rank's step once on meta
    tensors and returns its ``OpCounter`` (JAX's returns a ``Lowered``).
    Raises :class:`SkipCell` (JAX's rule) or :class:`RefusedCell`."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = should_skip(cfg, shape)
    if skip:
        raise SkipCell(skip)
    model = get_model(cfg)
    if shape.kind == "train":
        try:
            run = lower_train_step(model, mesh, step_cfg, shape.global_batch,
                                   model.input_specs(shape))
        except NotPorted as e:
            raise RefusedCell(str(e)) from e
        run.placement = "train_pspecs"
    else:
        run = _serving_step(model, shape, mesh)
        run.placement = "serving"
    run.model, run.shape = model, shape
    return run


def collective_census(counter: OpCounter) -> dict:
    """Per-kind counts and wire bytes (per rank) of the collectives the
    step ran, and ``total_bytes``."""
    return counter.census()


def run_cell(arch: str, shape_name: str, mesh, out_dir: str,
             mesh_tag: str, step_cfg: StepConfig = StepConfig(),
             rank: int = 0) -> dict:
    """Run one cell as rank ``rank`` of a fake world of ``prod(mesh)``
    ranks (``mesh``: "single", "multi" or {axis: size}) and dump its
    JSON record. Raises on failure; the world is gone when it returns or
    raises."""
    sizes = MESHES[mesh] if isinstance(mesh, str) else mesh
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_tag,
                           "devices": math.prod(sizes.values()),
                           "rank": rank, "hardware": HARDWARE}
    t0 = time.monotonic()
    with fake_world(rec["devices"], rank):
        m = build_mesh(mesh)
        rec["coords"] = dict(m.coords)
        try:
            run = lower_cell(arch, shape_name, m, step_cfg)
        except (SkipCell, RefusedCell) as e:
            rec["status"] = "skip" if isinstance(e, SkipCell) else "refused"
            rec["reason"] = str(e)
            _dump(rec, out_dir, mesh_tag, arch, shape_name)
            return rec
        counter = run()
        rec["placement"] = run.placement
        rec["rows"] = run.rows
        if run.placement == "serving":
            rec["state_blocks"] = run.blocks
        rec["jax_argument_bytes"] = jax_argument_bytes(
            run.model, run.shape, m, step_cfg)
    rec["lower_s"] = time.monotonic() - t0
    mem = dict(counter.record)
    mem["fits_80g_hbm"] = bool(mem["peak_per_device"] <= HBM_BYTES)
    rec["memory"] = mem
    if run.placement == "train_pspecs":
        batch = _batch_bytes(run)
        rec["state_bytes"] = mem["argument_bytes"] - batch
        rec["batch_bytes"] = batch
    else:
        rec.update(counter.parts)
    rec["cost"] = counter.cost()
    rec["dot_flops"] = counter.dot_flops
    rec["kernel_calls"] = {k: v["calls"] for k, v in
                           sorted(counter.kernels.items())}
    rec["kernel_cost"] = {k: {"flops": v["flops"], "bytes": v["bytes"]}
                          for k, v in sorted(counter.kernels.items())}
    rec["collectives"] = collective_census(counter)
    rec["aten_ops"] = counter.ops
    rec["roofline"] = roofline_terms(rec, rec["devices"])
    rec["status"] = "ok"
    _dump(rec, out_dir, mesh_tag, arch, shape_name)
    return rec


def _batch_bytes(run) -> int:
    specs = run.model.input_specs(run.shape)
    return sum(run.rows * math.prod(v.shape[1:]) * v.dtype.itemsize
               for v in specs.values())


def roofline_terms(rec: dict, n_devices: int) -> dict:
    """The three roofline terms (seconds) of a cell record: one rank's
    FLOPs at the H100's bf16 peak, its traffic-proxy bytes at its HBM
    rate, its collective wire bytes at one NVLink direction's rate.
    ``n_devices`` is taken for JAX's signature (the record is one
    rank's)."""
    flops = rec.get("cost", {}).get("flops", 0.0)
    bytes_acc = rec.get("cost", {}).get("bytes accessed", 0.0)
    coll = rec.get("collectives", {}).get("total_bytes", 0.0)
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_acc / HBM_BW,
        "collective_s": coll / LINK_BW,
    }


def _dump(rec: dict, out_dir: str, mesh_tag: str, arch: str, shape: str):
    d = os.path.join(out_dir, mesh_tag, arch)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{shape}.json"), "w") as f:
        json.dump(rec, f, indent=1)
