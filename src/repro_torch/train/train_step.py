"""Train-step construction: gradient accumulation, remat, AdamW (port of
``repro/train/train_step.py`` without a mesh).

``make_train_step`` returns a (state, batch) -> (state, metrics) function
that runs on the params' device: the loss and its gradient by autograd
(every family's ``Model.loss``; the attention's backward is
``core.attention.flash_backward``), microbatches accumulated as JAX's
scan does, then the cosine schedule and AdamW. The params are fp32
masters unless ``param_dtype`` names another dtype; the model casts them
to ``cfg.dtype`` at every use, as JAX's layers do.

With a ``mesh`` (``launch/mesh.py``: one process a position) the step is
JAX's fully sharded one, FSDP over the data axes x tensor parallelism
over ``model`` (``train/sharded.py``): it takes and returns a
:class:`~repro_torch.train.sharded.ShardedTrainState` (each rank's
blocks of :func:`train_state_pspecs`' specs) and the rank's rows of the
global batch. ``seq_shard`` (JAX's sequence-sharded remat saves) is a
placement of activations with no effect on the math: the flag is taken
and the saves stay whole.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.distributed.ctx import P
from repro_torch.distributed.sharding import param_pspecs
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     tree_map)
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.utils import resolve_device, torch_dtype
from repro_torch.weights import init_params, params_from_jax, params_to_jax


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


class StepConfig(NamedTuple):
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1
    remat: str = "block"
    ce_chunk: int = 512        # 0 => unchunked lm-head loss
    seq_shard: bool = True     # sequence-shards remat-saved activations
                               # under a mesh (no effect without one)
    param_dtype: str = "float32"


def _cast(params, dtype: torch.dtype):
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                    params)


def init_train_state(model: Model, seed: int = 0,
                     param_dtype: str = "float32", device=None) -> TrainState:
    """Fresh params drawn from ``seed`` on ``device`` (the card unless
    named), every floating leaf in ``param_dtype``, and zero AdamW
    moments."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = torch_dtype(param_dtype)
    params = _cast(init_params(model.cfg, generator=gen, device=dev,
                               dtype=dt), dt)
    return TrainState(params=params, opt=adamw_init(params))


def train_state_to_jax(state: TrainState, cfg) -> TrainState:
    """The state in JAX's tree layout (numpy, layers stacked): what a
    checkpoint holds."""
    return TrainState(
        params=params_to_jax(state.params, cfg),
        opt=AdamWState(step=np.asarray(state.opt.step.cpu().numpy(),
                                       np.int32),
                       m=params_to_jax(state.opt.m, cfg),
                       v=params_to_jax(state.opt.v, cfg)))


def train_state_from_jax(np_state, cfg, device=None,
                         param_dtype: str = "float32") -> TrainState:
    """A state in JAX's layout (numpy leaves) -> the port's, on
    ``device``: params in ``param_dtype``, moments in fp32."""
    dev = resolve_device(device)
    dt = torch_dtype(param_dtype)

    def tree(t, dtype):
        return _cast(params_from_jax(t, cfg, device=dev, dtype=dtype), dtype)
    opt = np_state.opt
    return TrainState(
        params=tree(np_state.params, dt),
        opt=AdamWState(step=torch.as_tensor(np.asarray(opt.step),
                                            dtype=torch.int32, device=dev),
                       m=tree(opt.m, torch.float32),
                       v=tree(opt.v, torch.float32)))


def train_state_pspecs(state_shapes: TrainState, mesh, cfg) -> TrainState:
    """JAX's ``train_state_pspecs`` on a state in JAX's layout (anything
    with ``.shape`` at the leaves: ``train_state_to_jax``'s numpy, or
    ``sharded.state_shapes``): params and both moments take
    ``param_pspecs``, the step ``P()``."""
    return TrainState(
        params=param_pspecs(state_shapes.params, mesh, cfg),
        opt=AdamWState(step=P(),
                       m=param_pspecs(state_shapes.opt.m, mesh, cfg),
                       v=param_pspecs(state_shapes.opt.v, mesh, cfg)))


def loss_and_grad(model: Model, params, batch: dict, remat: str,
                  ce_chunk: int):
    """(loss, metrics, grads) of ``model.loss`` at ``params``; every leaf
    must reach the loss (autograd raises otherwise)."""
    leaves = []

    def live(p):
        leaves.append(p.detach().requires_grad_(True))
        return leaves[-1]
    loss, metrics = model.loss(tree_map(live, params), batch, remat=remat,
                               ce_chunk=ce_chunk)
    grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


def make_train_step(model: Model, mesh: Optional[Any] = None,
                    step_cfg: StepConfig = StepConfig(), *,
                    global_batch: int = 8):
    """The train step: (TrainState, batch) -> (TrainState, metrics
    {ce, aux (dense, MoE, VLM), loss, lr, grad_norm}), every metric a
    0-dim tensor on the device. The batch's arrays (numpy or tensors) are
    moved to the params' device; ``microbatches`` n splits its rows as
    JAX's ``x.reshape((n, B // n) + ...)``, microbatch 0 fixing the
    metric and gradient trees, and averages loss, metrics and grads.

    With ``mesh``: the sharded step (``train/sharded.py``) over a global
    batch of ``global_batch`` rows, each rank passing its rows
    (``SyntheticLMDataset.global_batch_arrays``); the metrics are the
    global batch's. It carries ``state_specs`` (JAX's
    ``train_state_pspecs``), ``place`` (a meshless state -> this rank's
    blocks), ``gather`` (the blocks -> the whole state in JAX's layout,
    numpy) and ``layout``. Every family trains under the data axes; the
    hybrid, encoder-decoder and SSM families are refused by name where
    ``model`` > 1."""
    sc = step_cfg
    if mesh is not None:
        from repro_torch.distributed.training import make_plan
        from repro_torch.train import sharded
        plan = make_plan(model.cfg, mesh, global_batch)
        layout = sharded.StateLayout(model, mesh, plan, sc.param_dtype)
        fn = sharded.make_sharded_step(model, mesh, sc, global_batch, layout)
        fn.state_specs = train_state_pspecs(
            sharded.state_shapes(model.cfg, sc.param_dtype), mesh, model.cfg)
        fn.layout, fn.place, fn.gather = layout, layout.place, layout.gather
        return fn

    def step(state: TrainState, batch: dict):
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        n = max(sc.microbatches, 1)
        micro = [{k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(n)]
        loss, metrics, grads = loss_and_grad(model, state.params, micro[0],
                                             sc.remat, sc.ce_chunk)
        for mb in micro[1:]:
            l_i, m_i, g_i = loss_and_grad(model, state.params, mb, sc.remat,
                                          sc.ce_chunk)
            loss = loss + l_i
            metrics = {k: v + m_i[k] for k, v in metrics.items()}
            grads = tree_map(torch.add, grads, g_i)
        if n > 1:
            inv = 1.0 / n
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
            grads = tree_map(lambda g: g * inv, grads)
        with torch.no_grad():
            lr = cosine_schedule(state.opt.step, sc.peak_lr,
                                 sc.warmup_steps, sc.total_steps)
            params, opt, om = adamw_update(
                state.params, grads, state.opt, lr,
                weight_decay=sc.weight_decay, clip_norm=sc.clip_norm)
        return TrainState(params, opt), dict(metrics, loss=loss, lr=lr, **om)

    return step


def lower_train_step(model: Model, mesh, step_cfg: StepConfig,
                     global_batch: int, batch_specs: dict,
                     device="meta"):
    """The dry run's step (JAX's returns a ``Lowered``): a callable that
    runs ``make_train_step(mesh=)`` once on this rank's blocks of the
    state (``StateLayout``'s ``block_shape``s; meshless with ``mesh``
    None) and its rows of ``batch_specs`` (``{name: ShapeDtype}`` of the
    global batch, split over the data axes as ``batch_pspecs`` splits
    them), all on ``device`` — ``meta``: shapes, no values; another
    device, zeros (the fresh params drawn, meshless) to check that a
    count does not depend on the device — under a fresh
    ``launch/op_cost.OpCounter``, and returns the counter with its memory
    record of the step (``counter.record``). Every collective runs on
    the world's backend (the dry run's ``fake``)."""
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.train import sharded
    sc = step_cfg
    step = make_train_step(model, mesh, sc, global_batch=global_batch)
    if mesh is None:
        rows = global_batch

        def state_fn():
            dt = torch_dtype(sc.param_dtype)
            params = _cast(init_params(model.cfg, device=device, dtype=dt),
                           dt)
            return TrainState(params=params, opt=adamw_init(params))
    else:
        from repro_torch.distributed.sharding import batch_rows
        layout = step.layout
        rows = batch_rows(mesh, global_batch)

        def blocks(dtype=None):
            return layout.tree([
                torch.zeros(leaf.block_shape, dtype=dtype or leaf.dtype,
                            device=device) for leaf in layout.leaves])

        def state_fn():
            return sharded.ShardedTrainState(
                params=blocks(), opt=AdamWState(
                    step=torch.zeros((), dtype=torch.int32, device=device),
                    m=blocks(torch.float32), v=blocks(torch.float32)))

    def run() -> OpCounter:
        state = state_fn()
        batch = {k: torch.zeros((rows,) + tuple(v.shape[1:]),
                                dtype=v.dtype, device=device)
                 for k, v in batch_specs.items()}
        with OpCounter() as counter:
            counter.hold(state, batch)
            out = step(state, batch)
        counter.record = counter.memory((state, batch), out)
        return counter

    run.step = step
    run.rows = rows
    return run
