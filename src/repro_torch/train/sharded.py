"""The sharded train state and step: FSDP over the data axes x tensor
parallelism over ``model`` on a ``torch.distributed`` process mesh (the
port of ``repro/train/train_step.py``'s ``make_train_step(mesh=)``).

**Placement is JAX's.** :class:`StateLayout` lists the train state's
leaves as JAX stores them (``weights.jax_layout``: the layers stacked
along a leading axis L, the hybrid's split into its periods and tail),
each with ``param_pspec``'s spec on that stacked shape, so every offset is
JAX's. Each rank holds exactly its block of every parameter and of both
AdamW moments (:class:`ShardedTrainState`, a tree in JAX's layout whose
leaves are the blocks): a spec that splits a width axis splits that axis
of every layer, one that splits the layer axis L (FSDP picks it where it
is the largest divisible axis left, e.g. ``bq`` (L, q_dim) once TP took
its last axis) gives the rank a contiguous block of whole layers. The
step's forward reads the port's per-layer tree: views of the gathered
stacked tensors (``tensor[i]`` for layer i). The step count is
replicated (``P()``).

**The math is the meshless step's.** A step, on each rank:

1. gathers every leaf over the data axes (FSDP: the rank's ``model``
   block of the whole leaf, the gradients' leaf), then, inside
   autograd, to the tensor its forward reads
   (:meth:`~repro_torch.distributed.training.TrainPlan.compute_dim`): a
   leaf split over ``model`` whose computation is not is gathered over
   ``model`` (``collectives.gather_from``: the gradient sliced back), a
   leaf the computation splits but the placement does not is sliced
   (``scatter_to``: the gradients gathered back);
2. runs forward and backward (``model.loss`` under the plan of
   ``distributed/training.py``) on the rank's rows of the global batch,
   microbatch by microbatch, and averages: microbatch i holds JAX's
   rows, the global rows ``[i * B/n, (i + 1) * B/n)``, of which the rank
   runs its data block (:func:`microbatches`);
3. sums each gradient over the data ranks (where the batch splits over
   them) and keeps the rank's data block (a reduce-scatter);
4. computes the clipping norm: each per-layer leaf's sum of squares
   from the rank that writes its block (coordinate 0 on every axis that
   replicates it), summed over the mesh once, the leaves added in the
   meshless step's order; then runs AdamW on the blocks (JAX's decay rule
   is ``ndim >= 2`` on the stacked leaf, which a block keeps).

On a mesh of one position every collective is the identity and the
step is the meshless one bit for bit.

Collectives are all-reduces (the only gather both gloo and NCCL take for
CUDA tensors): a gather is a sum of zero-filled buffers, each rank's
block at its offset, so the FSDP gather and the gradient reduce-scatter
each move a whole ``model`` block of every leaf (fp32) through an
all-reduce, where a reduce-scatter / all-gather pair would move 1/D of
it each way. Gathering layer by layer (peak memory) is not done: a step
holds the whole gathered model block of every leaf, and its gradients.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointing import Block
from repro_torch.distributed import collectives as col
from repro_torch.distributed import training as dtrain
from repro_torch.distributed.ctx import PartitionSpec
from repro_torch.distributed.sharding import param_pspec
from repro_torch.launch.mesh import data_axes, entry_axes, entry_index
from repro_torch.optim.adamw import AdamWState, adamw_update, tree_map
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.utils import ShapeDtype, torch_dtype
from repro_torch.weights import _to_numpy, init_params, jax_layout


class ShardedTrainState(NamedTuple):
    """A rank's train state: ``params`` and the AdamW moments as trees in
    JAX's layout whose leaves are the rank's blocks; ``opt.step``
    replicated. Its fields are ``TrainState``'s, so its checkpoint keys
    are JAX's."""
    params: Any
    opt: AdamWState


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter leaf of JAX's tree and this rank's block of it."""
    key: str            # the leaf's path in the params tree, '::'-joined
    shape: tuple        # JAX's shape (layers stacked)
    dtype: torch.dtype  # the port's
    refs: tuple         # the port's paths of its tensors: one per layer
    stacked: bool       # (stacked) or the leaf's one tensor
    spec: PartitionSpec
    block: tuple        # this rank's slices of ``shape``
    write: bool         # this rank writes its block (replica 0)
    data_dim: Optional[int]    # the axis split over the data axes
    data_axes: tuple           # ... and those axes
    model_dim: Optional[int]   # the axis the placement splits over model
    compute_dim: Optional[int]  # the axis the forward splits over model

    @property
    def block_shape(self) -> tuple:
        return tuple(s.stop - s.start for s in self.block)

    @property
    def layers(self) -> range:
        """The layers (stacked index) of the rank's block."""
        if not self.stacked:
            return range(0)
        return range(self.block[0].start, self.block[0].stop)


def state_shapes(cfg, param_dtype: str = "float32"):
    """The train state's shapes in JAX's layout, no values drawn
    (``jax.eval_shape(init_train_state)``'s tree): params in
    ``param_dtype`` — the norms and routers too, as ``init_train_state``
    casts every floating leaf —, moments fp32, the step int32."""
    from repro_torch.train.train_step import TrainState
    dt = torch_dtype(param_dtype)
    meta = init_params(cfg, device="meta", dtype=dt)

    def tree(dtype):
        return jax_layout(
            meta, cfg, leaf=lambda t: ShapeDtype(tuple(t.shape), dtype),
            stack=lambda ts: ShapeDtype((len(ts),) + tuple(ts[0].shape),
                                        dtype))
    return TrainState(params=tree(dt), opt=AdamWState(
        step=ShapeDtype((), torch.int32), m=tree(torch.float32),
        v=tree(torch.float32)))


class _Stacked(tuple):
    """The port's paths of one stacked leaf (``jax_layout``'s stack)."""


def _paths(tree, path: tuple = ()):
    """(path, leaf) of every leaf of a port tree, in ``tree_leaves``'
    order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _paths(x, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, fn, path: tuple = ()):
    """A port tree of ``tree``'s structure with ``fn(path)`` at each
    leaf."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(x, fn, path + (i,)) for i, x in enumerate(tree)]
    return fn(path)


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _jax_items(tree, path: tuple = ()):
    """(path, leaf) of a tree in JAX's layout (nested dicts), sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jax_items(tree[k], path + (k,))
    else:
        yield path, tree


def _unflatten_jax(keys: list, values: list) -> dict:
    """Nested dicts from '::'-joined keys."""
    out: dict = {}
    for key, v in zip(keys, values):
        node = out
        *head, last = key.split("::")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


class StateLayout:
    """The train state's leaves in JAX's layout on ``mesh``, with this
    rank's block of each (module doc). ``param_dtype`` is the params'
    dtype (the moments are fp32)."""

    def __init__(self, model, mesh, plan: dtrain.TrainPlan,
                 param_dtype: str = "float32"):
        cfg = model.cfg
        self.cfg, self.mesh, self.plan = cfg, mesh, plan
        dt = torch_dtype(param_dtype)
        meta = init_params(cfg, device="meta", dtype=dt)
        self.skeleton = tree_map(
            lambda p: p.to(dt) if p.is_floating_point() else p, meta)
        refs = _rebuild(self.skeleton, lambda p: p)
        jtree = jax_layout(refs, cfg, leaf=lambda r: r,
                           stack=lambda rs: _Stacked(rs))
        daxes = data_axes(mesh)
        self.leaves: list[Leaf] = []
        for path, node in _jax_items(jtree):
            stacked = isinstance(node, _Stacked)
            first = _get(self.skeleton, node[0] if stacked else node)
            shape = ((len(node),) if stacked else ()) + tuple(first.shape)
            ppath = "/".join(path)
            spec = param_pspec(ppath, shape, mesh, cfg)
            block, covered = [], set()
            data_dim = model_dim = None
            d_axes: tuple = ()
            for i, (dim, entry) in enumerate(zip(shape, spec)):
                axes = entry_axes(entry)
                covered.update(axes)
                idx, n = entry_index(mesh, axes)
                size = dim // n
                block.append(slice(idx * size, (idx + 1) * size))
                if axes and all(a in daxes for a in axes):
                    data_dim, d_axes = i, axes
                if "model" in axes and mesh.shape["model"] > 1:
                    model_dim = i
            write = all(mesh.coords[a] == 0 for a in mesh.axis_names
                        if a not in covered)
            cdim = plan.compute_dim(ppath, len(shape))
            self.leaves.append(Leaf(
                key="::".join(path), shape=shape,
                dtype=first.dtype,
                refs=tuple(node) if stacked else (node,), stacked=stacked,
                spec=spec, block=tuple(block), write=write,
                data_dim=data_dim, data_axes=d_axes, model_dim=model_dim,
                compute_dim=None if cdim is None else cdim % len(shape)))
        where = {}
        for li, leaf in enumerate(self.leaves):
            for layer, ref in enumerate(leaf.refs):
                where[ref] = (li, layer if leaf.stacked else None)
        #: (leaf index, layer or None) of each port leaf in the meshless
        #: step's order (``tree_leaves`` of the port's params)
        self.port_order = [where[p] for p, _ in _paths(self.skeleton)]

    # -- trees -------------------------------------------------------------
    def tree(self, values: list) -> dict:
        """A tree in JAX's layout of one value per leaf."""
        return _unflatten_jax([leaf.key for leaf in self.leaves], values)

    def values(self, tree: dict) -> list:
        """One value per leaf of a tree in JAX's layout."""
        return [_get(tree, leaf.key.split("::")) for leaf in self.leaves]

    def shapes(self) -> dict:
        return self.tree([ShapeDtype(leaf.shape, leaf.dtype)
                          for leaf in self.leaves])

    def whole(self, tree) -> list:
        """Each leaf of a port tree as JAX stores it (layers stacked)."""
        out = []
        for leaf in self.leaves:
            xs = [_get(tree, r) for r in leaf.refs]
            out.append(torch.stack(xs) if leaf.stacked else xs[0])
        return out

    def port_tree(self, values: list):
        """The port's per-layer tree from one stacked value per leaf (layer
        i of a stacked leaf is ``value[i]``, a view)."""
        split = [list(v.unbind(0)) if leaf.stacked else [v]
                 for leaf, v in zip(self.leaves, values)]
        where = {ref: (li, i) for li, leaf in enumerate(self.leaves)
                 for i, ref in enumerate(leaf.refs)}
        return _rebuild(self.skeleton,
                        lambda p: split[where[p][0]][where[p][1]])

    def state_bytes(self) -> int:
        """The bytes a rank's params and moments hold: the sum of its spec
        blocks (the step count aside)."""
        n = 0
        for leaf in self.leaves:
            numel = math.prod(leaf.block_shape)
            n += numel * (leaf.dtype.itemsize + 8)
        return n

    # -- placement -----------------------------------------------------------
    def place(self, state) -> ShardedTrainState:
        """A meshless ``TrainState`` (the port's tree, the same on every
        rank) -> this rank's blocks, on the state's device."""
        def blocks(tree):
            return self.tree([w[leaf.block].clone() for leaf, w in
                              zip(self.leaves, self.whole(tree))])
        return ShardedTrainState(
            params=blocks(state.params),
            opt=AdamWState(step=state.opt.step.clone(), m=blocks(state.opt.m),
                           v=blocks(state.opt.v)))

    def from_numpy(self, np_state, device) -> ShardedTrainState:
        """A state of numpy blocks (in JAX's layout, as ``restore_checkpoint``
        with :meth:`regions` returns) on ``device``; params in the layout's
        dtype, moments fp32."""
        def tree(t, dtype):
            return self.tree([
                torch.from_numpy(np.array(a)).to(
                    device, leaf.dtype if dtype is None else dtype)
                for leaf, a in zip(self.leaves, self.values(t))])
        opt = np_state.opt
        return ShardedTrainState(
            params=tree(np_state.params, None),
            opt=AdamWState(step=torch.as_tensor(np.asarray(opt.step),
                                                dtype=torch.int32,
                                                device=device),
                           m=tree(opt.m, torch.float32),
                           v=tree(opt.v, torch.float32)))

    def regions(self):
        """The rank's block of every leaf of the state, as a tree like
        the checkpoint's target (``restore_checkpoint(blocks=)``)."""
        blocks = self.tree([leaf.block for leaf in self.leaves])
        return ShardedTrainState(params=blocks, opt=AdamWState(
            step=(), m=blocks, v=blocks))

    def target(self):
        """The checkpoint's target tree (shapes only), JAX's layout."""
        shapes = self.shapes()
        return ShardedTrainState(params=shapes, opt=AdamWState(
            step=ShapeDtype((), torch.int32), m=shapes, v=shapes))

    def checkpoint_tree(self, state: ShardedTrainState):
        """``state`` as :class:`Block`s for ``save_checkpoint``: each at its
        offsets in JAX's stacked coordinates, written by the rank that
        holds its replica 0; the step by rank 0 alone (as a whole)."""
        def blocks(tree):
            return self.tree([
                Block(x, tuple(s.start for s in leaf.block), leaf.shape,
                      leaf.write)
                for leaf, x in zip(self.leaves, self.values(tree))])
        step_write = all(c == 0 for c in self.mesh.coords.values())
        return ShardedTrainState(
            params=blocks(state.params),
            opt=AdamWState(step=Block(state.opt.step, (), (), step_write),
                           m=blocks(state.opt.m), v=blocks(state.opt.v)))

    def gather_tree(self, tree: dict) -> dict:
        """A tree of this rank's blocks (params, a moment or gradients) ->
        the whole tree in JAX's layout as numpy, on every rank: each block
        written once into a zero array and summed over the mesh."""
        out = []
        for leaf, x in zip(self.leaves, self.values(tree)):
            full = x.new_zeros(leaf.shape)
            if leaf.write:
                full[leaf.block] = x
            full = col.sum_over(full, self.mesh, self.mesh.axis_names)
            out.append(_to_numpy(full))
        return self.tree(out)

    def gather(self, state: ShardedTrainState):
        """The whole state in JAX's layout as numpy on every rank (a
        ``TrainState`` of ``train_state_to_jax``'s form)."""
        from repro_torch.train.train_step import TrainState
        return TrainState(
            params=self.gather_tree(state.params),
            opt=AdamWState(step=np.asarray(state.opt.step.cpu().numpy(),
                                           np.int32),
                           m=self.gather_tree(state.opt.m),
                           v=self.gather_tree(state.opt.v)))

    # -- the step's data movement ------------------------------------------
    def compute_param(self, w: torch.Tensor, leaf: Leaf) -> torch.Tensor:
        """A leaf's ``model`` block (:meth:`gather_data`) -> the tensor
        its forward reads, inside autograd: gathered over ``model`` where
        the placement splits it and the forward does not (the gradient
        sliced back), sliced where the forward splits it and the placement
        does not (the gradients gathered back)."""
        pm, cm = leaf.model_dim, leaf.compute_dim
        if pm != cm and pm is not None:
            w = col.gather_from(w, self.mesh, "model", pm)
        if pm != cm and cm is not None:
            w = col.scatter_to(w, self.mesh, "model", cm)
        return w

    def gather_data(self, x: torch.Tensor, leaf: Leaf) -> torch.Tensor:
        """The rank's block gathered over the leaf's data axes (FSDP): its
        block of the leaf's ``model`` split, whole elsewhere."""
        if leaf.data_dim is None:
            return x
        return col.allgather_concat(x, self.mesh, leaf.data_axes,
                                    leaf.data_dim)

    def scatter_data(self, g: torch.Tensor, leaf: Leaf) -> torch.Tensor:
        """The gradient of :meth:`gather_data`'s tensor -> that of the
        rank's block: summed over the data ranks (where the batch splits
        over them), the rank's data block kept (a reduce-scatter)."""
        if self.plan.data_parallel:
            g = col.sum_over(g.contiguous(), self.mesh, self.plan.data_axes)
        if leaf.data_dim is not None:
            g = col.block_of(g, self.mesh, leaf.data_axes, leaf.data_dim)
        return g.contiguous()

    def global_norm(self, grads: list) -> torch.Tensor:
        """sqrt of the sum of every leaf's squares over the whole tree:
        each per-layer leaf's sum from the rank that writes it, summed
        over the mesh, added in the meshless step's leaf order (so a
        mesh of one gives ``adamw.global_norm``'s bits)."""
        parts = []
        zero = None
        for li, layer in self.port_order:
            leaf, g = self.leaves[li], grads[li]
            if layer is None:
                x = g
            elif layer in leaf.layers:
                x = g[layer - leaf.layers.start]
            else:
                x = None
            if x is not None and leaf.write:
                parts.append(torch.sum(torch.square(x.float())))
            else:
                if zero is None:
                    zero = torch.zeros((), device=g.device)
                parts.append(zero)
        vec = col.sum_over(torch.stack(parts), self.mesh,
                           self.mesh.axis_names)
        total = vec[0]
        for i in range(1, len(parts)):
            total = total + vec[i]
        return torch.sqrt(total)


def loss_and_grad_blocks(layout: StateLayout, model, leaves: list,
                         compute: list, batch: dict, remat: str,
                         ce_chunk: int, retain: bool):
    """(loss, metrics, the gradient of each of ``leaves``, the gathered
    ``model`` blocks) of ``model.loss`` on the per-layer tree of
    ``compute`` (their tensors as the forward reads them), forward and
    backward under the layout's plan (a remat'd block recomputes under
    it); ``retain`` keeps the graph from ``leaves`` to ``compute`` for
    the next microbatch."""
    with dtrain.use_plan(layout.plan):
        loss, metrics = model.loss(layout.port_tree(compute), batch,
                                   remat=remat, ce_chunk=ce_chunk)
        grads = torch.autograd.grad(loss, leaves, retain_graph=retain)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))


def microbatches(batch: dict, n: int, mesh,
                 plan: dtrain.TrainPlan) -> list:
    """The rank's rows of each of JAX's ``n`` microbatches of the global
    batch (``x.reshape((n, B // n) + ...)``: microbatch i holds the global
    rows ``[i * B/n, (i + 1) * B/n)``) from its rows ``batch``. Where
    ``n`` > 1 and the batch splits over the data axes, the rank's rows
    are gathered over them first (the token ids, a few KiB) and it takes
    its data block of each microbatch: a slice of its own rows would put
    other rows together, and the Switch aux loss's means and the token
    count of a batch with ignored labels depend on which rows share a
    microbatch."""
    if n > 1 and plan.data_parallel:
        batch = {k: col.allgather_concat(v, mesh, plan.data_axes, 0)
                 for k, v in batch.items()}
    out = [{k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
            for k, v in batch.items()} for i in range(n)]
    if n > 1 and plan.data_parallel:
        out = [{k: col.block_of(v, mesh, plan.data_axes, 0)
                for k, v in mb.items()} for mb in out]
    return out


def make_sharded_step(model, mesh, step_cfg, global_batch: int,
                      layout: StateLayout):
    """The step over ``layout``: (ShardedTrainState, the rank's rows of
    the batch) -> (ShardedTrainState, metrics), as the module doc
    describes. Its ``grads`` attribute returns (loss, metrics, the
    gradient blocks in JAX's layout) without updating."""
    sc, plan = step_cfg, layout.plan
    rows = global_batch // plan.data_n if plan.batch_split else global_batch
    n = max(sc.microbatches, 1)
    if n > 1 and plan.data_parallel and (global_batch // n) % plan.data_n:
        raise ValueError(
            f"microbatches {n}: a microbatch of {global_batch // n} rows "
            f"does not split over the {plan.data_n} data positions of mesh "
            f"{dict(mesh.shape)}")

    def grads_of(state: ShardedTrainState, batch: dict):
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        for k, v in batch.items():
            if v.shape[0] != rows:
                raise ValueError(
                    f"batch[{k!r}] holds {v.shape[0]} rows; a rank of mesh "
                    f"{dict(mesh.shape)} takes {rows} of the global "
                    f"{global_batch} (batch_pspecs)")
        leaves = [layout.gather_data(x, leaf).detach().requires_grad_(True)
                  for leaf, x in zip(layout.leaves,
                                     layout.values(state.params))]
        compute = [layout.compute_param(w, leaf)
                   for leaf, w in zip(layout.leaves, leaves)]
        n = max(sc.microbatches, 1)
        micro = microbatches(batch, n, mesh, plan)
        loss, metrics, grads = loss_and_grad_blocks(
            layout, model, leaves, compute, micro[0], sc.remat, sc.ce_chunk,
            retain=n > 1)
        for i, mb in enumerate(micro[1:], start=2):
            l_i, m_i, g_i = loss_and_grad_blocks(
                layout, model, leaves, compute, mb, sc.remat, sc.ce_chunk,
                retain=i < n)
            loss = loss + l_i
            metrics = {k: v + m_i[k] for k, v in metrics.items()}
            grads = [torch.add(a, b) for a, b in zip(grads, g_i)]
        if n > 1:
            inv = 1.0 / n
            loss = loss * inv
            metrics = {k: v * inv for k, v in metrics.items()}
            grads = [g * inv for g in grads]
        del compute, leaves
        with torch.no_grad():
            grads = [layout.scatter_data(g, leaf)
                     for leaf, g in zip(layout.leaves, grads)]
        return loss, metrics, grads

    def step(state: ShardedTrainState, batch: dict):
        loss, metrics, grads = grads_of(state, batch)
        with torch.no_grad():
            gnorm = layout.global_norm(grads)
            lr = cosine_schedule(state.opt.step, sc.peak_lr,
                                 sc.warmup_steps, sc.total_steps)
            params, opt, om = adamw_update(
                state.params, layout.tree(grads), state.opt, lr,
                weight_decay=sc.weight_decay, clip_norm=sc.clip_norm,
                gnorm=gnorm)
        return ShardedTrainState(params, opt), dict(metrics, loss=loss,
                                                    lr=lr, **om)

    def grads(state: ShardedTrainState, batch: dict):
        loss, metrics, g = grads_of(state, batch)
        return loss, metrics, layout.tree(g)

    step.grads = grads
    return step
