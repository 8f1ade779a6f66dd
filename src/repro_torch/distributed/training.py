"""Where the sharded train step's computation splits (the compute half of
``make_train_step(mesh=)``; the state's placement is
``train/sharded.py``'s).

JAX's step runs the model under ``logical_rules`` and lets GSPMD place
every activation; here a :class:`TrainPlan` names what each rank
computes, and the training forward (``models/attn_block.py``'s
projections, ``models/transformer.py``'s FFN and loss, ``models/moe.py``'s
dispatch and aux loss) reads it from :func:`active_plan` while the step
runs (:func:`use_plan`). There is one forward: outside a step, or under a
plan of one position, :func:`active_plan` is :data:`MESHLESS`, whose
collectives are the identity and whose blocks are whole, and the forward
is the meshless one.

Every value of a rank's forward is either *replicated* over the
``model`` ranks (the residual stream, norms, the router, the loss) or
*partial* (a rank's head, ``d_ff``, expert or vocab block). Where a
replicated value enters a split computation it passes
:meth:`TrainPlan.copy_to_model` (its gradient is the sum of the ranks'
partials); where partial outputs rejoin the stream they pass
:meth:`TrainPlan.reduce_from_model` (summed forward, the replicated
gradient taken as is backward). So a replicated leaf's gradient is whole
and equal on every model rank, and a split leaf's block gradient is whole
for its block.

* **Data axes.** Each rank runs its rows of the global batch
  (``batch_pspecs``). The loss's masked sum and count, and the Switch
  aux loss's router-probability and assignment sums and token count, are
  summed over the data axes before they divide (all-reduce forward,
  identity backward: each rank's rows take the global loss's gradient),
  so the loss is the global batch's, not a mean of the ranks' means.
  Where the global batch does not split over the data axes every rank
  runs every row and nothing is summed.
* **Tensor parallelism over ``model``** (the dense, MoE and VLM
  families), where ``logical_rules`` maps the axis to ``model``:
  attention over a contiguous block of query heads and of KV heads
  (``wq``/``wk``/``wv`` column-parallel, ``wo`` row-parallel); where the
  KV heads do not split but the model axis is a multiple of them, every
  rank projects all KV heads and takes the one its query heads read. The
  dense FFN over ``d_ff`` (``wg``/``wu`` column-, ``wd`` row-parallel);
  MoE experts over the experts where E divides ``model`` (else each
  expert's ``d_ff``), every rank running its experts for every token;
  the shared experts over their ``d_ff``; ``lm_head`` vocab-parallel (a
  log-sum-exp over the vocab blocks). :meth:`TrainPlan.compute_dim`
  names, per parameter leaf, the axis its computation splits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Optional

import torch

from repro_torch.distributed import collectives as col
from repro_torch.launch.mesh import data_axes
from repro_torch.utils import NotPorted

MODEL = "model"


class _Active:
    """The plan of the step running in this process. Not thread-local:
    on the card autograd runs the backward on a device thread of its
    own, where a remat'd block recomputes its forward and must read the
    same plan."""
    plan: Optional["TrainPlan"] = None


_state = _Active()


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """What a rank of a (``data`` [x ``pod``], ``model``) mesh computes."""
    mesh: object
    data_axes: tuple       # the mesh's data axes (``pod``, ``data``)
    data_n: int            # their positions
    batch_split: bool      # the global batch splits over them
    model_n: int
    model_idx: int
    attn: bool = False     # query heads (and ``wo``) split over model
    kv: bool = False       # KV heads split too
    ff: bool = False       # the dense FFN's d_ff
    experts: bool = False  # MoE experts
    expert_ff: bool = False  # each MoE expert's d_ff (E does not divide)
    shared: bool = False   # the MoE shared experts' d_ff
    vocab: bool = False    # lm_head's vocab

    @property
    def data_parallel(self) -> bool:
        """Whether the loss's sums run over data ranks."""
        return self.batch_split and self.data_n > 1

    @property
    def tensor_parallel(self) -> bool:
        return self.model_n > 1 and (self.attn or self.ff or self.experts
                                     or self.expert_ff or self.shared
                                     or self.vocab)

    @property
    def active(self) -> bool:
        """Whether the forward differs from the meshless one."""
        return self.data_parallel or self.tensor_parallel

    def compute_dim(self, path: str, ndim: int) -> Optional[int]:
        """The axis (negative, on JAX's stacked leaf) of parameter ``path``
        that this plan's forward splits over ``model``, or None (the
        forward reads the whole leaf)."""
        if self.model_n == 1:
            return None
        name = path.rsplit("/", 1)[-1]
        if "/attn/" in f"/{path}":
            if name in ("wq", "bq"):
                return -1 if self.attn else None
            if name == "wo":
                return -2 if self.attn else None
            if name in ("wk", "wv", "bk", "bv"):
                return -1 if self.kv else None
            return None
        if re.search(r"ffn/shared/w[gud]$", path):
            return (-2 if name == "wd" else -1) if self.shared else None
        if re.search(r"ffn/w[gud]$", path):
            if self.experts and ndim >= 4:
                return -3
            if self.ff or (self.expert_ff and ndim >= 4):
                return -2 if name == "wd" else -1
            return None
        if name == "lm_head":
            return -1 if self.vocab else None
        return None

    # -- the forward's collectives -------------------------------------
    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks (all-reduce forward, identity
        backward); ``x`` itself where the batch does not split."""
        if not self.data_parallel:
            return x
        return col.reduce_from(x, self.mesh, self.data_axes)

    def copy_to_model(self, x: torch.Tensor, on: bool = True) -> torch.Tensor:
        """``x`` entering a computation split over ``model`` (identity
        forward, all-reduce backward); ``x`` itself where ``on`` is false
        (the computation runs replicated) or ``model`` has one
        position."""
        if not on or self.model_n == 1:
            return x
        return col.copy_to(x, self.mesh, MODEL)

    def reduce_from_model(self, x: torch.Tensor,
                          on: bool = True) -> torch.Tensor:
        """The ranks' partials of a split computation summed (all-reduce
        forward, identity backward); ``x`` itself where ``on`` is false
        or ``model`` has one position."""
        if not on or self.model_n == 1:
            return x
        return col.reduce_from(x, self.mesh, MODEL)

    def max_over_model(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over ``model`` (no gradient)."""
        if self.model_n == 1:
            return x
        return col.max_over(x, self.mesh, MODEL)

    def block(self, n: int) -> tuple[int, int]:
        """(start, size) of this rank's block of ``n`` items over model."""
        size = n // self.model_n
        return self.model_idx * size, size


def make_plan(cfg, mesh, global_batch: int) -> TrainPlan:
    """The plan of ``cfg`` on ``mesh`` for a global batch of
    ``global_batch`` rows, from ``logical_rules``."""
    from repro_torch.distributed.sharding import logical_rules
    rules = logical_rules(cfg, mesh, global_batch)
    daxes = data_axes(mesh)
    data_n = math.prod(mesh.shape[a] for a in daxes) if daxes else 1
    m = mesh.shape.get(MODEL, 1)
    base = dict(mesh=mesh, data_axes=daxes, data_n=data_n,
                batch_split=rules["batch"] is not None,
                model_n=m, model_idx=mesh.coords.get(MODEL, 0))
    if m == 1:
        return TrainPlan(**base)
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotPorted(
            f"make_train_step: tensor parallelism over 'model' is not ported "
            f"for the {cfg.family!r} family (its {cfg.name} splits only over "
            f"the data axes: use a (n, 1) mesh)")
    kv = cfg.num_kv_heads
    split = lambda logical: rules.get(logical) == MODEL  # noqa: E731
    attn = split("heads") and (kv % m == 0 or m % kv == 0)
    moe = cfg.family == "moe"
    eff = cfg.moe_d_ff or cfg.d_ff
    return TrainPlan(
        **base, attn=attn, kv=attn and split("kv_heads"),
        ff=not moe and split("ff"),
        experts=moe and split("experts"),
        expert_ff=moe and split("expert_ff"),
        shared=moe and cfg.num_shared_experts > 0
        and (eff * cfg.num_shared_experts) % m == 0,
        vocab=split("vocab") and not cfg.tie_embeddings)


#: The plan outside a sharded step: one position, every block whole.
MESHLESS = TrainPlan(mesh=None, data_axes=(), data_n=1, batch_split=False,
                     model_n=1, model_idx=0)


def current() -> Optional[TrainPlan]:
    """The plan of the step running in this process, where it changes
    the forward; else None."""
    plan = _state.plan
    return plan if plan is not None and plan.active else None


def active_plan() -> TrainPlan:
    """:func:`current`, or :data:`MESHLESS` where it is None."""
    plan = current()
    return MESHLESS if plan is None else plan


@contextlib.contextmanager
def use_plan(plan: Optional[TrainPlan]):
    prev = _state.plan
    _state.plan = plan
    try:
        yield
    finally:
        _state.plan = prev
