"""Explicit collectives over a process mesh: softmax-stats merges and int8
error feedback (port of ``repro/distributed/collectives.py``).

JAX runs these inside ``shard_map`` over a mesh axis; here every rank
calls them with its own block and the :class:`~repro_torch.launch.mesh.
Mesh`, and they run ``torch.distributed`` collectives over the rank's
line along the named axis (outside a world the line is this rank alone
and the collectives are the identity).

* **Online-softmax stats merges** for sharded attention
  (:func:`softmax_stats`, :func:`combine_softmax_stats`,
  :func:`merge_softmax_stats`, :func:`allgather_concat`,
  :func:`finalize_softmax`). A shard that scored only part of a query's
  context holds partial ``(m, l, acc)`` carries; merging rescales by
  ``exp(m_i - max_j m_j)`` and sums. A shard with zero live positions
  carries ``m = -inf`` (or the finite ``NEG_INF`` sentinel) and
  contributes exactly zero, not ``exp(-inf - -inf) = NaN``.
* **Collectives inside autograd** for sharded training
  (:func:`copy_to`, :func:`reduce_from`, :func:`gather_from`,
  :func:`scatter_to`): identity forward / all-reduce backward, all-reduce
  forward / identity backward, all-gather forward / slice backward and
  slice forward / all-gather backward, over one axis or several.
* **int8 error-feedback mean** (:func:`ef_allreduce_mean`): each
  participant quantizes (grad + carried error) to int8 with its own fp32
  scale, the dequantized contributions are summed over the axis, and the
  quantization error is carried into the next step (EF-SGD).

Gathers are all-reduce sums of zero-filled buffers in which each rank
writes its block: exact (x + 0 = x; only the sign of a zero can change),
and supported for CUDA tensors by both gloo and NCCL — gloo has no CUDA
all-gather. NCCL's all-reduce can be captured in a CUDA graph. Gloo sums
bf16 and fp16 tensors in fp32 here (:func:`sum_over`), cast back after.
Each collective reports its kind and buffer to the dry run's counter
(``cost_hook.py``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch import cost_hook
from repro_torch.launch.mesh import entry_index


def _group(mesh, axis: str):
    """``axis``'s process group; None (collectives are the identity) only
    for an axis of one position."""
    group = mesh.group(axis)
    if group is None and mesh.shape[axis] != 1:
        raise ValueError(f"mesh axis {axis!r} of {mesh.shape[axis]} "
                         "positions has no process group")
    return group


def _all_reduce(x: torch.Tensor, mesh, axis: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``x`` over ``axis``'s line (the identity
    outside a world)."""
    group = _group(mesh, axis)
    if group is not None:
        cost_hook.collective("all-reduce", x)
        dist.all_reduce(x, op=op, group=group)
    return x


def sum_over(x: torch.Tensor, mesh, axes, inplace: bool = False
             ) -> torch.Tensor:
    """``x`` summed over every axis of ``axes`` (one name or several; an
    axis of one position adds nothing): a new tensor, or ``x`` itself,
    summed in place, with ``inplace``. Where the axis's backend is gloo,
    a bf16 or fp16 ``x`` is summed in fp32 and cast back."""
    out = x
    for axis in _names(axes):
        if mesh.shape[axis] == 1:
            continue
        group = _group(mesh, axis)
        if x.dtype in (torch.bfloat16, torch.float16) and \
                mesh.backend(axis) == "gloo":
            y = out.float()
            cost_hook.collective("all-reduce", y)
            dist.all_reduce(y, group=group)
            out = out.copy_(y) if inplace else y.to(x.dtype)
        else:
            out = out.clone() if out is x and not inplace else out
            cost_hook.collective("all-reduce", out)
            dist.all_reduce(out, group=group)
    return out


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def block_of(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, split over the positions
    of ``axes`` (one name or several, combined row-major)."""
    idx, n = entry_index(mesh, _names(axes))
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: where a value replicated
    over ``axes`` enters code each rank runs on its own block (its
    gradient is the sum of every rank's partial)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_over(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: every rank's partial summed
    into a value replicated over ``axes`` (each rank's partial takes the
    replicated value's gradient as is)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return sum_over(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather forward along ``dim`` over ``axis``, slice backward (the
    gathered value's gradient is replicated: each rank keeps its
    block)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return allgather_concat(x.contiguous(), mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (block_of(g, ctx.mesh, ctx.axis, ctx.dim).contiguous(), None,
                None, None)


class _ScatterTo(torch.autograd.Function):
    """Slice forward along ``dim`` over ``axis``, all-gather backward
    (each rank's block gradient is complete; the replicated value's is
    their concatenation)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return block_of(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (allgather_concat(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity forward, all-reduce over ``axes`` backward."""
    return _CopyTo.apply(x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """All-reduce over ``axes`` forward, identity backward."""
    return _ReduceFrom.apply(x, mesh, axes)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` over ``axis`` forward, slice backward."""
    return _GatherFrom.apply(x, mesh, axis, dim)


def scatter_to(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` forward, all-gather backward."""
    return _ScatterTo.apply(x, mesh, axis, dim)


def max_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A new tensor: the elementwise max of ``x`` over ``axis`` (no
    gradient; fp32 on gloo for bf16 and fp16)."""
    if mesh.shape[axis] == 1:
        return x
    y = x.detach().float().clone()
    cost_hook.collective("all-reduce", y)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_group(mesh, axis))
    return y.to(x.dtype)


def any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` holds on any rank of the mesh (a host all-reduce
    over every axis's gloo group; the flag itself outside a world)."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    for axis in mesh.axis_names:
        group = mesh.host_group(axis)
        if group is not None and mesh.shape[axis] > 1:
            cost_hook.collective("all-reduce", t)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t[0])


def broadcast_host_float(value: float, mesh, axis: str) -> float:
    """The value of the rank at coordinate 0 of ``axis``'s line, on every
    rank of it (a float64 on the line's gloo group; the identity outside
    a world)."""
    group = mesh.host_group(axis)
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.float64)
    cost_hook.collective("broadcast", t)
    dist.broadcast(t, src=mesh.lines[axis][0], group=group)
    return float(t[0])


# ---------------------------------------------------------------------------
# Online-softmax stats: per-shard partials + merge collectives
# ---------------------------------------------------------------------------


def softmax_stats(scores: torch.Tensor, values: torch.Tensor):
    """Partial online-softmax carries for a block of masked scores.

    scores: (..., T) with masked lanes at ``NEG_INF`` (or ``-inf``);
    values: (..., T, d) token-major value rows. Returns ``(m, l, acc)``:
    running max (...,), normalizer (...,) and unnormalized accumulator
    (..., d). A fully-masked block yields ``l == 0`` / ``acc == 0``."""
    m = torch.amax(scores, dim=-1)
    fin = torch.isfinite(m)
    safe_m = torch.where(fin, m, torch.zeros_like(m))
    p = torch.where(fin[..., None], torch.exp(scores - safe_m[..., None]),
                    torch.zeros_like(scores))
    # finite NEG_INF sentinel: every lane NEG_INF gives p == 1 everywhere;
    # zero the block so it carries no weight into a merge
    dead = m <= -1e29
    p = torch.where(dead[..., None], torch.zeros_like(p), p)
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("...t,...td->...d", p, values)
    return m, l, acc


def _coeff(mi: torch.Tensor, safe_m: torch.Tensor) -> torch.Tensor:
    live = torch.isfinite(mi) & (mi > -1e29)
    return torch.where(live, torch.exp(mi - safe_m), torch.zeros_like(mi))


def combine_softmax_stats(a, b):
    """Merge two partial ``(m, l, acc)`` carries over the same queries —
    the pairwise combiner, no collective. Degenerate operands contribute
    exactly zero."""
    m1, l1, acc1 = a
    m2, l2, acc2 = b
    m = torch.maximum(m1, m2)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    c1, c2 = _coeff(m1, safe_m), _coeff(m2, safe_m)
    l = l1 * c1 + l2 * c2
    acc = acc1 * c1[..., None] + acc2 * c2[..., None]
    return m, l, acc


def merge_softmax_stats(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                        mesh, axis: str):
    """Collective merge of per-rank ``(m, l, acc)`` partials over ``axis``:
    ``m`` all-reduced by MAX, ``l``/``acc`` rescaled by ``exp(m -
    m_max)`` and all-reduced by SUM; a rank with zero live positions
    contributes exactly zero."""
    m_max = _all_reduce(m.clone(), mesh, axis, dist.ReduceOp.MAX)
    safe_max = torch.where(torch.isfinite(m_max), m_max,
                           torch.zeros_like(m_max))
    c = _coeff(m, safe_max)
    l_tot = _all_reduce(l * c, mesh, axis)
    acc_tot = _all_reduce(acc * c[..., None], mesh, axis)
    return m_max, l_tot, acc_tot


def finalize_softmax(l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc / l`` with the all-masked case (l == 0) mapped to 0, not NaN."""
    return torch.where(l[..., None] > 0,
                       acc / torch.clamp(l, min=1e-38)[..., None],
                       torch.zeros_like(acc))


def allgather_concat(x: torch.Tensor, mesh, axes,
                     axis: int = -1) -> torch.Tensor:
    """Every rank's block of ``x`` concatenated along ``axis`` over
    ``axes`` (one mesh axis or several, combined row-major) — the rank at
    combined coordinate ``r`` fills ``[r * n, (r + 1) * n)`` of a zero
    buffer and the buffers are summed (:func:`sum_over`; exact: see the
    module doc)."""
    idx, world = entry_index(mesh, _names(axes))
    if world == 1:
        return x
    axis = axis % x.ndim
    n = x.shape[axis]
    shape = list(x.shape)
    shape[axis] = n * world
    out = x.new_zeros(shape)
    out.narrow(axis, idx * n, n).copy_(x)
    return sum_over(out, mesh, axes, inplace=True)


# ---------------------------------------------------------------------------
# int8 error feedback
# ---------------------------------------------------------------------------


def ef_quantize(g: torch.Tensor, err: torch.Tensor):
    """One participant's half of ``repro/distributed/collectives.py::
    _ef_leaf``: (its dequantized int8 contribution, its new error), both
    fp32."""
    x = g.float() + err
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    contrib = q.float() * scale
    return contrib, x - contrib


def _tree_map2(fn, a, b):
    if isinstance(a, dict):
        keys = list(a)
        outs = [_tree_map2(fn, a[k], b[k]) for k in keys]
        return ({k: o[0] for k, o in zip(keys, outs)},
                {k: o[1] for k, o in zip(keys, outs)})
    if isinstance(a, (list, tuple)):
        outs = [_tree_map2(fn, x, y) for x, y in zip(a, b, strict=True)]
        return (type(a)(o[0] for o in outs), type(a)(o[1] for o in outs))
    return fn(a, b)


def ef_allreduce_mean(grads: Any, errors: Any, mesh, axis: str = "dp"):
    """Error-feedback int8 mean over ``axis``: ``grads`` / ``errors`` are
    this rank's trees (dicts, lists or tuples of tensors). Returns
    (mean grads, this rank's new errors): the mean of every participant's
    dequantized contribution, on every rank."""
    n = mesh.shape[axis]

    def leaf(g, e):
        contrib, new_err = ef_quantize(g, e)
        return _all_reduce(contrib, mesh, axis) / n, new_err
    return _tree_map2(leaf, grads, errors)
