"""AdamW with decoupled weight decay, fp32 moments and global-norm
clipping (port of ``repro/optim/adamw.py``).

Trees are the port's params: nested dicts, with lists of per-layer dicts
where JAX stacks the layers along a leading axis. The moments have the
params' tree, in fp32. Every update is a tensor op on the params' device
(the step, bias corrections and clipping scale included), so a train
step reads nothing back to the host.

Weight decay follows JAX's rule on JAX's tree: a leaf decays when it has
at least two dimensions *as JAX stores it*, i.e. with the layer axis. So
every per-layer leaf decays — norm gains, biases and the RG-LRU and
Mamba-2 vectors included — and of the leaves outside the layer lists only
the matrices do (``final_norm`` and ``enc_norm`` do not). JAX's comment
says the rule means to skip gains and biases; on its stacked leaves it
does not (ROADMAP, "Found in the reference"). The port keeps JAX's
behaviour: see :func:`decay_mask`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor    # () int32
    m: Any                # tree like params (fp32)
    v: Any                # tree like params (fp32)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists;
    anything else is a leaf)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in JAX's order (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def decay_mask(params, stacked: bool = False):
    """A tree like ``params`` of bools: whether JAX's ``p.ndim >= 2``
    holds for the leaf on JAX's layer-stacked tree (a leaf inside a layer
    list has one more dimension there)."""
    if isinstance(params, dict):
        return {k: decay_mask(v, stacked) for k, v in params.items()}
    if isinstance(params, list):
        return [decay_mask(v, True) for v in params]
    return params.dim() + int(stacked) >= 2


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (the leaves'
    sums added in JAX's leaf order)."""
    total = None
    for x in tree_leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(params, grads, state: AdamWState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 gnorm=None):
    """Returns (new_params, new_state, {"grad_norm"}). ``lr`` a float or a
    0-dim fp32 tensor. Bias corrections are computed in float32 from the
    int32 step, as JAX's ``b1 ** t`` with ``t`` float32. ``gnorm``: the
    clipping norm when the caller computed it (a sharded step's grads are
    blocks: their norm is the whole tree's); else ``global_norm(grads)``.
    """
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)

    def upd(p, g, m, v, decays):
        g32 = g.float() * scale
        m = b1 * m + (1.0 - b1) * g32
        v = b2 * v + (1.0 - b2) * g32 * g32
        mh = m / bc1
        vh = v / bc2
        p32 = p.float()
        wd = weight_decay if decays else 0.0
        p32 = p32 - lr * (mh / (torch.sqrt(vh) + eps) + wd * p32)
        return p32.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v, decay_mask(params))
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}
