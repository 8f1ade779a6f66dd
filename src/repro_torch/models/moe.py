"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch
(port of ``repro/models/moe.py``).

Per batch row (token group) of ``t`` tokens: the router picks each
token's top-k experts; each assignment takes a position in its expert,
counted slot-major (slot 0 of every token first, then slot 1, ...);
assignments past the expert's capacity ``C`` are dropped. The kept
tokens are added into an expert-major buffer of ``E * B * C`` rows plus
one drop row (``index_add_``), every expert runs its SwiGLU over its
``B * C`` rows as one batched GEMM, and the rows are gathered back and
combined with the gates. Shared experts run densely on every token.

Every shape is fixed by (B, T) and the config, and nothing reads a value
back to the host, so the decode step that runs this captures as a CUDA
graph. As in JAX, padding tokens (past a prompt's real length in a
prefill bucket or chunk) are routed and take capacity, and every expert
runs over its whole capacity buffer whether or not a token landed there.

The Switch load-balance loss comes with the training form,
:func:`moe_ffn_train` (y, aux), and alone from :func:`load_balance_loss`;
the serving path's :func:`moe_ffn` never computes it (JAX's jit drops it
there).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import training as dtrain
from repro_torch.models import layers as L


def init_moe(cfg: ModelConfig, generator: torch.Generator | None, device,
             dtype: torch.dtype) -> dict:
    """Router (D, E) in fp32 at normal * 0.02 (the router always computes
    in fp32); expert matrices (E, d_in, d_out) and the shared expert's
    at normal / sqrt(d_in), in ``dtype`` — the scales of
    ``repro.models.moe.init_moe``."""
    d, e = cfg.d_model, cfg.num_experts
    ff = cfg.moe_d_ff or cfg.d_ff

    def normal(shape, scale, dt):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    p = {"router": normal((d, e), 0.02, torch.float32),
         "wg": normal((e, d, ff), 1.0 / math.sqrt(d), dtype),
         "wu": normal((e, d, ff), 1.0 / math.sqrt(d), dtype),
         "wd": normal((e, ff, d), 1.0 / math.sqrt(ff), dtype)}
    if cfg.num_shared_experts:
        fs = ff * cfg.num_shared_experts
        p["shared"] = {"wg": normal((d, fs), 1.0 / math.sqrt(d), dtype),
                       "wu": normal((d, fs), 1.0 / math.sqrt(d), dtype),
                       "wd": normal((fs, d), 1.0 / math.sqrt(fs), dtype)}
    return p


def capacity(t: int, cfg: ModelConfig) -> int:
    """Per-expert capacity of a ``t``-token group: T*k/E * capacity_factor
    (at least 1), rounded up to a multiple of 8, as JAX computes it."""
    cap = max(int(t * cfg.top_k / cfg.num_experts * cfg.capacity_factor), 1)
    return -(-cap // 8) * 8


def route(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Router probabilities (B, T, E) fp32 and each token's top-k
    (gates (B, T, k) fp32, expert indices (B, T, k) int64). The logits
    are computed in fp32; ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = srt.values[..., :cfg.top_k]
    eidx = srt.indices[..., :cfg.top_k]
    if cfg.norm_topk:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return probs, gates, eidx


def dispatch(eidx: torch.Tensor, cap: int, num_experts: int):
    """Slot-major positions of the (B, T, k) assignments ``eidx`` in their
    experts: returns ``keep`` (B, k, T) bool (position < ``cap``) and
    ``dst`` (B, k, T), each kept assignment's row in the expert-major
    buffer (expert, batch row, position) and ``E * B * cap`` — the drop
    row — for the others."""
    b, t, k = eidx.shape
    eflat = eidx.transpose(1, 2).reshape(b, k * t)            # slot-major
    onehot = (eflat[..., None] == torch.arange(
        num_experts, device=eidx.device)).to(torch.int32)     # (B, kT, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.sum(pos * onehot, dim=-1)                     # (B, kT)
    keep = pos < cap
    rows = eflat * (b * cap) + torch.arange(
        b, device=eidx.device)[:, None] * cap + pos
    dst = torch.where(keep, rows, num_experts * b * cap)
    return keep.reshape(b, k, t), dst.reshape(b, k, t)


def _experts(params: dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """Each expert's SwiGLU over its rows: buf (E, N, D) -> (E, N, D),
    one batched GEMM per matrix."""
    dt = buf.dtype
    h = torch.bmm(buf, params["wg"].to(dt))
    u = torch.bmm(buf, params["wu"].to(dt))
    h = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    return torch.bmm(h * u, params["wd"].to(dt))


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D), capacity per batch row over its T
    tokens (every token routed, padding included)."""
    return _moe_ffn(params, x, cfg)[0]


def moe_ffn_train(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The training form (JAX's ``moe_ffn``): (y, the Switch
    load-balance loss of this routing, fp32)."""
    y, probs, eidx = _moe_ffn(params, x, cfg)
    return y, _switch_aux(probs, eidx, cfg)


def _moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """(y, router probs, expert indices). Under a sharded train step's
    plan that splits the experts over ``model`` (or, where E does not
    divide it, each expert's ``d_ff``; ``params`` then the rank's
    blocks): the routing, capacities and drops are every rank's (the
    router is replicated), each rank runs its experts' capacity buffers
    for every token, and the ranks' outputs are summed; the shared
    experts split over their ``d_ff`` where the plan says so."""
    plan = dtrain.active_plan()
    split = plan.experts or plan.expert_ff
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(t, cfg)
    probs, gates, eidx = route(params, x, cfg)
    keep, dst = dispatch(eidx, cap, e)

    rows = e * b * cap
    xin = plan.copy_to_model(x, split)
    xk = xin[:, None].expand(b, k, t, d).reshape(b * k * t, d)
    buf = x.new_zeros((rows + 1, d))
    buf.index_add_(0, dst.reshape(-1), xk)                    # drop row last
    buf = buf[:rows].view(e, b * cap, d)
    if plan.experts:
        # the rank's experts; the others' rows stay zero
        e0, ne = plan.block(e)
        out = F.pad(_experts(params, buf[e0:e0 + ne], cfg.act),
                    (0, 0, 0, 0, e0, e - e0 - ne))
    else:
        out = _experts(params, buf, cfg.act)
    out = torch.cat([out.reshape(rows, d), out.new_zeros((1, d))])
    back = out.index_select(0, dst.reshape(-1)).view(b, k, t, d)
    # gates masked by keep and cast to the model dtype before the combine,
    # one contraction over the k slots (one rounding, as JAX's einsum)
    gk = plan.copy_to_model((gates.transpose(1, 2) * keep).to(x.dtype),
                            split)                            # (B, k, T)
    y = torch.einsum("bktd,bkt->btd", back, gk)
    shared = cfg.num_shared_experts > 0
    if shared and plan.shared == split:
        y = y + L.mlp(params["shared"], xin, cfg.act)
    y = plan.reduce_from_model(y, split)
    if shared and plan.shared != split:
        y = y + plan.reduce_from_model(L.mlp(
            params["shared"], plan.copy_to_model(x, plan.shared), cfg.act),
            plan.shared)
    return y, probs, eidx


def load_balance_loss(params: dict, x: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """Switch load-balance loss of ``x``'s routing (JAX's ``aux``)."""
    probs, _, eidx = route(params, x, cfg)
    return _switch_aux(probs, eidx, cfg)


def _switch_aux(probs: torch.Tensor, eidx: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """E * sum(mean router prob * mean assignment share) *
    router_aux_loss, in fp32; the gradient flows through the probs. Under
    a sharded train step's plan the means are the global batch's: the
    probabilities', assignments' and tokens' sums over the data ranks
    before they divide (``distributed/training.py``)."""
    e = cfg.num_experts
    hits = (eidx[..., None] == torch.arange(e, device=eidx.device)).float() \
        .sum(dim=2)
    plan = dtrain.active_plan()
    if not plan.data_parallel:
        me, ce = probs.mean(dim=(0, 1)), hits.mean(dim=(0, 1))
    else:
        n = plan.data_sum(torch.full(
            (), float(probs.shape[0] * probs.shape[1]), device=probs.device))
        me = plan.data_sum(probs.sum(dim=(0, 1))) / n
        ce = plan.data_sum(hits.sum(dim=(0, 1))) / n
    return e * torch.sum(me * ce) * cfg.router_aux_loss
