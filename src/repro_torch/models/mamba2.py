"""Mamba-2 mixer (SSD, state-space duality, arXiv:2405.21060; port of
``repro/models/mamba2.py``).

Chunked SSD for prefill (:func:`ssd_chunked`: the quadratic block inside
each chunk, a sequential recurrence across chunks) and an O(1) recurrent
step for decode (:func:`mamba_step`). Attention-free: there is no KV cache,
so PolarQuant does not apply to this family, and no Pallas kernel covers
it — the JAX package computes the SSD scan in jnp, and plain PyTorch is
its port. Decode state = (conv window (B, W-1, conv_dim) in the model
dtype, SSD state (B, G, R, P, N) fp32).

Shapes: heads H = expand * d_model / headdim; the B/C projections have G
groups (G = 1 for mamba2-2.7b) with R = H / G heads each; P = headdim,
N = the state size.

Params: ``in_proj`` (D, 2·d_inner + 2·G·N + H) and ``out_proj``
(d_inner, D) in the model dtype; ``conv_w`` (W, conv_dim), ``conv_b``,
``A_log``, ``dt_bias``, ``D``, ``norm_w`` and ``ln`` in fp32, which JAX
computes them in.

Under a serving mesh whose ``ssm_heads`` rule splits the R heads of each
group (``ServeEngine(mesh=)``), a rank's state holds its block of R / n
heads in every group (:func:`init_state`'s ``shard``, read back by
:func:`state_shard`): the SSD state those heads, the conv window their
``xin`` channels and the whole B/C channels, which every head of a group
reads. ``in_proj`` runs whole; the mixer cuts ``xin``, ``dt``, ``A``
and the per-head params to the block, runs the conv, the scan and the D
skip on it, and gathers ``y`` over ``model`` before the ``silu(z)``
gate, whose RMSNorm spans the whole d_inner.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import serving as dsrv
from repro_torch.models import layers as L
from repro_torch.utils import torch_dtype


class SSMDims(NamedTuple):
    d_inner: int
    nheads: int
    headdim: int
    ngroups: int
    dstate: int
    conv_dim: int
    conv_w: int


def dims(cfg: ModelConfig) -> SSMDims:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return SSMDims(d_inner, nheads, cfg.ssm_headdim, cfg.ssm_ngroups,
                   cfg.ssm_state, conv_dim, cfg.ssm_conv)


def init_mamba_layer(cfg: ModelConfig, generator: torch.Generator | None,
                     device, dtype: torch.dtype) -> dict:
    """Random params at ``repro.models.mamba2.init_mamba_layer``'s scales
    (dense: normal / sqrt(d_in); conv normal * 0.2; A = -linspace(1, 16)
    over the heads, dt_bias -2, D and the norms ones)."""
    dm = dims(cfg)
    d = cfg.d_model
    in_dim = 2 * dm.d_inner + 2 * dm.ngroups * dm.dstate + dm.nheads
    conv_w = torch.randn((dm.conv_w, dm.conv_dim), generator=generator,
                         device=device, dtype=torch.float32) * 0.2
    return {
        "in_proj": L.dense_init(d, in_dim, generator, device, dtype),
        "conv_w": conv_w,
        "conv_b": torch.zeros(dm.conv_dim, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, dm.nheads,
                                          device=device)),
        "dt_bias": torch.full((dm.nheads,), -2.0, device=device),
        "D": torch.ones(dm.nheads, device=device),
        "norm_w": torch.ones(dm.d_inner, device=device),
        "out_proj": L.dense_init(dm.d_inner, d, generator, device, dtype),
        "ln": torch.ones(d, device=device),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU: u (B, T, C), w (W, C) -> (B, T, C),
    out[t] = silu(sum_k u[t - W + 1 + k] w[k] + b) — a cross-correlation
    over the left zero padding, as JAX's ``conv_general_dilated``. It
    computes in fp32 and rounds once to u's dtype, as the decode step's
    :func:`_conv_step` does, so a prefill and the steps that continue it
    round at the same points. (JAX's prefill conv computes in u's dtype
    and rounds the conv, the bias add and the SiLU apart, where its step
    rounds once; in fp32 the two are the same function, and in bf16 those
    extra roundings of every channel are a large part of what separates a
    prefill from decode steps over the same tokens.)"""
    wn, c = w.shape
    x = F.pad(u.float().transpose(1, 2), (wn - 1, 0))            # (B, C, T+)
    out = F.conv1d(x, w.float().t()[:, None, :], groups=c)
    return F.silu(out.transpose(1, 2) + b.float()).to(u.dtype)


def _conv_step(u_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor):
    """One-token conv. u_t: (B, C); conv_state: (B, W-1, C) past inputs.
    Returns (silu output (B, C) in u_t's dtype, the new window)."""
    window = torch.cat([conv_state.to(u_t.dtype), u_t[:, None]], dim=1)
    out = torch.einsum("bwc,wc->bc", window.float(), w.float()) + b
    return F.silu(out).to(u_t.dtype), window[:, 1:]


def ssd_chunked(xdt: torch.Tensor, adt: torch.Tensor, b_: torch.Tensor,
                c_: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None):
    """Chunked SSD scan, in fp32.

    xdt: (B, T, G, R, P) — inputs pre-multiplied by dt
    adt: (B, T, G, R)    — dt * A (negative)
    b_, c_: (B, T, G, N)
    Returns (y (B, T, G, R, P), final_state (B, G, R, P, N)).

    JAX contracts the diagonal block as one four-operand einsum; here it
    is C·Bᵀ per chunk, then the decay, then the product with x·dt, so no
    intermediate carries both the (L, S) block and P."""
    bsz, t, g, r, p = xdt.shape
    n = b_.shape[-1]
    t_orig = t
    if t % chunk:
        # zero-pad: adt = 0 (decay 1) and xdt = 0 make padded steps
        # identities
        pad = chunk - t % chunk
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, 0, 0, pad))
        adt = F.pad(adt, (0, 0, 0, 0, 0, pad))
        b_ = F.pad(b_, (0, 0, 0, 0, 0, pad))
        c_ = F.pad(c_, (0, 0, 0, 0, 0, pad))
        t += pad
    nc = t // chunk
    f32 = torch.float32
    xdt_c = xdt.reshape(bsz, nc, chunk, g, r, p).to(f32)
    adt_c = adt.reshape(bsz, nc, chunk, g, r).permute(0, 3, 4, 1, 2).to(f32)
    b_c = b_.reshape(bsz, nc, chunk, g, n).to(f32)
    c_c = c_.reshape(bsz, nc, chunk, g, n).to(f32)

    a_cum = torch.cumsum(adt_c, dim=-1)                      # (B,G,R,nc,L)

    # intra-chunk (the "attention-like" quadratic block, L = S = chunk);
    # mask BEFORE exp: masked entries have seg > 0 and would overflow
    li = torch.arange(chunk, device=xdt.device)
    tri = li[:, None] >= li[None, :]
    seg = a_cum[..., :, None] - a_cum[..., None, :]          # (B,G,R,nc,L,S)
    decay = torch.exp(torch.where(tri, seg, torch.full_like(seg, -1e30)))
    del seg
    cb = torch.einsum("bclgn,bcsgn->bcgls", c_c, b_c)        # (B,nc,G,L,S)
    w = cb[:, :, :, None] * decay.permute(0, 3, 1, 2, 4, 5)  # (B,nc,G,R,L,S)
    del decay
    y_diag = torch.einsum("bcgrls,bcsgrp->bclgrp", w, xdt_c)
    del w

    # per-chunk input states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)        # (B,G,R,nc,L)
    xw = xdt_c * decay_states.permute(0, 3, 4, 1, 2)[..., None]
    chunk_states = torch.einsum("bcsgn,bcsgrp->bcgrpn", b_c, xw)

    # inter-chunk recurrence (JAX's lax.scan)
    chunk_decay = torch.exp(a_cum[..., -1])                  # (B,G,R,nc)
    state = (torch.zeros((bsz, g, r, p, n), dtype=f32, device=xdt.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[..., c, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # (B,nc,G,R,P,N)

    # contribution of the carried-in state to each chunk
    state_decay = torch.exp(a_cum).permute(0, 3, 4, 1, 2)    # (B,nc,L,G,R)
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", c_c, prev_states) \
        * state_decay[..., None]
    y = (y_diag + y_off).reshape(bsz, t, g, r, p)[:, :t_orig]
    return y, state


def _split(proj: torch.Tensor, dm: SSMDims):
    """in_proj's output -> (z, xin, bc, dt)."""
    bc = 2 * dm.ngroups * dm.dstate
    return torch.split(proj, [dm.d_inner, dm.d_inner, bc, dm.nheads], dim=-1)


def state_shard(cfg: ModelConfig, state) -> dsrv.StateBlock | None:
    """The ``ssm_heads`` block a (conv, SSD) state holds
    (:func:`~repro_torch.distributed.serving.state_block`)."""
    dm = dims(cfg)
    return dsrv.state_block("ssm_heads", dm.nheads // dm.ngroups,
                            state[1].shape[2])


def _heads(x: torch.Tensor, dm: SSMDims, block: dsrv.StateBlock | None,
           per_head: int = 1) -> torch.Tensor:
    """The block's heads of ``x`` (..., H * per_head), in every group:
    head ``g * R + j`` for j in block r of n of R."""
    if block is None:
        return x
    lead = x.shape[:-1]
    r = dm.nheads // dm.ngroups
    x = block.take(x.reshape(*lead, dm.ngroups, r, per_head), -2)
    return x.reshape(*lead, -1)


def _param_block(params: dict, dm: SSMDims,
                 block: dsrv.StateBlock | None) -> dict:
    """The per-channel and per-head params the block reads: the conv over
    its ``xin`` channels and the whole B/C channels, and ``D`` of its
    heads; ``params`` itself without a block."""
    if block is None:
        return params

    def conv(x):  # (..., conv_dim): the block's xin channels + B/C
        return torch.cat([_heads(x[..., :dm.d_inner], dm, block,
                                 dm.headdim), x[..., dm.d_inner:]], -1)
    return {"conv_w": conv(params["conv_w"]),
            "conv_b": conv(params["conv_b"]),
            "D": _heads(params["D"], dm, block)}


def _dt_a(params: dict, dt: torch.Tensor, dm: SSMDims,
          block: dsrv.StateBlock | None):
    """(softplus(dt + dt_bias), -exp(A_log)) of the block's heads,
    computed over every head and cut after: the CPU's vector and scalar
    transcendentals differ in the last bit, and a head block would move
    which heads take which."""
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())
    return _heads(dt, dm, block), _heads(a, dm, block)


def _skip_gather(p: dict, y: torch.Tensor, xin: torch.Tensor, dm: SSMDims,
                 block: dsrv.StateBlock | None) -> torch.Tensor:
    """y (..., G, R', P) of the block's R' heads + their D skip, gathered
    over ``model`` into head order -> (..., d_inner) fp32."""
    y = y + xin.float().reshape(y.shape) * p["D"].float().reshape(
        dm.ngroups, -1, 1)
    if block is not None:
        y = block.gather(y, -2)
    return y.reshape(*y.shape[:-3], dm.d_inner)


def _gate_out(params: dict, y: torch.Tensor, z: torch.Tensor,
              cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """y (with its D skip) gated by silu(z), normed and projected out."""
    y = L.rms_norm((y * F.silu(z.float())).to(dtype), params["norm_w"],
                   cfg.norm_eps)
    return L.linear(y, params["out_proj"])


def _local(dm: SSMDims, block: dsrv.StateBlock | None) -> tuple[int, int]:
    """(heads a group, xin channels) that ``block`` computes."""
    r = dm.nheads // dm.ngroups // (1 if block is None else block.n)
    return r, dm.ngroups * r * dm.headdim


def mamba_mix(params: dict, u: torch.Tensor, cfg: ModelConfig,
              initial=None, want_state: bool = False,
              block: dsrv.StateBlock | None = None):
    """The SSD mixer on u (B, T, D) (the layer-normed input). ``initial``
    = (conv window, SSD state) continues from a state. ``want_state``
    also returns the state after the last token: the conv tail is the
    last W - 1 conv inputs, zero-padded on the left when fewer came —
    the causal conv's own zero padding (JAX keeps fewer rows there, and
    its next step fails). ``block``: the rank's ``ssm_heads`` block
    (:func:`state_shard`), whose heads the state holds; the output is
    whole."""
    dm = dims(cfg)
    bsz, t, _ = u.shape
    r, d_in = _local(dm, block)
    p = _param_block(params, dm, block)
    z, xin, bc, dt = _split(L.linear(u, params["in_proj"]), dm)
    xin = _heads(xin, dm, block, dm.headdim)
    dt, a = _dt_a(params, dt, dm, block)                 # (B,T,H'), (H',)
    conv_in = torch.cat([xin, bc], dim=-1)
    if initial is not None:
        conv_state0, ssd_state0 = initial
        conv_state0 = conv_state0.to(conv_in.dtype)
        padded = torch.cat([conv_state0, conv_in], dim=1)
        conv_out = _causal_conv(padded, p["conv_w"], p["conv_b"])
        conv_out = conv_out[:, dm.conv_w - 1:]
    else:
        conv_state0 = conv_in.new_zeros((bsz, dm.conv_w - 1,
                                         conv_in.shape[-1]))
        conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
        ssd_state0 = None
    gn = dm.ngroups * dm.dstate
    xin = conv_out[..., :d_in]
    b_ = conv_out[..., d_in:d_in + gn].reshape(bsz, t, dm.ngroups, dm.dstate)
    c_ = conv_out[..., d_in + gn:].reshape(bsz, t, dm.ngroups, dm.dstate)
    xh = xin.reshape(bsz, t, dm.ngroups, r, dm.headdim)
    dth = dt.reshape(bsz, t, dm.ngroups, r)
    y, state = ssd_chunked(xh.float() * dth[..., None],
                           dth * a.reshape(1, 1, dm.ngroups, r), b_, c_,
                           min(cfg.ssm_chunk, t), ssd_state0)
    out = _gate_out(params, _skip_gather(p, y, xin, dm, block), z, cfg,
                    u.dtype)
    if want_state:
        tail = torch.cat([conv_state0, conv_in], dim=1)[:, -(dm.conv_w - 1):]
        return out, (tail, state)
    return out


def mamba_step(params: dict, u_t: torch.Tensor, cfg: ModelConfig, state):
    """Single-token recurrent step. u_t: (B, D); state = (conv, ssd), or
    the rank's block of the heads (:func:`state_shard`). Returns (out
    (B, D), state)."""
    dm = dims(cfg)
    conv_state, ssd_state = state
    block = state_shard(cfg, state)
    bsz = u_t.shape[0]
    r, d_in = _local(dm, block)
    p = _param_block(params, dm, block)
    z, xin, bc, dt = _split(L.linear(u_t, params["in_proj"]), dm)
    xin = _heads(xin, dm, block, dm.headdim)
    dt, a = _dt_a(params, dt, dm, block)                 # (B,H'), (H',)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, conv_state = _conv_step(conv_in, conv_state, p["conv_w"],
                                      p["conv_b"])
    gn = dm.ngroups * dm.dstate
    xin = conv_out[..., :d_in]
    b_ = conv_out[..., d_in:d_in + gn].reshape(
        bsz, dm.ngroups, dm.dstate).float()
    c_ = conv_out[..., d_in + gn:].reshape(
        bsz, dm.ngroups, dm.dstate).float()
    xh = xin.reshape(bsz, dm.ngroups, r, dm.headdim).float()
    dth = dt.reshape(bsz, dm.ngroups, r)
    adt = dth * a.reshape(1, dm.ngroups, r)
    ssd_state = ssd_state * torch.exp(adt)[..., None, None] + torch.einsum(
        "bgrp,bgn->bgrpn", xh * dth[..., None], b_)
    y = torch.einsum("bgrpn,bgn->bgrp", ssd_state, c_)
    out = _gate_out(params, _skip_gather(p, y, xin, dm, block), z, cfg,
                    u_t.dtype)
    return out, (conv_state, ssd_state)


def init_state(cfg: ModelConfig, batch: int, device,
               shard: tuple[int, int] | None = None) -> tuple:
    """The zero state: conv window (B, W-1, conv_dim) in ``cfg.dtype``, SSD
    state (B, G, R, P, N) fp32. ``shard = (r, n)``: block r of n of each
    group's R heads — the SSD state of those heads, the conv window of
    their ``xin`` channels and every B/C channel."""
    dm = dims(cfg)
    r = dm.nheads // dm.ngroups
    if shard is not None:
        if r % shard[1] or not 0 <= shard[0] < shard[1]:
            raise ValueError(f"SSD head block {shard} of {r} heads a group")
        r //= shard[1]
    conv = dm.ngroups * r * dm.headdim + 2 * dm.ngroups * dm.dstate
    return (torch.zeros((batch, dm.conv_w - 1, conv),
                        dtype=torch_dtype(cfg.dtype), device=device),
            torch.zeros((batch, dm.ngroups, r, dm.headdim, dm.dstate),
                        dtype=torch.float32, device=device))

