"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
port of ``repro/models/rglru.py``).

Recurrence: h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t), with
a_t = exp(-c * softplus(Lambda) * r_t), c = 8, and r/i gates computed by
block-diagonal linears from the (causally convolved) input branch. The
prefill runs the recurrence as a log-depth scan over time
(:func:`linear_scan`, where JAX runs ``jax.lax.associative_scan``); decode
is an O(1) state update. State = (conv window (B, cw-1, W) in the model
dtype, h (B, W) fp32) — bounded. No Pallas kernel covers this block, so
plain PyTorch is its port.

Params: ``w_gate``, ``w_in`` (D, W) and ``w_out`` (W, D) in the model
dtype; ``conv_w`` (cw, W), ``conv_b``, ``rg_w`` / ``ig_w`` (NB, bs, bs),
``rg_b``, ``ig_b`` and ``lam`` in fp32, which every use computes in (the
prefill conv casts ``conv_w`` to the activation dtype, as JAX does).

Under a serving mesh whose ``rec_width`` rule splits the width
(``ServeEngine(mesh=)``), a rank's state holds its block of W / n
channels (:func:`init_state`'s ``shard``; the block read back by
:func:`state_shard`): the ``w_gate`` / ``w_in`` outputs are computed
whole and cut to the block, the conv, the gates (the block's NB / n
diagonal blocks) and the scan run on it, and ``y_gate * h`` is gathered
over ``model`` before ``w_out``. Every op is per channel (or per
diagonal block), so a rank's channels carry the meshless bits (on the
CPU, where W / n is a multiple of the vector width: ROADMAP §3).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import serving as dsrv
from repro_torch.models import layers as L
from repro_torch.utils import torch_dtype

_C = 8.0


def init_rglru_layer(cfg: ModelConfig, generator: torch.Generator | None,
                     device, dtype: torch.dtype) -> dict:
    """Random params at ``repro.models.rglru.init_rglru_layer``'s scales
    (dense: normal / sqrt(d_in); conv normal * 0.2; gates normal /
    sqrt(bs); Lambda so that a^c is uniform in [0.9, 0.999])."""
    d = cfg.d_model
    w = width(cfg)
    nb = num_blocks(cfg)
    bs = w // nb

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32) * scale

    u = torch.rand((w,), generator=generator, device=device)
    u = 0.9 ** 2 + (0.999 ** 2 - 0.9 ** 2) * u
    lam = torch.log(torch.exp(-torch.log(u) / (2 * _C)) - 1.0)
    zeros = torch.zeros((w,), device=device)
    return {"w_gate": L.dense_init(d, w, generator, device, dtype),
            "w_in": L.dense_init(d, w, generator, device, dtype),
            "conv_w": normal((cfg.conv1d_width, w), 0.2),
            "conv_b": zeros.clone(),
            "rg_w": normal((nb, bs, bs), 1.0 / math.sqrt(bs)),
            "rg_b": zeros.clone(),
            "ig_w": normal((nb, bs, bs), 1.0 / math.sqrt(bs)),
            "ig_b": zeros.clone(),
            "lam": lam,
            "w_out": L.dense_init(w, d, generator, device, dtype)}


def width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def num_blocks(cfg: ModelConfig) -> int:
    """The gates' diagonal blocks (NB)."""
    return max(cfg.num_heads, 1)


def splits(cfg: ModelConfig, n: int) -> bool:
    """Whether the state's W channels split into ``n`` blocks: W and the
    gates' NB diagonal blocks both divide (JAX places ``rg_w`` / ``ig_w``
    over ``model`` on their NB axis)."""
    return width(cfg) % n == 0 and num_blocks(cfg) % n == 0


def state_shard(cfg: ModelConfig, state) -> dsrv.StateBlock | None:
    """The ``rec_width`` block a (conv, h) state holds
    (:func:`~repro_torch.distributed.serving.state_block`)."""
    return dsrv.state_block("rec_width", width(cfg), state[1].shape[-1])


def _param_block(params: dict, block: dsrv.StateBlock | None) -> dict:
    """The params the rank's channels read: the conv taps, biases and
    ``lam`` of its channels and its diagonal blocks of ``rg_w`` /
    ``ig_w``; ``params`` itself without a block."""
    if block is None:
        return params
    out = {k: block.take(params[k], -1)
           for k in ("conv_w", "conv_b", "rg_b", "ig_b", "lam")}
    out.update({k: block.take(params[k], 0) for k in ("rg_w", "ig_w")})
    return out


def _block_diag(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x: (..., W) -> block-diagonal linear with w: (NB, bs, bs), in fp32."""
    nb, bs, _ = w.shape
    xb = x.reshape(*x.shape[:-1], nb, bs)
    y = torch.einsum("...nb,nbc->...nc", xb.float(), w.float())
    return y.reshape(x.shape) + b


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time in u's dtype: u (B, T, C), w
    (cw, C) -> (B, T, C), out[t] = sum_k u[t - cw + 1 + k] w[k] + b."""
    wn, c = w.shape
    x = F.pad(u.transpose(1, 2), (wn - 1, 0))                     # (B, C, T+)
    out = F.conv1d(x, w.t()[:, None, :].to(u.dtype), groups=c)
    return out.transpose(1, 2) + b.to(u.dtype)


def _gates(params: dict, u: torch.Tensor):
    r = torch.sigmoid(_block_diag(u, params["rg_w"], params["rg_b"]))
    i = torch.sigmoid(_block_diag(u, params["ig_w"], params["ig_b"]))
    lam = params["lam"].float()
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i * u.float()
    return a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1, in
    ceil(log2 T) doubling steps (Hillis–Steele over the associative
    combine (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2))."""
    t = a.shape[1]
    off = 1
    while off < t:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def _project(params: dict, x: torch.Tensor,
             block: dsrv.StateBlock | None):
    """(y_gate, u_raw): the gate branch and the conv input, computed whole
    and cut to ``block``'s channels."""
    y_gate = F.gelu(L.linear(x, params["w_gate"]), approximate="tanh")
    u_raw = L.linear(x, params["w_in"])
    if block is not None:
        y_gate, u_raw = block.take(y_gate), block.take(u_raw)
    return y_gate, u_raw


def _out(params: dict, y_gate: torch.Tensor, h: torch.Tensor,
         block: dsrv.StateBlock | None, dtype: torch.dtype) -> torch.Tensor:
    """``w_out`` over ``y_gate * h``, gathered over ``model`` first when
    the rank holds a block of the channels."""
    y = y_gate.float() * h
    if block is not None:
        y = block.gather(y)
    return L.linear(y.to(dtype), params["w_out"])


def rglru_mix(params: dict, x: torch.Tensor, cfg: ModelConfig, initial=None,
              want_state: bool = False, block: dsrv.StateBlock | None = None):
    """The Griffin recurrent mixer. x: (B, T, D) (post layer-norm).
    ``initial`` = (conv state, h) continues a sequence; ``want_state``
    also returns the state after the last token. ``block``: the rank's
    ``rec_width`` block (:func:`state_shard`), whose channels the state
    holds; the output is whole."""
    y_gate, u_raw = _project(params, x, block)
    p = _param_block(params, block)
    cw = cfg.conv1d_width
    if initial is not None:
        conv_state0, h0 = initial
        padded = torch.cat([conv_state0.to(u_raw.dtype), u_raw], 1)
        u = _causal_conv(padded, p["conv_w"], p["conv_b"])[:, cw - 1:]
    else:
        h0 = None
        u = _causal_conv(u_raw, p["conv_w"], p["conv_b"])
    a, gated = _gates(p, u)
    if h0 is not None:
        # fold the carried state in as a virtual step 0
        a = torch.cat([torch.zeros_like(a[:, :1]), a], 1)
        gated = torch.cat([h0[:, None].float(), gated], 1)
    h = linear_scan(a, gated)
    if h0 is not None:
        h = h[:, 1:]
    out = _out(params, y_gate, h, block, x.dtype)
    if want_state:
        # conv state holds raw (pre-conv) inputs
        if initial is not None:
            conv_tail = torch.cat([conv_state0.to(u_raw.dtype), u_raw],
                                  1)[:, -(cw - 1):]
        else:
            conv_tail = _tail_pad(u_raw, cw - 1)
        return out, (conv_tail, h[:, -1])
    return out


def _tail_pad(u: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` steps of u (B, T, C), zero-padded in front when
    T < n."""
    t = u.shape[1]
    if t >= n:
        return u[:, t - n:]
    return F.pad(u, (0, 0, n - t, 0))


def rglru_step(params: dict, x_t: torch.Tensor, cfg: ModelConfig, state):
    """Single-token step. x_t: (B, D); state = (conv (B, cw-1, W), h (B, W)),
    or the rank's block of W (:func:`state_shard`). The conv runs as an
    fp32 product over the window, cast back."""
    conv_state, h = state
    block = state_shard(cfg, state)
    y_gate, u_raw = _project(params, x_t, block)
    p = _param_block(params, block)
    window = torch.cat([conv_state, u_raw[:, None]], 1)
    u = torch.einsum("bwc,wc->bc", window.float(),
                     p["conv_w"].float()) + p["conv_b"]
    u = u.to(x_t.dtype)
    a, gated = _gates(p, u)
    h = a * h + gated
    out = _out(params, y_gate, h, block, x_t.dtype)
    return out, (window[:, 1:], h)


def init_state(cfg: ModelConfig, batch: int, device,
               shard: tuple[int, int] | None = None) -> tuple:
    """The zero state; ``shard = (r, n)``: block r of n of the W channels
    (its gates' NB diagonal blocks must split with them)."""
    w = width(cfg)
    if shard is not None:
        r, n = shard
        if not splits(cfg, n) or not 0 <= r < n:
            raise ValueError(f"RG-LRU block {shard} of width {w} in "
                             f"{num_blocks(cfg)} diagonal blocks")
        w //= n
    return (torch.zeros((batch, cfg.conv1d_width - 1, w),
                        dtype=torch_dtype(cfg.dtype), device=device),
            torch.zeros((batch, w), dtype=torch.float32, device=device))
