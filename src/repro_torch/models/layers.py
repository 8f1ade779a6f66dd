"""Shared model building blocks (port of ``repro/models/layers.py``).

Plain functions over tensors and dict params. Matrices are stored
(d_in, d_out) as in the JAX package and applied as ``x @ w``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dense_init(d_in: int, d_out: int, generator: torch.Generator | None,
               device, dtype: torch.dtype) -> torch.Tensor:
    """A (d_in, d_out) matrix at JAX's ``dense_init`` scale, normal /
    sqrt(d_in), drawn in fp32 from ``generator`` on ``device`` and cast to
    ``dtype``."""
    x = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32)
    return (x * (1.0 / math.sqrt(d_in))).to(dtype)


def init_mlp(d: int, d_ff: int, generator: torch.Generator | None, device,
             dtype: torch.dtype) -> dict:
    """The gated MLP's ``wg``, ``wu`` (d, d_ff) and ``wd`` (d_ff, d)."""
    return {"wg": dense_init(d, d_ff, generator, device, dtype),
            "wu": dense_init(d, d_ff, generator, device, dtype),
            "wd": dense_init(d_ff, d, generator, device, dtype)}


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def per_column(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` applied to each column of a span ``x`` (S, Q, ...) at the
    one-token step's shape (S, 1, ...), contiguous, the results joined
    along axis 1. The speculative verifier runs every op whose kernel is
    chosen by the number of rows (GEMMs, row reductions) this way, so
    each span column has the decode step's bits."""
    return torch.cat([fn(x[:, i:i + 1].contiguous())
                      for i in range(x.shape[1])], dim=1)


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * w.float()).to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor, act: str = "silu") -> torch.Tensor:
    g = linear(x, wg)
    u = linear(x, wu)
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return linear(a * u, wd)


def mlp(params: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    return swiglu(x, params["wg"], params["wu"], params["wd"], act)


# ---------------------------------------------------------------------------
# RoPE ("half" pairing: dims (j, j+d/2) rotate together — the polar
# quantizer's pairing convention; see core/polar.py)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, base: float, ntk_scale: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies; ``ntk_scale > 1`` applies NTK-aware base
    scaling (paper App. C): base' = base * s^(d/(d-2))."""
    half = head_dim // 2
    if ntk_scale != 1.0:
        base = base * ntk_scale ** (head_dim / max(head_dim - 2, 1))
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    # a Python-number base: no host-to-device copy (and no sync) per call
    return torch.pow(float(base), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, base: float,
               ntk_scale: float = 1.0) -> torch.Tensor:
    """x: (B, H, T, d); positions: (T,) or (B, T) int."""
    d = x.shape[-1]
    inv = rope_frequencies(d, base, ntk_scale, device=x.device)  # (d/2,)
    ang = positions.float()[..., None] * inv                     # (..., T, d/2)
    cos = torch.cos(ang)
    sin = torch.sin(ang)
    if positions.dim() == 1:
        cos, sin = cos[None, None], sin[None, None]              # (1,1,T,d/2)
    else:
        cos, sin = cos[:, None], sin[:, None]                    # (B,1,T,d/2)
    x32 = x.float()
    x1, x2 = x32[..., : d // 2], x32[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, T, H*d) -> (B, H, T, d)."""
    b, t, hd = x.shape
    return x.reshape(b, t, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, d) -> (B, T, H*d)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def remat(fn, policy: str):
    """``fn`` recomputed in the backward instead of keeping its
    activations (``jax.checkpoint``; non-reentrant
    ``torch.utils.checkpoint``) unless ``policy`` is ``"none"`` or no
    gradient is being recorded."""
    if policy == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped
