"""Shared model building blocks (port of ``repro/models/layers.py``).

Plain functions over tensors and dict params. Matrices are stored
(d_in, d_out) as in the JAX package and applied as ``x @ w``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(x: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


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
