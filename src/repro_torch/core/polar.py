"""Polar transformation of RoPE-paired key dimensions (PolarQuant §3.2).

Port of ``repro/core/polar.py``. A post-RoPE key ``K ∈ R^d`` is viewed as
``d/2`` two-dimensional sub-vectors, the pairs one RoPE block rotates
together (``"half"``: dims ``(j, j + d/2)``; ``"adjacent"``: ``(2j, 2j+1)``).
A pair ``(x, y)`` maps to

    rho   = sqrt(x^2 + y^2)
    theta = atan2(y, x) + pi          in (0, 2*pi]

and back through ``cos/sin(theta - pi)``.
"""
from __future__ import annotations

import math

import torch

# smallest normal float32: operands below it are flushed to +0 before
# atan2, so a stray denormal (or a -0.0) cannot move the angle
_TINY = 1.1754944e-38


def split_pairs(k: torch.Tensor, pairing: str = "half"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split the last dim of ``k`` into the (x, y) components of RoPE
    pairs. Returns two tensors of shape ``(..., d/2)``."""
    d = k.shape[-1]
    if d % 2:
        raise ValueError(f"head_dim must be even, got {d}")
    if pairing == "half":
        return k[..., : d // 2], k[..., d // 2:]
    if pairing == "adjacent":
        return k[..., 0::2], k[..., 1::2]
    raise ValueError(f"unknown pairing {pairing!r}")


def merge_pairs(x: torch.Tensor, y: torch.Tensor,
                pairing: str = "half") -> torch.Tensor:
    """Inverse of :func:`split_pairs`."""
    if pairing == "half":
        return torch.cat([x, y], dim=-1)
    if pairing == "adjacent":
        return torch.stack([x, y], dim=-1).flatten(-2)
    raise ValueError(f"unknown pairing {pairing!r}")


def to_polar(k: torch.Tensor, pairing: str = "half"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cartesian -> polar in fp32. Returns (rho, theta), each (..., d/2);
    theta = atan2(y, x) + pi, pinned to pi where rho == 0."""
    x, y = split_pairs(k, pairing)
    x32 = x.float()
    y32 = y.float()
    zero = torch.zeros((), dtype=torch.float32, device=k.device)
    x32 = torch.where(x32.abs() < _TINY, zero, x32)
    y32 = torch.where(y32.abs() < _TINY, zero, y32)
    rho = torch.sqrt(x32 * x32 + y32 * y32)
    theta = torch.atan2(y32, x32) + math.pi
    # zero-radius pairs have an undefined angle — pin to the shifted zero
    theta = torch.where(rho > 0, theta, torch.full_like(theta, math.pi))
    return rho, theta


def from_polar(rho: torch.Tensor, theta: torch.Tensor, pairing: str = "half",
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """Polar -> Cartesian, inverting the ``+pi`` shift of :func:`to_polar`."""
    t = theta.float() - math.pi
    r = rho.float()
    out = merge_pairs(r * torch.cos(t), r * torch.sin(t), pairing)
    return out.to(dtype) if dtype is not None else out
