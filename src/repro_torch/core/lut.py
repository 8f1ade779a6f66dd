"""LUT-based query-key scores for PolarQuant decode (paper §3.3 + App. A).

Port of ``repro/core/lut.py``. For a quantized key group the dequantized
sub-vector at channel pair ``j`` is ``(rho~ cos(th~ - pi), rho~ sin(th~ - pi))``
with ``th~`` one of ``2^t`` per-(group, pair) states, so

    q . K~_n  =  sum_j  rho~_n[j] * A[j, theta_code_n[j]]
    A[j, a]   =  q_x[j] cos(th~(a)[j] - pi) + q_y[j] sin(th~(a)[j] - pi)

``A`` is a (d/2, 2^t) table built once per (query, group). The gather is a
plain ``torch.gather``: the select tree of the JAX reference exists for the
TPU's vector unit and adds only exact zeros, so both give the same sums.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import polar
from repro_torch.core.quantizers import PolarKeys


def build_angle_table(q: torch.Tensor, theta_scale: torch.Tensor,
                      theta_zero: torch.Tensor, theta_bits: int,
                      pairing: str = "half") -> torch.Tensor:
    """Per-(group, channel-pair, angle-state) partial dot products.

    q: ``(..., d)`` broadcastable against the group dims; theta stats
    ``(..., G, 1, P)``. Returns ``A`` of shape ``(..., G, P, 2**t)`` fp32."""
    qx, qy = polar.split_pairs(q.float(), pairing)               # (..., P)
    states = torch.arange(1 << theta_bits, dtype=torch.float32,
                          device=q.device)
    ts = theta_scale.float()[..., 0, :, None]                    # (..., G, P, 1)
    tz = theta_zero.float()[..., 0, :, None]
    theta_tilde = (states + 0.5) * ts + tz                       # (..., G, P, S)
    cos_t = torch.cos(theta_tilde - math.pi)
    sin_t = torch.sin(theta_tilde - math.pi)
    return qx[..., None, :, None] * cos_t + qy[..., None, :, None] * sin_t


def lut_qk_scores(q: torch.Tensor, pk: PolarKeys) -> torch.Tensor:
    """q . K~ for every cached token via the angle LUT.

    q: ``(..., d)``; pk arrays ``(..., G, g, P)``. Returns ``(..., G*g)``."""
    a_table = build_angle_table(q, pk.theta_scale, pk.theta_zero,
                                pk.theta_bits, pk.pairing)       # (..., G, P, S)
    tcodes = pk.theta_codes().long()                             # (..., G, g, P)
    lead = torch.broadcast_shapes(a_table.shape[:-3], tcodes.shape[:-3])
    gcount, g, p = tcodes.shape[-3:]
    s = a_table.shape[-1]
    a_exp = a_table[..., :, None, :, :].expand(*lead, gcount, g, p, s)
    tc = tcodes[..., None].expand(*lead, gcount, g, p, 1)
    gathered = torch.gather(a_exp, -1, tc)[..., 0]               # (..., G, g, P)
    rho = (pk.rho_codes().float() + 0.5) * pk.rho_scale.float() \
        + pk.rho_zero.float()
    scores = torch.sum(rho * gathered, dim=-1)                   # (..., G, g)
    return scores.reshape(*lead, gcount * g)
