"""Reference causal GQA attention (port of ``reference_attention`` in
``repro/core/attention.py``): the plain version of the flash-prefill
kernel.

``q``: (B, H, Tq, d); ``k``, ``v``: (B, Hkv, Tk, d); H % Hkv == 0. Scores in
fp32; the output is cast back to q.dtype.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask_bias(mode: str, tq: int, tk: int, kv_len: int,
               device) -> torch.Tensor:
    """(Tq, Tk) additive bias: 0 where valid, NEG_INF elsewhere."""
    qi = torch.arange(tq, device=device)[:, None]
    ki = torch.arange(tk, device=device)[None, :]
    valid = ki < kv_len
    if mode == "causal":
        valid = valid & (qi >= ki)
    elif mode != "full":
        raise ValueError(f"unknown mask mode {mode!r}")
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mode: str = "causal",
                        scale: float | None = None) -> torch.Tensor:
    """O(T^2)-memory attention: the oracle the flash kernel is held to."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qpk = h // hkv
    scale = d ** -0.5 if scale is None else scale
    q5 = (q.float() * scale).reshape(b, hkv, qpk, tq, d)
    s = torch.einsum("bhqtd,bhcd->bhqtc", q5, k.float())
    s = s + _mask_bias(mode, tq, tk, tk, q.device)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqtc,bhcd->bhqtd", p, v.float())
    return out.reshape(b, h, tq, d).to(q.dtype)
