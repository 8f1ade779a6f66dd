"""Reference GQA attention with the model zoo's mask modes (port of
``_mask_bias`` and ``reference_attention`` in ``repro/core/attention.py``):
the plain version of the flash-prefill kernel.

Mask modes:

* ``causal`` — autoregressive LM
* ``full``   — no mask
* ``prefix`` — prefix-LM (PaliGemma): bidirectional over the first
  ``prefix_len[b]`` positions of row b, causal after
* ``local``  — sliding-window causal (RecurrentGemma local attention):
  query i sees keys j with ``i - window < j <= i``

``q``: (B, H, Tq, d); ``k``, ``v``: (B, Hkv, Tk, d); H % Hkv == 0. Scores in
fp32; the output is cast back to q.dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
MASK_MODES = ("full", "causal", "prefix", "local")


def _mask_bias(mode: str, window: int, tq: int, tk: int, kv_len: int,
               prefix_len: Optional[torch.Tensor], device) -> torch.Tensor:
    """Additive bias, 0 where valid and NEG_INF elsewhere: (Tq, Tk), or
    (B, Tq, Tk) in prefix mode (``prefix_len`` (B,) per row)."""
    qi = torch.arange(tq, device=device)[:, None]
    ki = torch.arange(tk, device=device)[None, :]
    valid = ki < kv_len  # padding keys
    if mode == "causal":
        valid = valid & (qi >= ki)
    elif mode == "local":
        valid = valid & (qi >= ki) & (qi - ki < window)
    elif mode == "prefix":
        if prefix_len is None:
            raise ValueError("prefix mask requires prefix_len")
        bidir = ki < prefix_len.to(device)[:, None, None]       # (B, 1, Tk)
        valid = valid & ((qi >= ki) | bidir)
    elif mode != "full":
        raise ValueError(f"unknown mask mode {mode!r}")
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mode: str = "causal", window: int = 0,
                        scale: float | None = None,
                        prefix_len: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """O(T^2)-memory attention: the oracle the flash kernel is held to."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qpk = h // hkv
    scale = d ** -0.5 if scale is None else scale
    q5 = (q.float() * scale).reshape(b, hkv, qpk, tq, d)
    s = torch.einsum("bhqtd,bhcd->bhqtc", q5, k.float())
    bias = _mask_bias(mode, window, tq, tk, tk, prefix_len, q.device)
    if bias.dim() == 3:  # (B,Tq,Tk) -> (B,1,1,Tq,Tk)
        bias = bias[:, None, None]
    p = torch.softmax(s + bias, dim=-1)
    out = torch.einsum("bhqtc,bhcd->bhqtd", p, v.float())
    return out.reshape(b, h, tq, d).to(q.dtype)
