"""GQA attention with the model zoo's mask modes (port of
``repro/core/attention.py``): ``reference_attention``, the plain version
of the flash-prefill kernel, and ``flash_attention``, the differentiable
attention every family's training loss runs.

``flash_attention`` is a ``torch.autograd.Function`` (JAX's
``jax.custom_vjp`` ``_flash``): its forward is the flash-prefill kernel
with the log-sum-exp output on CUDA tensors, and on CPU tensors the
kernel's plain version, the chunked online-softmax forward
(``flash_forward``, JAX's ``_flash_fwd_impl``); only (q, k, v,
prefix_len, out, lse) are saved, and the backward (``flash_backward``,
JAX's ``_flash_bwd``) recomputes each K/V chunk's probabilities from
``lse`` in fp32, so no (Tq, Tk) tensor outlives a chunk.

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
               prefix_len: Optional[torch.Tensor], device,
               k0: int = 0) -> torch.Tensor:
    """Additive bias, 0 where valid and NEG_INF elsewhere, of the keys
    ``[k0, k0 + tk)``: (Tq, Tk), or (B, Tq, Tk) in prefix mode
    (``prefix_len`` (B,) per row)."""
    qi = torch.arange(tq, device=device)[:, None]
    ki = k0 + torch.arange(tk, device=device)[None, :]
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


def _chunks(k: torch.Tensor, v: torch.Tensor, chunk: int):
    """(start, K chunk, V chunk) over the keys in fp32; the last chunk is
    short where JAX pads it with masked zero keys (which add exact
    zeros)."""
    k32, v32 = k.float(), v.float()
    for j0 in range(0, k.shape[2], chunk):
        yield j0, k32[:, :, j0:j0 + chunk], v32[:, :, j0:j0 + chunk]


def _chunk_bias(mode, window, tq, j0, kj, tk, prefix_len, device):
    bias = _mask_bias(mode, window, tq, kj.shape[2], tk, prefix_len, device,
                      k0=j0)
    return bias[:, None, None] if bias.dim() == 3 else bias


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mode: str = "causal", window: int = 0,
                  scale: float | None = None, chunk: int = 512,
                  prefix_len: Optional[torch.Tensor] = None):
    """Chunked online-softmax forward (port of ``_flash_fwd_impl``):
    (out (B, H, Tq, d) in q.dtype, lse (B, H, Tq) fp32), the log-sum-exp
    of each row's scaled scores; a row whose sum is 0 takes 1 there."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qpk = h // hkv
    scale = d ** -0.5 if scale is None else scale
    chunk = min(chunk, tk)
    q5 = (q.float() * scale).reshape(b, hkv, qpk, tq, d)
    m = torch.full((b, hkv, qpk, tq), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, qpk, tq), device=q.device)
    acc = torch.zeros((b, hkv, qpk, tq, d), device=q.device)
    for j0, kj, vj in _chunks(k, v, chunk):
        s = torch.einsum("bhqtd,bhcd->bhqtc", q5, kj) + _chunk_bias(
            mode, window, tq, j0, kj, tk, prefix_len, q.device)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqtc,bhcd->bhqtd", p, vj)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe[..., None]).reshape(b, h, tq, d).to(q.dtype)
    return out, (m + torch.log(l_safe)).reshape(b, h, tq)


def flash_backward(q, k, v, prefix_len, out, lse, dout, *, mode: str,
                   window: int, scale: float, chunk: int):
    """dq, dk, dv (in q's, k's and v's dtypes) of ``flash_forward`` (port
    of ``_flash_bwd``), chunk by chunk over K/V in fp32: p = exp(s - lse),
    delta = sum(dout * out), ds = p (dp - delta) scale."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qpk = h // hkv
    q5 = q.float().reshape(b, hkv, qpk, tq, d)
    do5 = dout.float().reshape(b, hkv, qpk, tq, d)
    o5 = out.float().reshape(b, hkv, qpk, tq, d)
    lse5 = lse.reshape(b, hkv, qpk, tq)
    delta = torch.sum(do5 * o5, dim=-1)                       # (B,Hkv,Qh,Tq)
    dq5 = torch.zeros_like(q5)
    dks, dvs = [], []
    for j0, kj, vj in _chunks(k, v, chunk):
        s = torch.einsum("bhqtd,bhcd->bhqtc", q5 * scale, kj) + _chunk_bias(
            mode, window, tq, j0, kj, tk, prefix_len, q.device)
        p = torch.exp(s - lse5[..., None])                    # (B,Hkv,Qh,Tq,c)
        dvs.append(torch.einsum("bhqtc,bhqtd->bhcd", p, do5))
        dp = torch.einsum("bhqtd,bhcd->bhqtc", do5, vj)
        ds = p * (dp - delta[..., None]) * scale
        dq5 = dq5 + torch.einsum("bhqtc,bhcd->bhqtd", ds, kj)
        dks.append(torch.einsum("bhqtc,bhqtd->bhcd", ds, q5))
    return (dq5.reshape(b, h, tq, d).to(q.dtype),
            torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """JAX's ``_flash`` custom VJP: the forward through the flash-prefill
    wrapper (the kernel on CUDA tensors, its plain version on CPU
    tensors), the backward through ``flash_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, prefix_len, mode, window, scale, chunk):
        # imported here: the wrapper module imports this one
        from repro_torch.kernels import flash_prefill as fpk
        out, lse = fpk.flash_prefill(q, k, v, mode=mode, window=window,
                                     prefix_len=prefix_len, scale=scale,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, prefix_len, out, lse)
        ctx.mask = (mode, window, scale, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, prefix_len, out, lse = ctx.saved_tensors
        mode, window, scale, chunk = ctx.mask
        dq, dk, dv = flash_backward(q, k, v, prefix_len, out, lse, dout,
                                    mode=mode, window=window, scale=scale,
                                    chunk=chunk)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    mode: str = "causal", window: int = 0,
                    scale: float | None = None, chunk: int = 512,
                    prefix_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Differentiable memory-efficient attention (JAX's
    ``flash_attention``): q (B, H, Tq, d), k/v (B, Hkv, Tk, d) -> (B, H,
    Tq, d) in q.dtype, in mask ``mode``; ``chunk`` is the K/V chunk of
    the backward (and of the CPU forward's JAX port, at 512)."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    chunk = min(chunk, k.shape[2]) if k.shape[2] > 0 else chunk
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), prefix_len, mode, window,
                                 float(scale), chunk)
