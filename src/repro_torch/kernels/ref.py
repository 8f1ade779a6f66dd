"""Plain-PyTorch oracles of the kernels (port of ``repro/kernels/ref.py``,
the entries this slice's kernels need).

Each ``ref_*`` function is the semantic ground truth its kernel is held
to on the card, and what the wrappers run for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import quantizers as qz
from repro_torch.core.quantizers import PolarKeys, QuantConfig

NEG_INF = -1e30


def _mk_polar_keys(codes, rs, rz, ts, tz, r_bits, t_bits) -> PolarKeys:
    return PolarKeys(codes=codes, rho_scale=rs, rho_zero=rz, theta_scale=ts,
                     theta_zero=tz, rho_bits=r_bits, theta_bits=t_bits,
                     pairing="half")


def ref_polar_qk_scores(q, codes, rs, rz, ts, tz, *, r_bits: int,
                        t_bits: int) -> torch.Tensor:
    """LUT q.K scores. q (B, Hkv, Qh, d); codes (B, Hkv, G, g, P); stats
    (B, Hkv, G, 1, P). Returns (B, Hkv, Qh, G*g) fp32."""
    pk = _mk_polar_keys(*(x[:, :, None] for x in (codes, rs, rz, ts, tz)),
                        r_bits, t_bits)
    return lut_mod.lut_qk_scores(q, pk)


def ref_polar_encode(k, *, r_bits: int, t_bits: int, group_size: int,
                     scale_dtype: str = "float32"):
    """Group-quantize post-RoPE keys k (B, Hkv, T, d), T % g == 0. Returns
    (codes, rho_scale, rho_zero, theta_scale, theta_zero)."""
    cfg = QuantConfig(method="polar", rho_bits=r_bits, theta_bits=t_bits,
                      group_size=group_size, scale_dtype=scale_dtype)
    pk = qz.encode_polar_keys(k, cfg)
    return pk.codes, pk.rho_scale, pk.rho_zero, pk.theta_scale, pk.theta_zero


def ref_polar_decode_attention(q, codes, rs, rz, ts, tz, values, length, *,
                               r_bits: int, t_bits: int,
                               softmax_scale: float | None = None):
    """Fused decode attention over the grouped part of the cache.

    q (B, Hkv, Qh, d); values (B, Hkv, T, d) fp; length (B,) int32 valid
    grouped tokens per sequence. Returns the unnormalized flash partials
    (out (B, Hkv, Qh, d), m (B, Hkv, Qh), l (B, Hkv, Qh))."""
    b, hkv, qh, d = q.shape
    scale = d ** -0.5 if softmax_scale is None else softmax_scale
    s = ref_polar_qk_scores(q * scale, codes, rs, rz, ts, tz,
                            r_bits=r_bits, t_bits=t_bits)
    t_cap = s.shape[-1]
    len_b = torch.as_tensor(length, dtype=torch.int32,
                            device=q.device).reshape(-1).expand(b)
    pos = torch.arange(t_cap, dtype=torch.int32, device=q.device)
    valid = pos[None, None, None, :] < len_b[:, None, None, None]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = torch.where(valid, s, neg)
    m = torch.amax(s, dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), zero)
    l = torch.sum(p, dim=-1)
    # zero dead value rows too: p is exactly 0 there, but 0 * NaN (stale
    # scratch-page garbage) would poison the product
    vmask = pos[None, :] < len_b[:, None]
    values = torch.where(vmask[:, None, :, None], values.float(), zero)
    out = torch.einsum("bhqt,bhtd->bhqd", p, values)
    return out, m, l


def ref_polar_paged_decode_attention(q, codes, rs, rz, ts, tz, values,
                                     page_table, flushed, *, r_bits: int,
                                     t_bits: int):
    """Page-native decode oracle: pool buffers + page table in, flash
    partials out. q (S, Hkv, Qh, d) ALREADY scaled; codes (PP, Hkv, g, P)
    with stats (PP, Hkv, 1, P); values (PP, Hkv, g, d) fp rows;
    page_table (S, N) int32; flushed (S,) int32."""
    table = page_table.long()

    def pages(x):  # (PP, H, a, b) -> (S, H, N, a, b)
        return x[table].transpose(1, 2)

    v = pages(values).float()
    s_, h = v.shape[:2]
    v = v.reshape(s_, h, -1, v.shape[-1])                # (S, H, N*g, d)
    return ref_polar_decode_attention(
        q, pages(codes), pages(rs), pages(rz), pages(ts), pages(tz), v,
        flushed, r_bits=r_bits, t_bits=t_bits, softmax_scale=1.0)
