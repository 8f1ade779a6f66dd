"""Plain-PyTorch oracles of the kernels (port of ``repro/kernels/ref.py``,
the entries the ported kernels need).

Each ``ref_*`` function is the semantic ground truth its kernel is held
to on the card, and what the wrappers run for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import quantizers as qz
from repro_torch.core.kv_cache import dequant_rows
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
                               softmax_scale: float | None = None,
                               vscale=None, vzero=None):
    """Fused decode attention over the grouped part of the cache.

    q (B, Hkv, Qh, d); values (B, Hkv, T, d) fp, or uint8 codes with
    vscale/vzero (B, Hkv, T, 1); length (B,) int32 valid
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
    values = torch.where(vmask[:, None, :, None],
                         dequant_rows(values, vscale, vzero), zero)
    out = torch.einsum("bhqt,bhtd->bhqd", p, values)
    return out, m, l


def ref_polar_paged_decode_attention(q, codes, rs, rz, ts, tz, values,
                                     page_table, flushed, *, r_bits: int,
                                     t_bits: int, vscale=None, vzero=None):
    """Page-native decode oracle: pool buffers + page table in, flash
    partials out. q (S, Hkv, Qh, d) ALREADY scaled; codes (PP, Hkv, g, P)
    with stats (PP, Hkv, 1, P); values (PP, Hkv, g, d) fp rows, or uint8
    codes with vscale/vzero (PP, Hkv, g, 1); page_table (S, N) int32;
    flushed (S,) int32."""
    table = page_table.long()

    def pages(x):  # (PP, H, a, b) -> (S, H, N*a, b)
        x = x[table].transpose(1, 2)
        return x.reshape(*x.shape[:2], -1, x.shape[-1])

    def groups(x):  # (PP, H, a, b) -> (S, H, N, a, b)
        return x[table].transpose(1, 2)

    if vscale is not None:
        vscale, vzero = pages(vscale), pages(vzero)
    return ref_polar_decode_attention(
        q, groups(codes), groups(rs), groups(rz), groups(ts), groups(tz),
        pages(values), flushed, r_bits=r_bits, t_bits=t_bits,
        softmax_scale=1.0, vscale=vscale, vzero=vzero)


def ref_polar_paged_prefill_attention(q, k_chunk, v_chunk, codes, rs, rz,
                                      ts, tz, values, page_row, start,
                                      chunk_len, *, r_bits: int, t_bits: int,
                                      softmax_scale: float | None = None,
                                      vscale=None, vzero=None):
    """Page-native chunk-prefill oracle: one prefill chunk's attention over
    the slot's quantized prefix pages + its own fp causal tile (port of
    ``repro/kernels/ref.py:86``).

    q (1, Hq, Tc, d) post-RoPE at absolute positions ``start + [0, Tc)``
    (UNscaled); k_chunk/v_chunk (1, Hkv, Tc, d); codes (PP, Hkv, g, P) page
    pool with stats (PP, Hkv, 1, P); values (PP, Hkv, g, d) fp rows, or
    uint8 codes with vscale/vzero (PP, Hkv, g, 1) (the chunk's own rows
    stay fp); page_row (N,) int32; ``start`` page-aligned; ``chunk_len``
    real chunk tokens. Pages outside ``[0, PP - 1)`` (the scratch page) read as
    zeros, and value rows at or past ``start`` (prefix pool) or
    ``chunk_len`` (chunk) are zeroed as the kernel zeroes them: their
    probabilities are exactly 0, but 0 * NaN garbage would poison the
    product. Returns (1, Hq, Tc, d) in q.dtype."""
    _, hq, tc, d = q.shape
    hkv = codes.shape[1]
    qpk = hq // hkv
    n = page_row.shape[0]
    g = codes.shape[2]
    t_cap = n * g
    num_pages = codes.shape[0] - 1          # last pool page is scratch
    scale = d ** -0.5 if softmax_scale is None else softmax_scale
    dev = q.device
    row = page_row.long()
    pvalid = (row >= 0) & (row < num_pages)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)

    def gat(pool):  # (PP, H, a, b) -> (1, H, N, a, b), invalid pages zeroed
        x = pool[row.clamp(0, pool.shape[0] - 1)]
        x = torch.where(pvalid[:, None, None, None], x,
                        torch.zeros((), dtype=x.dtype, device=dev))
        return x.transpose(0, 1)[None]

    q4 = (q.float() * scale).reshape(1, hkv, qpk, tc, d)
    qf = q4.reshape(1, hkv, qpk * tc, d)
    s_prefix = ref_polar_qk_scores(qf, gat(codes), gat(rs), gat(rz),
                                   gat(ts), gat(tz), r_bits=r_bits,
                                   t_bits=t_bits)
    s_prefix = s_prefix.reshape(1, hkv, qpk, tc, t_cap)
    pos = torch.arange(t_cap, device=dev)
    s_prefix = torch.where(pos < start, s_prefix, neg)

    kf = k_chunk.float()
    s_chunk = torch.einsum("bhqtd,bhsd->bhqts", q4, kf)
    i = torch.arange(tc, device=dev)
    cmask = (i[:, None] >= i[None, :]) & (i[None, :] < chunk_len)
    s_chunk = torch.where(cmask, s_chunk, neg)
    probs = torch.softmax(torch.cat([s_prefix, s_chunk], dim=-1), dim=-1)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    if vscale is not None:
        vscale, vzero = gat(vscale), gat(vzero)
    v_tilde = dequant_rows(gat(values), vscale, vzero).reshape(
        1, hkv, t_cap, d)
    v_tilde = torch.where((pos < start)[:, None], v_tilde, zero)
    v_c = torch.where((i < chunk_len)[:, None], v_chunk.float(), zero)
    v_all = torch.cat([v_tilde, v_c], dim=2)
    out = torch.einsum("bhqts,bhsd->bhqtd", probs, v_all)
    return out.reshape(1, hq, tc, d).to(q.dtype)
