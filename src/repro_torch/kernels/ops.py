"""Public entries over the hand-written kernels (port of
``repro/kernels/ops.py``, the entries on this slice's path).

There is no ``backend`` argument: each kernel wrapper launches its CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors.
``polar_paged_decode_attention_full`` is the end-to-end decode-attention
entry: kernel partials over the flushed pages merged exactly with the fp
residual segment (associative online-softmax merge, plain PyTorch).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_prefill as fp_mod
from repro_torch.kernels import paged_decode as pd_mod
from repro_torch.kernels import polar_encode as pe_mod

NEG_INF = -1e30


def polar_encode(k, *, r_bits=4, t_bits=4, group_size=128):
    """Dense polar encode of k (B, Hkv, T, d) -> (codes, rs, rz, ts, tz)."""
    return pe_mod.polar_encode(k, r_bits=r_bits, t_bits=t_bits,
                               group_size=group_size)


def polar_encode_pages(k, pages, codes, rs, rz, ts, tz, *, r_bits=4,
                       t_bits=4) -> None:
    """Paged polar encode in place (see ``polar_encode.polar_encode_pages``)."""
    pe_mod.polar_encode_pages(k, pages, codes, rs, rz, ts, tz,
                              r_bits=r_bits, t_bits=t_bits)


def polar_paged_decode_attention_grouped(q, codes, rs, rz, ts, tz, values,
                                         page_table, flushed, *, r_bits=4,
                                         t_bits=4):
    """Page-native fused flash decode over the grouped segment: pool
    buffers + page table in, flash partials out (no dense gather copy)."""
    return pd_mod.polar_paged_decode_grouped(
        q, codes, rs, rz, ts, tz, values, page_table, flushed,
        r_bits=r_bits, t_bits=t_bits)


def flash_prefill(q, k, v, *, causal=True, scale=None):
    """Causal GQA flash attention forward for prefill."""
    return fp_mod.flash_prefill(q, k, v, causal=causal, scale=scale)


def merge_softmax_partials(parts):
    """Exactly merge flash partials [(acc, m, l), ...] -> normalized output.
    acc: (..., d) = sum exp(s - m) v;  m, l: (...,)."""
    m_tot = parts[0][1]
    for _, m, _ in parts[1:]:
        m_tot = torch.maximum(m_tot, m)
    l_tot = 0.0
    acc_tot = 0.0
    for acc, m, l in parts:
        corr = torch.exp(m - m_tot)
        l_tot = l_tot + l * corr
        acc_tot = acc_tot + acc * corr[..., None]
    l_safe = torch.where(l_tot == 0.0, torch.ones_like(l_tot), l_tot)
    return acc_tot / l_safe[..., None]


def _residual_flash_partials(q4, key_residual, n_res, v_res):
    """Flash partials of the fp residual segment.

    q4 (B, Hkv, Qh, d) ALREADY scaled; key_residual (B, Hkv, g, d); n_res
    (B,) tokens in the residual window; v_res (B, Hkv, g, d) fp32 value
    rows for positions [flushed, flushed + g) — dead rows may hold garbage
    and are zeroed under the mask, so ``p == 0`` lanes never contribute
    ``0 * NaN``. Returns (acc_r, m_r, l_r)."""
    res = key_residual.float()
    g = res.shape[2]
    zero = torch.zeros((), dtype=torch.float32, device=q4.device)
    s_res = torch.einsum("bhqd,bhgd->bhqg", q4, res)
    slot = torch.arange(g, dtype=torch.int32, device=q4.device)
    mask = slot[None, None, None, :] < n_res[:, None, None, None]
    s_res = torch.where(mask, s_res, torch.full_like(zero, NEG_INF))
    m_r = torch.amax(s_res, dim=-1)
    p_r = torch.where(mask, torch.exp(s_res - m_r[..., None]), zero)
    l_r = torch.sum(p_r, dim=-1)
    row_live = slot[None, :] < n_res[:, None]
    v_res = torch.where(row_live[:, None, :, None], v_res, zero)
    acc_r = torch.einsum("bhqg,bhgd->bhqd", p_r, v_res)
    return acc_r, m_r, l_r


def polar_paged_decode_attention_full(
        q, codes, rs, rz, ts, tz, key_residual, values, page_table, lengths,
        *, r_bits=4, t_bits=4, softmax_scale=None):
    """End-to-end page-native decode attention: flushed pages through the
    page-walking kernel + the fp residual segment, merged exactly.

    q (S, Hq, d); pools as in :func:`polar_paged_decode_attention_grouped`;
    key_residual (S, Hkv, g, d); page_table (S, N) int32 (N may be
    width-sliced to the live pages); lengths (S,) int32. The residual's
    value rows live in the page being filled (``table[s, flushed // g]``).
    Returns (S, Hq, d) in q.dtype."""
    s, hq, d = q.shape
    hkv = codes.shape[1]
    g = codes.shape[2]
    qpk = hq // hkv
    scale = d ** -0.5 if softmax_scale is None else softmax_scale
    q4 = (q.float() * scale).reshape(s, hkv, qpk, d).contiguous()
    len_b = lengths.to(torch.int32)
    flushed = (len_b // g) * g                                   # (S,)

    acc_g, m_g, l_g = polar_paged_decode_attention_grouped(
        q4, codes, rs, rz, ts, tz, values, page_table, flushed,
        r_bits=r_bits, t_bits=t_bits)

    # residual V rows sit in the page being filled; empty slots clamp to
    # table entry 0 (possibly scratch) and every row is masked below
    gidx = torch.clamp(flushed // g, max=page_table.shape[1] - 1)
    pv = torch.gather(page_table, 1, gidx[:, None].long())[:, 0]  # (S,)
    v_res = values[pv.long()].float()                            # (S,H,g,d)
    acc_r, m_r, l_r = _residual_flash_partials(q4, key_residual,
                                               len_b - flushed, v_res)
    out = merge_softmax_partials([(acc_g, m_g, l_g), (acc_r, m_r, l_r)])
    return out.reshape(s, hq, d).to(q.dtype)
