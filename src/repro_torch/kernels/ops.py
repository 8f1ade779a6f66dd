"""Public entries over the hand-written kernels (port of
``repro/kernels/ops.py``, the entries of the ported paths).

There is no ``backend`` argument: each kernel wrapper launches its CUDA
kernel for CUDA tensors and runs its plain version for CPU tensors.
``polar_decode_attention_full`` (dense cache) and
``polar_paged_decode_attention_full`` (page pools) are the end-to-end
decode-attention entries: kernel partials over the flushed groups merged
exactly with the fp residual segment (associative online-softmax merge,
plain PyTorch).

Values are fp rows, or uint8 mid-tread codes passed with ``vscale`` /
``vzero`` (one fp32 scale and zero per (token, kv head) row, shaped like
the values with a last dim of 1): the kernels dequantize code · scale +
zero on the fly, and the residual segment's rows are dequantized here.
"""
from __future__ import annotations

import torch

from repro_torch.core.kv_cache import dequant_rows
from repro_torch.kernels import flash_prefill as fp_mod
from repro_torch.kernels import paged_decode as pd_mod
from repro_torch.kernels import paged_prefill as pp_mod
from repro_torch.kernels import polar_attention as pa_mod
from repro_torch.kernels import polar_encode as pe_mod
from repro_torch.kernels import polar_qk as qk_mod

NEG_INF = -1e30


def polar_qk_scores(q, codes, rs, rz, ts, tz, *, r_bits=4, t_bits=4):
    """LUT q.K scores over the dense cache: q (B, Hkv, Qh, d), codes
    (B, Hkv, G, g, P), stats (B, Hkv, G, 1, P) -> (B, Hkv, Qh, G*g) fp32."""
    return qk_mod.polar_qk_scores(q, codes, rs, rz, ts, tz, r_bits=r_bits,
                                  t_bits=t_bits)


def polar_encode(k, *, r_bits=4, t_bits=4, group_size=128, fixed=False):
    """Dense polar encode of k (B, Hkv, T, d) -> (codes, rs, rz, ts, tz);
    ``fixed``: the fixed angle grid."""
    return pe_mod.polar_encode(k, r_bits=r_bits, t_bits=t_bits,
                               group_size=group_size, fixed=fixed)


def polar_encode_pages(k, pages, codes, rs, rz, ts, tz, *, r_bits=4,
                       t_bits=4, fixed=False) -> None:
    """Paged polar encode in place (see ``polar_encode.polar_encode_pages``)."""
    pe_mod.polar_encode_pages(k, pages, codes, rs, rz, ts, tz,
                              r_bits=r_bits, t_bits=t_bits, fixed=fixed)


def polar_decode_attention_grouped(q, codes, rs, rz, ts, tz, values, length,
                                   *, vscale=None, vzero=None, r_bits=4,
                                   t_bits=4, plan_heads=None):
    """Fused flash decode over the dense grouped segment: q (B, Hkv, Qh, d)
    pre-scaled, dense buffers, length (B,) int32 -> flash partials.
    ``plan_heads``: the kv heads the split plan is made for (a head
    shard's call passes the model's)."""
    return pa_mod.polar_decode_attention_grouped(
        q, codes, rs, rz, ts, tz, values, length, vscale=vscale,
        vzero=vzero, r_bits=r_bits, t_bits=t_bits, plan_heads=plan_heads)


def polar_paged_decode_attention_grouped(q, codes, rs, rz, ts, tz, values,
                                         page_table, flushed, *, vscale=None,
                                         vzero=None, r_bits=4, t_bits=4,
                                         plan_heads=None):
    """Page-native fused flash decode over the grouped segment: pool
    buffers + page table in, flash partials out (no dense gather copy).
    ``plan_heads``: the kv heads the split plan is made for (a head
    shard's call passes the model's)."""
    return pd_mod.polar_paged_decode_grouped(
        q, codes, rs, rz, ts, tz, values, page_table, flushed, vscale=vscale,
        vzero=vzero, r_bits=r_bits, t_bits=t_bits, plan_heads=plan_heads)


def flash_prefill(q, k, v, *, mode="causal", window=0, prefix_len=None,
                  scale=None):
    """GQA flash attention forward for prefill in mask ``mode`` (causal,
    full, prefix with ``prefix_len`` (B,) int32, local with ``window``)."""
    return fp_mod.flash_prefill(q, k, v, mode=mode, window=window,
                                prefix_len=prefix_len, scale=scale)


def polar_paged_prefill_attention(q, k_chunk, v_chunk, codes, rs, rz, ts,
                                  tz, values, page_row, start, chunk_len, *,
                                  vscale=None, vzero=None, r_bits=4, t_bits=4,
                                  softmax_scale=None):
    """Page-native fused chunk-prefill attention: one chunk's queries
    against the slot's quantized prefix pages (LUT scores, in-place page
    walk) + the chunk's own fp causal tile, one online softmax.

    q (1, Hq, Tc, d) UNscaled post-RoPE queries; k_chunk/v_chunk
    (1, Hkv, Tc, d) fp (the chunk's own rows are never quantized here);
    pools as in :func:`polar_paged_decode_attention_grouped`; page_row (N,)
    int32; ``start`` (page-aligned) and ``chunk_len`` ints. Returns
    (1, Hq, Tc, d) in q.dtype."""
    _, hq, tc, d = q.shape
    hkv = codes.shape[1]
    qpk = hq // hkv
    scale = d ** -0.5 if softmax_scale is None else softmax_scale
    # fold chunk queries onto the head axis (row = qh * Tc + t) and
    # pre-scale — the kernel consumes one tall operand per kv head
    qf = (q.float() * scale).reshape(hkv, qpk * tc, d)
    out = pp_mod.polar_paged_prefill_grouped(
        qf, k_chunk[0].contiguous(), v_chunk[0].contiguous(), codes, rs, rz,
        ts, tz, values, page_row.contiguous(), start, chunk_len,
        vscale=vscale, vzero=vzero, r_bits=r_bits, t_bits=t_bits)
    return out.reshape(1, hq, tc, d).to(q.dtype)


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


def polar_decode_attention_full(q, codes, rs, rz, ts, tz, key_residual,
                                values, length, *, vscale=None, vzero=None,
                                r_bits=4, t_bits=4, softmax_scale=None,
                                plan_heads=None):
    """End-to-end decode attention over the dense cache: flushed groups
    through the fused kernel + the fp residual segment, merged exactly.

    q (B, Hq, d); codes (B, Hkv, G, g, P) with stats (B, Hkv, G, 1, P);
    key_residual (B, Hkv, g, d); values (B, Hkv, T, d) token-major rows
    (fp, or uint8 with vscale/vzero (B, Hkv, T, 1)); length () or (B,) int32 total tokens (per-row lengths mask gathered
    continuous-batching slots at their own positions). ``plan_heads`` as
    in :func:`polar_decode_attention_grouped`. Returns (B, Hq, d) in
    q.dtype."""
    b, hq, d = q.shape
    hkv = codes.shape[1]
    g = codes.shape[3]
    qpk = hq // hkv
    scale = d ** -0.5 if softmax_scale is None else softmax_scale
    q4 = (q.float() * scale).reshape(b, hkv, qpk, d).contiguous()
    len_b = length.to(torch.int32).expand(b).contiguous()
    flushed = (len_b // g) * g                                   # (B,)

    acc_g, m_g, l_g = polar_decode_attention_grouped(
        q4, codes, rs, rz, ts, tz, values, flushed, vscale=vscale,
        vzero=vzero, r_bits=r_bits, t_bits=t_bits, plan_heads=plan_heads)

    # residual V rows live token-major at [flushed, flushed + g), gathered
    # per row (flushed differs across slots; the clamp keeps the gather in
    # bounds when a full cache leaves no residual rows to read)
    t_cap = values.shape[2]
    slot = torch.arange(g, dtype=torch.int32, device=q.device)
    rows = torch.clamp(flushed[:, None] + slot[None, :], max=t_cap - 1)
    idx = rows[:, None, :, None].long()
    v_res = torch.gather(values, 2, idx.expand(b, hkv, g, d))    # (B,H,g,d)
    if vscale is not None:
        one = idx.expand(b, hkv, g, 1)
        vscale, vzero = (torch.gather(x, 2, one) for x in (vscale, vzero))
    v_res = dequant_rows(v_res, vscale, vzero)
    acc_r, m_r, l_r = _residual_flash_partials(q4, key_residual,
                                               len_b - flushed, v_res)
    out = merge_softmax_partials([(acc_g, m_g, l_g), (acc_r, m_r, l_r)])
    return out.reshape(b, hq, d).to(q.dtype)


def polar_paged_decode_attention_full(
        q, codes, rs, rz, ts, tz, key_residual, values, page_table, lengths,
        *, vscale=None, vzero=None, r_bits=4, t_bits=4, softmax_scale=None,
        plan_heads=None):
    """End-to-end page-native decode attention: flushed pages through the
    page-walking kernel + the fp residual segment, merged exactly.

    q (S, Hq, d); pools as in :func:`polar_paged_decode_attention_grouped`;
    key_residual (S, Hkv, g, d); page_table (S, N) int32 (N may be
    width-sliced to the live pages); lengths (S,) int32. The residual's
    value rows live in the page being filled (``table[s, flushed // g]``).
    ``plan_heads`` as in :func:`polar_paged_decode_attention_grouped`.
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
        vscale=vscale, vzero=vzero, r_bits=r_bits, t_bits=t_bits,
        plan_heads=plan_heads)

    # residual V rows sit in the page being filled; empty slots clamp to
    # table entry 0 (possibly scratch) and every row is masked below
    gidx = torch.clamp(flushed // g, max=page_table.shape[1] - 1)
    pv = torch.gather(page_table, 1, gidx[:, None].long())[:, 0].long()
    if vscale is not None:
        vscale, vzero = vscale[pv], vzero[pv]
    v_res = dequant_rows(values[pv], vscale, vzero)              # (S,H,g,d)
    acc_r, m_r, l_r = _residual_flash_partials(q4, key_residual,
                                               len_b - flushed, v_res)
    out = merge_softmax_partials([(acc_g, m_g, l_g), (acc_r, m_r, l_r)])
    return out.reshape(s, hq, d).to(q.dtype)
