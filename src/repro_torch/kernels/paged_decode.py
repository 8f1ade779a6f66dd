"""Page-native fused PolarQuant decode attention: hand-written CUDA kernel
+ its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_decode.py::
polar_paged_decode_grouped`` (LUT tile ``repro/kernels/polar_attention.py::
_lut_scores_block``). Source: ``csrc/paged_decode.cu``.

Per (slot, kv head) it walks the slot's live pages in the page table and,
per page, stages the page's stats, codes and value rows in shared memory
(16-byte loads, dead value rows zeroed), builds the angle LUT, scores the
page's tokens by gather, masks positions >= ``flushed[s]``, and folds them
into an online softmax and p @ V. The LUT flash-decode body is shared with
the dense-cache kernel (``csrc/lut_decode.cuh``). Output: the unnormalized
flash partials (acc, m, l) over the flushed groups; the residual merge
happens in ``kernels/ops.py``.

Bound: bytes — the live pages' codes, stats and value rows are read once
per (slot, kv head). The grid has only S*Hkv blocks (32 on the serving
path), which leaves most SMs idle; splitting the page walk across blocks
is the first known fix.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import ref as ref_mod

#: kernel launches since the last reset (CPU calls never count)
launches = 0


def _bind(lib) -> None:
    lib.paged_decode_launch.argtypes = [
        B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT,
        B.VOIDP, B.LLONG, B.INT, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT,
        B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.VOIDP]
    lib.paged_decode_launch.restype = B.INT


def polar_paged_decode_grouped_plain(q, codes, rs, rz, ts, tz, values,
                                     page_table, flushed, *, r_bits: int = 4,
                                     t_bits: int = 4):
    """Plain version: gather the table's pages, LUT scores, masked softmax
    partials (``ref.ref_polar_paged_decode_attention``)."""
    return ref_mod.ref_polar_paged_decode_attention(
        q, codes, rs, rz, ts, tz, values, page_table, flushed,
        r_bits=r_bits, t_bits=t_bits)


def polar_paged_decode_grouped(q: torch.Tensor, codes: torch.Tensor,
                               rs: torch.Tensor, rz: torch.Tensor,
                               ts: torch.Tensor, tz: torch.Tensor,
                               values: torch.Tensor, page_table: torch.Tensor,
                               flushed: torch.Tensor, *, r_bits: int = 4,
                               t_bits: int = 4):
    """Fused flash decode over the grouped segment, straight off the pools.

    q (S, Hkv, Qh, d) fp32, ALREADY scaled; codes (PP, Hkv, g, P) uint8;
    stats (PP, Hkv, 1, P) fp32; values (PP, Hkv, g, d) bf16/fp32 rows;
    page_table (S, N) int32 (may be a width slice of a wider table);
    flushed (S,) int32. Returns (acc (S,Hkv,Qh,d), m (S,Hkv,Qh),
    l (S,Hkv,Qh)) fp32. The kernel for CUDA tensors, the plain version
    for CPU tensors."""
    global launches
    tensors = (q, codes, rs, rz, ts, tz, values, page_table, flushed)
    if not B.on_card(*tensors):
        return polar_paged_decode_grouped_plain(
            q, codes, rs, rz, ts, tz, values, page_table, flushed,
            r_bits=r_bits, t_bits=t_bits)
    s, hkv, qh, d = q.shape
    pp, _, g, p = codes.shape
    n = page_table.shape[1]
    B.require(q.dtype == torch.float32 and q.is_contiguous(),
              "q must be contiguous float32 (S, Hkv, Qh, d)")
    B.require(codes.dtype == torch.uint8 and codes.is_contiguous()
              and codes.shape[1] == hkv and p * 2 == d,
              "codes pool must be contiguous uint8 (PP, Hkv, g, d/2)")
    for st in (rs, rz, ts, tz):
        B.require(st.dtype == torch.float32 and st.is_contiguous()
                  and tuple(st.shape) == (pp, hkv, 1, p),
                  "stat pools must be contiguous float32 (PP, Hkv, 1, d/2)")
    B.require(values.dtype in (torch.float32, torch.bfloat16)
              and values.is_contiguous()
              and tuple(values.shape) == (pp, hkv, g, d),
              "values must be contiguous bf16/fp32 (PP, Hkv, g, d)")
    B.require(page_table.dtype == torch.int32 and page_table.dim() == 2
              and page_table.shape[0] == s and page_table.stride(1) == 1,
              "page_table must be int32 (S, N) with unit column stride")
    B.require(flushed.dtype == torch.int32 and flushed.is_contiguous()
              and tuple(flushed.shape) == (s,), "flushed must be int32 (S,)")
    acc = torch.empty((s, hkv, qh, d), dtype=torch.float32, device=q.device)
    m = torch.empty((s, hkv, qh), dtype=torch.float32, device=q.device)
    l = torch.empty((s, hkv, qh), dtype=torch.float32, device=q.device)
    lib = B.library("paged_decode", _bind)
    err = lib.paged_decode_launch(
        q.data_ptr(), codes.data_ptr(), rs.data_ptr(), rz.data_ptr(),
        ts.data_ptr(), tz.data_ptr(), values.data_ptr(),
        int(values.dtype == torch.bfloat16), page_table.data_ptr(),
        page_table.stride(0), n, flushed.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), s, hkv, qh, d, g, pp, t_bits,
        B.stream_ptr(q))
    B.check(err, "paged_decode")
    launches += 1
    return acc, m, l
