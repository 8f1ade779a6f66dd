"""Page-native fused PolarQuant chunk-prefill attention: hand-written CUDA
kernel + its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_prefill.py::
polar_paged_prefill_grouped``. Source: ``csrc/paged_prefill.cu``.

One prefill chunk's queries (folded onto the head axis: QT = (Hq/Hkv)*Tc
rows per kv head, row = qh*Tc + t, pre-scaled) attend to the slot's
quantized prefix pages ``[0, start)`` and, causally, to the chunk's own fp
keys, under one online softmax; 64 query rows of one kv head per block.

Bound: operations — the q.k and p.V products, on the tensor cores. With
bf16 chunk K/V and a bf16 value pool (the served path) each block
dequantizes every live page once into bf16 hi/lo keys and runs
``mma.sync`` products with fp32 operands carried as hi + lo bf16 pairs
(held to the same 1e-4 as the FMA body), pages and chunk tiles
double-buffered by ``cp.async``; fp32 inputs (the tests') take the
fp32-FMA body. ``launches_mma`` counts the tensor-core launches.

Value pools are bf16/fp32 rows, or uint8 mid-tread codes with one fp32
scale and zero per row (the TPU kernel's uint8 branch,
``repro/kernels/paged_prefill.py:103``). The tensor-core body takes uint8
pools with bf16 chunk K/V: codes (at most 255, exact in bf16) are the B
operand of P.V, P's columns are scaled by the rows' scales before the
hi/lo split, and each query row adds sum_t p_t z_t. The FMA body
dequantizes them as it stages a page. The chunk's own rows stay fp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import work as W
from repro_torch import cost_hook

#: kernel launches since the last reset (CPU calls never count)
launches = 0
#: of those, the launches that read uint8 value rows
launches_u8 = 0
#: of those, the launches that ran the tensor-core body
launches_mma = 0


def _bind(lib) -> None:
    lib.paged_prefill_launch.argtypes = [
        B.VOIDP, B.VOIDP, B.VOIDP, B.INT, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP,
        B.VOIDP, B.VOIDP, B.INT, B.VOIDP, B.VOIDP, B.VOIDP, B.INT, B.INT,
        B.VOIDP, B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.VOIDP]
    lib.paged_prefill_launch.restype = B.INT
    lib.paged_prefill_tensor_core.argtypes = [
        B.INT, B.INT, B.INT, B.INT, B.INT, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP,
        B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP]
    lib.paged_prefill_tensor_core.restype = B.INT


def polar_paged_prefill_grouped_plain(q, k_chunk, v_chunk, codes, rs, rz, ts,
                                      tz, values, page_row, start: int,
                                      chunk_len: int, *, vscale=None,
                                      vzero=None, r_bits: int = 4,
                                      t_bits: int = 4) -> torch.Tensor:
    """Plain version: unfold the rows and run the gathering oracle
    (``ref.ref_polar_paged_prefill_attention``) at softmax scale 1."""
    hkv, qt, d = q.shape
    tc = k_chunk.shape[1]
    out = ref_mod.ref_polar_paged_prefill_attention(
        q.reshape(1, qt // tc * hkv, tc, d), k_chunk[None], v_chunk[None],
        codes, rs, rz, ts, tz, values, page_row, start, chunk_len,
        r_bits=r_bits, t_bits=t_bits, softmax_scale=1.0, vscale=vscale,
        vzero=vzero)
    return out.float().reshape(hkv, qt, d)


def polar_paged_prefill_grouped(q: torch.Tensor, k_chunk: torch.Tensor,
                                v_chunk: torch.Tensor, codes: torch.Tensor,
                                rs: torch.Tensor, rz: torch.Tensor,
                                ts: torch.Tensor, tz: torch.Tensor,
                                values: torch.Tensor, page_row: torch.Tensor,
                                start: int, chunk_len: int, *, vscale=None,
                                vzero=None, r_bits: int = 4,
                                t_bits: int = 4) -> torch.Tensor:
    """One prefill chunk's fused attention, straight off the pools.

    q (Hkv, QT, d) fp32, folded and ALREADY scaled; k_chunk/v_chunk
    (Hkv, Tc, d) bf16/fp32; codes (PP, Hkv, g, d/2) uint8; stats
    (PP, Hkv, 1, d/2) fp32; values (PP, Hkv, g, d) bf16/fp32 rows, or
    uint8 codes with fp32 vscale/vzero (PP, Hkv, g, 1); page_row (N,) int32, the slot's table row (may be width-sliced);
    ``start`` page-aligned, ``start <= N*g``; ``chunk_len <= Tc`` real
    chunk tokens. Returns (Hkv, QT, d) fp32. The kernel for CUDA tensors,
    the plain version for CPU tensors, the output's shape for meta
    tensors."""
    start, chunk_len = int(start), int(chunk_len)
    g = codes.shape[2]
    B.require(start % g == 0, f"start {start} is not page-aligned (g={g})")
    B.require(0 <= start <= page_row.shape[0] * g,
              f"start {start} beyond the table row's {page_row.shape[0]} "
              "pages")
    tensors = (q, k_chunk, v_chunk, codes, rs, rz, ts, tz, values, page_row)
    quant = tuple(x for x in (vscale, vzero) if x is not None)
    where = B.route(*tensors, *quant)
    with cost_hook.kernel_call("paged_prefill", lambda: work(
            q, k_chunk, codes, values, start, t_bits=t_bits)):
        if where == "cpu":
            return polar_paged_prefill_grouped_plain(
                q, k_chunk, v_chunk, codes, rs, rz, ts, tz, values,
                page_row, start, chunk_len, vscale=vscale, vzero=vzero,
                r_bits=r_bits, t_bits=t_bits)
        return _launch(q, k_chunk, v_chunk, codes, rs, rz, ts, tz, values,
                       page_row, start, chunk_len, vscale, vzero, t_bits,
                       where)


def work(q, k_chunk, codes, values, start: int, *,
         t_bits: int = 4) -> W.Work:
    """One call's work (``kernels/work.py``) from the shapes and the host
    ``start``: the prefix's pages and a whole chunk."""
    hkv, qt, d = q.shape
    tc = k_chunk.shape[1]
    return W.paged_prefill(hkv=hkv, qh=qt // tc, d=d, g=codes.shape[2],
                           start=int(start), chunk=tc,
                           value_elt=values.element_size(),
                           kv_elt=k_chunk.element_size(), t_bits=t_bits)


def _launch(q, k_chunk, v_chunk, codes, rs, rz, ts, tz, values, page_row,
            start, chunk_len, vscale, vzero, t_bits, where):
    global launches, launches_u8, launches_mma
    g = codes.shape[2]
    hkv, qt, d = q.shape
    pp, _, _, p = codes.shape
    tc = k_chunk.shape[1]
    B.require(q.dtype == torch.float32 and q.is_contiguous(),
              "q must be contiguous float32 (Hkv, QT, d)")
    B.require(d in (32, 64, 128) and p * 2 == d, f"head_dim {d} not in "
              "(32, 64, 128)")
    for x in (k_chunk, v_chunk):
        B.require(x.dtype == k_chunk.dtype
                  and x.dtype in (torch.float32, torch.bfloat16)
                  and x.is_contiguous() and tuple(x.shape) == (hkv, tc, d),
                  "k_chunk/v_chunk must be contiguous (Hkv, Tc, d), both "
                  "bf16 or both fp32")
    B.require(qt % tc == 0 and 0 <= chunk_len <= tc,
              "QT must be a multiple of Tc and chunk_len <= Tc")
    B.require(codes.dtype == torch.uint8 and codes.is_contiguous()
              and codes.shape[1] == hkv and codes.data_ptr() % 4 == 0,
              "codes pool must be contiguous uint8 (PP, Hkv, g, d/2)")
    for st in (rs, rz, ts, tz):
        B.require(st.dtype == torch.float32 and st.is_contiguous()
                  and tuple(st.shape) == (pp, hkv, 1, p),
                  "stat pools must be contiguous float32 (PP, Hkv, 1, d/2)")
    v_kind, vs_ptr, vz_ptr = B.value_rows(values, vscale, vzero,
                                          (pp, hkv, g, d))
    B.require(page_row.dtype == torch.int32 and page_row.dim() == 1
              and page_row.is_contiguous(),
              "page_row must be a contiguous int32 (N,) row")
    out = torch.empty((hkv, qt, d), dtype=torch.float32, device=q.device)
    if where == "meta":
        return out
    lib = B.library("paged_prefill", _bind)
    kv_bf16 = int(k_chunk.dtype == torch.bfloat16)
    pools = (codes.data_ptr(), rs.data_ptr(), rz.data_ptr(), ts.data_ptr(),
             tz.data_ptr(), values.data_ptr())
    err = lib.paged_prefill_launch(
        q.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(), kv_bf16,
        *pools, v_kind, vs_ptr, vz_ptr, page_row.data_ptr(), start // g,
        chunk_len, out.data_ptr(), hkv, qt, tc, d, g, pp, t_bits,
        B.stream_ptr(q))
    B.check(err, "paged_prefill")
    launches += 1
    launches_u8 += int(values.dtype == torch.uint8)
    launches_mma += lib.paged_prefill_tensor_core(
        kv_bf16, v_kind, d, g, t_bits, k_chunk.data_ptr(), v_chunk.data_ptr(),
        *pools, vs_ptr, vz_ptr)
    return out
