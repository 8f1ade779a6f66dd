"""Page-native fused PolarQuant decode attention: hand-written CUDA kernel
+ its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_decode.py::
polar_paged_decode_grouped`` (LUT tile ``repro/kernels/polar_attention.py::
_lut_scores_block``). Source: ``csrc/paged_decode.cu`` (body in
``csrc/lut_decode.cuh``).

Per (slot, kv head) it walks the slot's live pages in the page table and,
per page, stages the page's stats, codes and value rows in shared memory
(dead value rows as zeros), builds the angle LUT, scores the page's tokens
by gather, masks positions >= ``flushed[s]``, and folds them into an
online softmax and p @ V. Output: the unnormalized flash partials
(acc, m, l) over the flushed groups; the residual merge happens in
``kernels/ops.py``. Value rows are bf16/fp32, or uint8 mid-tread codes
with one fp32 scale and zero per row (the TPU kernel's uint8 branch,
``repro/kernels/paged_decode.py:81``): the split body stages the codes
and the page's scales and zeros and folds the scale into the
probability, sum_t p_t (c_t s_t + z_t) = sum_t (p_t s_t) c_t +
sum_t p_t z_t, so p @ V stays one FMA per element.

Bound: bytes — the live pages' codes, stats and value rows are read once
per (slot, kv head) — but each page is a short dependent chain, so the
time follows how many chains run at once. The host splits each walk into
:func:`plan_splits` ranges, one block each (256 blocks at 8 slots x 4 kv
heads x 8 pages, where one block per (slot, kv head) gave 32), the kernel
merges the splits' partials on the device in the same call, and inside a
split the next page's loads are in flight while the current one is
scored.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import work as W
from repro_torch import cost_hook

#: kernel launches since the last reset (CPU calls never count)
launches = 0
#: of those, the launches that read uint8 value rows
launches_u8 = 0
#: of those, the launches that ran the split body (``d % 32 == 0`` and
#: 16-byte aligned pools; the unsplit body otherwise)
launches_split = 0

#: blocks the split planner aims at: two resident blocks on each of an
#: H100's 132 SMs
SPLIT_TARGET_BLOCKS = 2 * 132


def plan_splits(s: int, hkv: int, n: int) -> int:
    """Splits of each (slot, kv head)'s walk over a table ``n`` pages wide:
    ``nsplit = ceil(n / pages)`` for the fewest pages per split that keep
    ``s * hkv * nsplit`` blocks within :data:`SPLIT_TARGET_BLOCKS` (1 when
    even one split per (slot, kv head) does not). Reads shapes only (never
    ``flushed``), so it costs no device sync."""
    if n <= 0:
        return 1
    per = max(1, -(-s * hkv * n // SPLIT_TARGET_BLOCKS))
    while per < n and s * hkv * -(-n // per) > SPLIT_TARGET_BLOCKS:
        per += 1
    return -(-n // per)


def split_ranges(n: int, nsplit: int) -> list[tuple[int, int]]:
    """The table-entry ranges ``[lo, hi)`` the kernel's splits walk, as
    ``csrc/lut_decode.cuh::launch_lut_split_decode`` cuts them: ranges of
    ``ceil(n / nsplit)`` entries, the last one ragged."""
    if n <= 0:
        return [(0, 0)]
    per = -(-n // max(nsplit, 1))
    return [(lo, min(lo + per, n)) for lo in range(0, n, per)]


def _bind(lib) -> None:
    lib.paged_decode_launch.argtypes = [
        B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT,
        B.VOIDP, B.VOIDP, B.VOIDP, B.LLONG, B.INT, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT,
        B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.VOIDP,
        ctypes.POINTER(B.INT), B.VOIDP]
    lib.paged_decode_launch.restype = B.INT


def polar_paged_decode_grouped_plain(q, codes, rs, rz, ts, tz, values,
                                     page_table, flushed, *, vscale=None,
                                     vzero=None, r_bits: int = 4,
                                     t_bits: int = 4,
                                     plan_heads: int | None = None):
    """Plain version: gather the table's pages, LUT scores, masked softmax
    partials (``ref.ref_polar_paged_decode_attention``). It walks no
    splits, so ``plan_heads`` changes nothing; it is taken so that the
    plain version can stand in for the kernel's wrapper."""
    return ref_mod.ref_polar_paged_decode_attention(
        q, codes, rs, rz, ts, tz, values, page_table, flushed,
        r_bits=r_bits, t_bits=t_bits, vscale=vscale, vzero=vzero)


def polar_paged_decode_grouped(q: torch.Tensor, codes: torch.Tensor,
                               rs: torch.Tensor, rz: torch.Tensor,
                               ts: torch.Tensor, tz: torch.Tensor,
                               values: torch.Tensor, page_table: torch.Tensor,
                               flushed: torch.Tensor, *, vscale=None,
                               vzero=None, r_bits: int = 4, t_bits: int = 4,
                               plan_heads: int | None = None):
    """Fused flash decode over the grouped segment, straight off the pools.

    q (S, Hkv, Qh, d) fp32, ALREADY scaled; codes (PP, Hkv, g, P) uint8;
    stats (PP, Hkv, 1, P) fp32; values (PP, Hkv, g, d) bf16/fp32 rows, or
    uint8 codes with fp32 vscale/vzero (PP, Hkv, g, 1); page_table (S, N) int32 (may be a width slice of a wider table);
    flushed (S,) int32. Returns (acc (S,Hkv,Qh,d), m (S,Hkv,Qh),
    l (S,Hkv,Qh)) fp32. The kernel for CUDA tensors, the plain version
    for CPU tensors, outputs of the kernel's shapes for meta tensors.
    ``plan_heads``: plan the splits as for that many kv heads — a head
    shard's call passes the model's count, so its splits, and the order
    its partials merge in, are those of the unsharded call (default:
    Hkv)."""
    tensors = (q, codes, rs, rz, ts, tz, values, page_table, flushed)
    quant = tuple(x for x in (vscale, vzero) if x is not None)
    where = B.route(*tensors, *quant)
    with cost_hook.kernel_call("paged_decode", lambda: work(
            q, codes, values, page_table, t_bits=t_bits)):
        if where == "cpu":
            return polar_paged_decode_grouped_plain(
                q, codes, rs, rz, ts, tz, values, page_table, flushed,
                vscale=vscale, vzero=vzero, r_bits=r_bits, t_bits=t_bits)
        return _launch(q, codes, rs, rz, ts, tz, values, page_table,
                       flushed, vscale, vzero, t_bits, plan_heads, where)


def work(q, codes, values, page_table, *, t_bits: int = 4) -> W.Work:
    """One call's work from the shapes (``kernels/work.py``): every table
    entry's page walked (``flushed`` is data)."""
    s, hkv, qh, d = q.shape
    n = page_table.shape[1]
    return W.paged_decode(s * n * hkv, s=s, hkv=hkv, qh=qh, d=d,
                          g=codes.shape[2], table=page_table.numel(),
                          value_elt=values.element_size(), t_bits=t_bits)


def _launch(q, codes, rs, rz, ts, tz, values, page_table, flushed, vscale,
            vzero, t_bits, plan_heads, where):
    global launches, launches_u8, launches_split
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
    v_kind, vs_ptr, vz_ptr = B.value_rows(values, vscale, vzero,
                                          (pp, hkv, g, d))
    B.require(page_table.dtype == torch.int32 and page_table.dim() == 2
              and page_table.shape[0] == s and page_table.stride(1) == 1,
              "page_table must be int32 (S, N) with unit column stride")
    B.require(flushed.dtype == torch.int32 and flushed.is_contiguous()
              and tuple(flushed.shape) == (s,), "flushed must be int32 (S,)")
    acc = torch.empty((s, hkv, qh, d), dtype=torch.float32, device=q.device)
    m = torch.empty((s, hkv, qh), dtype=torch.float32, device=q.device)
    l = torch.empty((s, hkv, qh), dtype=torch.float32, device=q.device)
    if where == "meta":
        return acc, m, l
    nsplit = plan_splits(s, plan_heads or hkv, n)
    # the splits' (acc, m, l) partials, merged on the device
    part = torch.empty(nsplit * s * hkv * qh * (d + 2), dtype=torch.float32,
                       device=q.device) if nsplit > 1 else None
    split_body = B.INT(0)
    lib = B.library("paged_decode", _bind)
    err = lib.paged_decode_launch(
        q.data_ptr(), codes.data_ptr(), rs.data_ptr(), rz.data_ptr(),
        ts.data_ptr(), tz.data_ptr(), values.data_ptr(), v_kind, vs_ptr,
        vz_ptr, page_table.data_ptr(),
        page_table.stride(0), n, flushed.data_ptr(), acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), s, hkv, qh, d, g, pp, t_bits, nsplit,
        None if part is None else part.data_ptr(), ctypes.byref(split_body),
        B.stream_ptr(q))
    B.check(err, "paged_decode")
    launches += 1
    launches_u8 += int(values.dtype == torch.uint8)
    launches_split += split_body.value
    return acc, m, l
