"""Fused PolarQuant decode attention over the dense cache: hand-written
CUDA kernel + its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/polar_attention.py::
polar_decode_attention_grouped``. Source: ``csrc/polar_attention.cu``
(the LUT flash-decode bodies are shared with the page-walking kernel in
``csrc/lut_decode.cuh``).

Per (row, kv head) it walks the row's live groups of the dense
``(B, Hkv, G, g, P)`` buffers and, per group, stages the group's stats,
codes and value rows in shared memory (16-byte loads, dead value rows
zeroed), builds the angle LUT, scores the group's tokens by gather, masks
positions >= ``length[b]``, and folds them into an online softmax and
p @ V. Output: the unnormalized flash partials (acc, m, l); the residual
merge happens in ``kernels/ops.py``. Value rows are bf16/fp32, or uint8
mid-tread codes with one fp32 scale and zero per row (the TPU kernel's
uint8 branch, ``repro/kernels/polar_attention.py:84``).

Bound: bytes — the live groups' codes, stats and value rows are read once
per (row, kv head) — but each group is a short dependent chain, so the
time follows how many chains run at once. As for the page-walking kernel,
the host splits each row's walk over the G groups into
:func:`paged_decode.plan_splits` ranges, one block each (160 blocks at
8 rows x 4 kv heads x 9 groups, where one block per (row, kv head) gave
32), and the kernel merges the splits' partials on the device in the same
call. Shapes the split body does not take (d % 32 != 0, unaligned
buffers) run the unsplit body; ``launches_split`` counts the launches
that took the split body.

A split block stages its group in two shared-memory buffers where they
fit the 227 KB a block may opt into, else in one (bf16 rows at d 256 with
8 query heads, paligemma-3b's shape, need 258,176 B for two and 172,160
for one). A shape that does not fit even one buffer (fp32 rows at d 256
and 8 query heads: 237,696 B) fails at launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import work as W
from repro_torch.kernels.paged_decode import plan_splits
from repro_torch import cost_hook

#: kernel launches since the last reset (CPU calls never count)
launches = 0
#: of those, the launches that read uint8 value rows
launches_u8 = 0
#: of those, the launches that ran the split body
launches_split = 0


def _bind(lib) -> None:
    lib.polar_attention_launch.argtypes = [
        B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT,
        B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT, B.INT, B.INT, B.INT, B.INT,
        B.INT, B.INT, B.INT, B.VOIDP, ctypes.POINTER(B.INT), B.VOIDP]
    lib.polar_attention_launch.restype = B.INT


def polar_decode_attention_grouped_plain(q, codes, rs, rz, ts, tz, values,
                                         length, *, vscale=None, vzero=None,
                                         r_bits: int = 4, t_bits: int = 4,
                                         plan_heads: int | None = None):
    """Plain version: LUT scores, masked softmax partials, dead value rows
    zeroed (``ref.ref_polar_decode_attention`` with q already scaled). It
    walks no splits, so ``plan_heads`` changes nothing."""
    return ref_mod.ref_polar_decode_attention(
        q, codes, rs, rz, ts, tz, values, length, r_bits=r_bits,
        t_bits=t_bits, softmax_scale=1.0, vscale=vscale, vzero=vzero)


def polar_decode_attention_grouped(q: torch.Tensor, codes: torch.Tensor,
                                   rs: torch.Tensor, rz: torch.Tensor,
                                   ts: torch.Tensor, tz: torch.Tensor,
                                   values: torch.Tensor, length: torch.Tensor,
                                   *, vscale=None, vzero=None,
                                   r_bits: int = 4, t_bits: int = 4,
                                   plan_heads: int | None = None):
    """Fused flash decode over the dense grouped segment.

    q (B, Hkv, Qh, d) fp32, ALREADY scaled; codes (B, Hkv, G, g, P) uint8;
    stats (B, Hkv, G, 1, P) fp32; values (B, Hkv, G*g, d) bf16/fp32
    token-major rows, or uint8 codes with fp32 vscale/vzero
    (B, Hkv, G*g, 1); length (B,) int32 valid grouped tokens per row.
    Returns (acc (B,Hkv,Qh,d), m (B,Hkv,Qh), l (B,Hkv,Qh)) fp32. The kernel
    for CUDA tensors, the plain version for CPU tensors, outputs of the
    kernel's shapes for meta tensors. ``plan_heads``:
    plan the splits as for that many kv heads (a head shard passes the
    model's, so that each head is summed in the same splits as in the
    whole call)."""
    tensors = (q, codes, rs, rz, ts, tz, values, length)
    quant = tuple(x for x in (vscale, vzero) if x is not None)
    where = B.route(*tensors, *quant)
    with cost_hook.kernel_call("polar_attention", lambda: work(
            q, codes, values, t_bits=t_bits)):
        if where == "cpu":
            return polar_decode_attention_grouped_plain(
                q, codes, rs, rz, ts, tz, values, length, vscale=vscale,
                vzero=vzero, r_bits=r_bits, t_bits=t_bits)
        return _launch(q, codes, rs, rz, ts, tz, values, length, vscale,
                       vzero, r_bits, t_bits, plan_heads, where)


def work(q, codes, values, *, t_bits: int = 4) -> W.Work:
    """One call's work from the shapes (``kernels/work.py``): every group
    of the buffer walked (``length`` is data)."""
    b, hkv, qh, d = q.shape
    gc, g = codes.shape[2], codes.shape[3]
    return W.dense_decode(b * hkv * gc, b=b, hkv=hkv, qh=qh, d=d, g=g,
                          value_elt=values.element_size(), t_bits=t_bits)


def _launch(q, codes, rs, rz, ts, tz, values, length, vscale, vzero, r_bits,
            t_bits, plan_heads, where):
    global launches, launches_u8, launches_split
    b, hkv, qh, d = q.shape
    B.require(codes.dim() == 5, "codes must be (B, Hkv, G, g, d/2)")
    _, _, gc, g, p = codes.shape
    B.require(q.dtype == torch.float32 and q.is_contiguous(),
              "q must be contiguous float32 (B, Hkv, Qh, d)")
    B.require(codes.dtype == torch.uint8 and codes.is_contiguous()
              and tuple(codes.shape[:2]) == (b, hkv) and p * 2 == d,
              "codes must be contiguous uint8 (B, Hkv, G, g, d/2)")
    for st in (rs, rz, ts, tz):
        B.require(st.dtype == torch.float32 and st.is_contiguous()
                  and tuple(st.shape) == (b, hkv, gc, 1, p),
                  "stats must be contiguous float32 (B, Hkv, G, 1, d/2)")
    v_kind, vs_ptr, vz_ptr = B.value_rows(values, vscale, vzero,
                                          (b, hkv, gc * g, d))
    B.require(length.dtype == torch.int32 and length.is_contiguous()
              and tuple(length.shape) == (b,), "length must be int32 (B,)")
    B.require(r_bits + t_bits <= 8, "r_bits + t_bits must fit one byte")
    acc = torch.empty((b, hkv, qh, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, qh), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hkv, qh), dtype=torch.float32, device=q.device)
    if where == "meta":
        return acc, m, l
    nsplit = plan_splits(b, plan_heads or hkv, gc)
    # the splits' (acc, m, l) partials, merged on the device
    part = torch.empty(nsplit * b * hkv * qh * (d + 2), dtype=torch.float32,
                       device=q.device) if nsplit > 1 else None
    split_body = B.INT(0)
    lib = B.library("polar_attention", _bind)
    err = lib.polar_attention_launch(
        q.data_ptr(), codes.data_ptr(), rs.data_ptr(), rz.data_ptr(),
        ts.data_ptr(), tz.data_ptr(), values.data_ptr(), v_kind, vs_ptr,
        vz_ptr, length.data_ptr(),
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hkv, qh, d, gc, g,
        t_bits, nsplit, None if part is None else part.data_ptr(),
        ctypes.byref(split_body), B.stream_ptr(q))
    B.check(err, "polar_attention")
    launches += 1
    launches_u8 += int(values.dtype == torch.uint8)
    launches_split += split_body.value
    return acc, m, l
