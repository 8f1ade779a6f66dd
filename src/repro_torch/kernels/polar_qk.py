"""LUT q·K̃ scores over the dense cache, no softmax: hand-written CUDA
kernel + its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/polar_qk.py::
polar_qk_scores`` (the paper's Appendix-A kernel). Source:
``csrc/polar_qk.cu``.

One block per (group, kv head, row): each thread loads its two tokens'
code rows straight into registers, the block builds the group's angle LUT
in shared memory while those loads are in flight, then each thread
dequantizes ρ̃ once per (token, pair), adds one gathered LUT entry per
(query head, token, pair), and lane pairs write four tokens of a head as
one ``float4``. That vector path needs d in (32, 64, 128), t_bits in
(3, 4), g % 4 == 0 and 16-byte aligned codes; other shapes run a generic
one-token-per-thread path. Every position of the ``(B, Hkv, Qh, G*g)`` output is written.

Shared memory grows with the query heads: a block stages q (Qh·d
floats), four stat rows (4·P) and the angle LUT (⌈Qh/4⌉·4·P·2^t floats,
P = d/2), which must fit the 227 KB a block may opt into on an H100. The
wrapper therefore tiles the query heads over launches of at most
:func:`max_rows` heads each — 100 at d 64 and t_bits 4 (one launch up to
a speculative span of Q = 12 at tinyllama's 8 query heads per kv head),
48 at d 128 — and writes each tile's rows into the one output; a shape
whose single-tile LUT does not fit (d 128 at t_bits 8) raises.
Bound: bytes (codes and stats in, fp32 scores out), latency in practice;
the score spill to memory is what the fused decode kernel
(``polar_attention``) removes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import work as W
from repro_torch import cost_hook

#: kernel launches since the last reset (CPU calls never count)
launches = 0

#: shared memory one block may opt into on an H100
SMEM_BYTES = 227 * 1024
#: query heads per thread (``csrc/polar_qk.cu`` kRows): the LUT's head
#: axis is allocated in multiples of it
K_ROWS = 4


def max_rows(d: int, t_bits: int) -> int:
    """The most query heads one launch stages within :data:`SMEM_BYTES`:
    ``rows * d + 4 * P + rows * P * 2**t_bits`` floats, ``rows`` a
    multiple of :data:`K_ROWS` (0 when not even one tile fits)."""
    p = d // 2
    rows = (SMEM_BYTES // 4 - 4 * p) // (d + (p << t_bits))
    return max(rows, 0) // K_ROWS * K_ROWS


def _bind(lib) -> None:
    lib.polar_qk_launch.argtypes = [
        B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT,
        B.INT, B.INT, B.INT, B.INT, B.INT, B.INT, B.VOIDP]
    lib.polar_qk_launch.restype = B.INT


def polar_qk_scores_plain(q, codes, rs, rz, ts, tz, *, r_bits: int = 4,
                          t_bits: int = 4) -> torch.Tensor:
    """Plain version: the gather-form LUT scores
    (``ref.ref_polar_qk_scores``)."""
    return ref_mod.ref_polar_qk_scores(q, codes, rs, rz, ts, tz,
                                       r_bits=r_bits, t_bits=t_bits)


def work(q, codes, *, t_bits: int = 4) -> W.Work:
    """One call's work from the shapes (``kernels/work.py``): every group
    of the buffer is scored."""
    b, hkv, qh, d = q.shape
    gc, g = codes.shape[2], codes.shape[3]
    return W.qk_scores(b * hkv * gc, b=b, hkv=hkv, qh=qh, d=d, g=g,
                       t_bits=t_bits)


def polar_qk_scores(q: torch.Tensor, codes: torch.Tensor, rs: torch.Tensor,
                    rz: torch.Tensor, ts: torch.Tensor, tz: torch.Tensor, *,
                    r_bits: int = 4, t_bits: int = 4) -> torch.Tensor:
    """LUT q·K̃ scores. q (B, Hkv, Qh, d) fp32; codes (B, Hkv, G, g, P)
    uint8; stats (B, Hkv, G, 1, P) fp32. Returns (B, Hkv, Qh, G*g) fp32.
    The kernel for CUDA tensors (one launch per :func:`max_rows` query
    heads), the plain version for CPU tensors, the output's shape for
    meta tensors."""
    where = B.route(q, codes, rs, rz, ts, tz)
    with cost_hook.kernel_call("polar_qk", lambda: work(q, codes,
                                                      t_bits=t_bits)):
        if where == "cpu":
            return polar_qk_scores_plain(q, codes, rs, rz, ts, tz,
                                         r_bits=r_bits, t_bits=t_bits)
        return _launch(q, codes, rs, rz, ts, tz, r_bits, t_bits, where)


def _launch(q, codes, rs, rz, ts, tz, r_bits, t_bits, where):
    global launches
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
    B.require(r_bits + t_bits <= 8, "r_bits + t_bits must fit one byte")
    tile = max_rows(d, t_bits)
    B.require(tile > 0, f"d {d} at t_bits {t_bits}: one tile of {K_ROWS} "
              "query heads exceeds the shared memory")
    out = torch.empty((b, hkv, qh, gc * g), dtype=torch.float32,
                      device=q.device)
    if where == "meta":
        return out
    lib = B.library("polar_qk", _bind)
    for lo in range(0, qh, tile):
        rows = min(tile, qh - lo)
        whole = rows == qh
        qt = q if whole else q[:, :, lo:lo + rows].contiguous()
        ot = out if whole else torch.empty((b, hkv, rows, gc * g),
                                           dtype=torch.float32,
                                           device=q.device)
        err = lib.polar_qk_launch(
            qt.data_ptr(), codes.data_ptr(), rs.data_ptr(), rz.data_ptr(),
            ts.data_ptr(), tz.data_ptr(), ot.data_ptr(), b, hkv, rows, d,
            gc, g, t_bits, B.stream_ptr(q))
        B.check(err, "polar_qk")
        launches += 1
        if not whole:
            out[:, :, lo:lo + rows] = ot
    return out
