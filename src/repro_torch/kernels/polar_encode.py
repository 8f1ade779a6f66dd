"""Polar group encode: hand-written CUDA kernel + its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/polar_encode.py::
polar_encode`` (and, on the serving path, the jnp ``encode_polar_keys`` +
page scatter of ``repro/core/paged_cache.py``). Source:
``csrc/polar_encode.cu``.

Per (row, kv head, group) it computes rho/theta over the "half" pairs,
the per-pair min/max over the group's g tokens, and the packed mid-rise
codes plus four stat rows. Bound: bytes (read g*d keys, write g*d/2 code
bytes and 4*d/2 stats per group). The kernel reads each key once: a group's
tokens are split across the blocks of a thread block cluster (4 on one
group), a thread keeps its tokens' rho/theta (4 pairs of a token) in
registers from the vector loads to the code write, and the blocks combine
their per-pair min/max through distributed shared memory.

Two wrappers share the kernel: :func:`polar_encode` (dense outputs, the
``ops.polar_encode`` form) and :func:`polar_encode_pages` (codes and
stats written straight into page-pool pages — the serving form; a decode
step passes every slot's residual group and skips the slots that do not
flush).

``fixed=True`` is the fixed angle grid (``QuantConfig(theta_stats=
"fixed")``, JAX ``quantizers.py:181-188``, which JAX's Pallas encode does
not have): the kernel reduces only the rho rows, writes the constant
``theta_scale = 2pi / 2^t`` (float32) and ``theta_zero = 0``, and codes
the angle as ``clip(floor(theta / theta_scale), 0, 2^t - 1)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizers import (
    QuantConfig, encode_polar_keys, fixed_theta_step,
)
from repro_torch.kernels import _build as B
from repro_torch.kernels import work as W
from repro_torch import cost_hook

#: kernel launches since the last reset (CPU calls never count)
launches = 0
#: of which on the fixed angle grid
launches_fixed = 0


def _bind(lib) -> None:
    lib.polar_encode_launch.argtypes = [
        B.VOIDP, B.INT, B.LLONG, B.LLONG, B.LLONG, B.LLONG, B.INT, B.INT,
        B.INT, B.INT, B.INT, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP,
        B.VOIDP, B.INT, B.INT, B.INT, B.FLOAT, B.VOIDP]
    lib.polar_encode_launch.restype = B.INT


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def polar_encode_plain(k: torch.Tensor, *, r_bits: int = 4, t_bits: int = 4,
                       group_size: int = 128, fixed: bool = False):
    """k (B, Hkv, T, d), T % g == 0 -> (codes (B,Hkv,G,g,P) uint8, rho_scale,
    rho_zero, theta_scale, theta_zero (B,Hkv,G,1,P) fp32)."""
    cfg = QuantConfig(rho_bits=r_bits, theta_bits=t_bits,
                      group_size=group_size,
                      theta_stats="fixed" if fixed else "group")
    pk = encode_polar_keys(k, cfg)
    return pk.codes, pk.rho_scale, pk.rho_zero, pk.theta_scale, pk.theta_zero


def polar_encode_pages_plain(k, pages, codes, rs, rz, ts, tz, *,
                             r_bits: int = 4, t_bits: int = 4,
                             fixed: bool = False) -> None:
    """Encode k (B, Hkv, G*g, d) and write group (b, n) into pool page
    ``pages[b, n]`` of codes (PP, Hkv, g, P) / stats (PP, Hkv, 1, P), in
    place; negative page ids skip their group."""
    g = codes.shape[2]
    out = polar_encode_plain(k, r_bits=r_bits, t_bits=t_bits, group_size=g,
                             fixed=fixed)
    keep = (pages >= 0).reshape(-1)
    idx = pages.reshape(-1)[keep].long()
    for pool, x in zip((codes, rs, rz, ts, tz), out):
        # (B, H, G, a, b) -> (B*G, H, a, b): one entry per (row, group)
        flat = x.transpose(1, 2).reshape(-1, *x.shape[1:2], *x.shape[3:])
        pool.index_copy_(0, idx, flat[keep])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_keys(k: torch.Tensor, g: int) -> None:
    B.require(k.dim() == 4, f"keys must be (B, H, T, d), got {tuple(k.shape)}")
    B.require(k.dtype in (torch.float32, torch.bfloat16),
              f"keys must be float32 or bfloat16, got {k.dtype}")
    B.require(k.shape[2] % g == 0, f"token count {k.shape[2]} not a multiple "
              f"of the group size {g}")
    B.require(k.stride(3) == 1 and k.stride(2) == k.shape[3],
              "keys need contiguous (token, channel) rows")


def _launch(k, pages, outs, *, g, r_bits, t_bits, fixed) -> None:
    global launches, launches_fixed
    lib = B.library("polar_encode", _bind)
    b, h, t, d = k.shape
    err = lib.polar_encode_launch(
        k.data_ptr(), int(k.dtype == torch.bfloat16), k.stride(0),
        k.stride(1), g * k.stride(2), k.stride(2), b, h, t // g, g, d,
        pages.data_ptr() if pages is not None else None,
        *(o.data_ptr() for o in outs), r_bits, t_bits, int(fixed),
        fixed_theta_step(t_bits), B.stream_ptr(k))
    B.check(err, "polar_encode")
    launches += 1
    launches_fixed += int(fixed)


def work(k: torch.Tensor, g: int, *, pages: int = 0,
         fixed: bool = False) -> W.Work:
    """One call's work from the shapes (``kernels/work.py``): every group
    of ``k`` (B, Hkv, T, d), a skipped page's too (the page ids are
    data)."""
    b, h, t, d = k.shape
    return W.encode(b * t, h, d, g, pages=pages,
                    key_bytes=k.element_size(), fixed=fixed)


def polar_encode(k: torch.Tensor, *, r_bits: int = 4, t_bits: int = 4,
                 group_size: int = 128, fixed: bool = False):
    """Dense encode of k (B, Hkv, T, d): the kernel for a CUDA tensor, the
    plain version for a CPU tensor, outputs of the kernel's shapes for a
    meta tensor. Same outputs as :func:`polar_encode_plain`."""
    where = B.route(k)
    with cost_hook.kernel_call("polar_encode", lambda: work(
            k, group_size, fixed=fixed)):
        if where == "cpu":
            return polar_encode_plain(k, r_bits=r_bits, t_bits=t_bits,
                                      group_size=group_size, fixed=fixed)
        g = group_size
        _check_keys(k, g)
        b, h, t, d = k.shape
        p = d // 2
        codes = torch.empty((b, h, t // g, g, p), dtype=torch.uint8,
                            device=k.device)
        stats = [torch.empty((b, h, t // g, 1, p), dtype=torch.float32,
                             device=k.device) for _ in range(4)]
        if where == "cuda":
            _launch(k, None, (codes, *stats), g=g, r_bits=r_bits,
                    t_bits=t_bits, fixed=fixed)
        return (codes, *stats)


def polar_encode_pages(k: torch.Tensor, pages: torch.Tensor,
                       codes: torch.Tensor, rs: torch.Tensor,
                       rz: torch.Tensor, ts: torch.Tensor, tz: torch.Tensor,
                       *, r_bits: int = 4, t_bits: int = 4,
                       fixed: bool = False) -> None:
    """Paged encode, in place: group (b, n) of k (B, Hkv, G*g, d) goes to
    pool page ``pages[b, n]`` (pages (B, G) int32; < 0 skips). The kernel
    for CUDA tensors, the plain version for CPU tensors; meta tensors are
    checked and left as they are (the pools are written in place)."""
    where = B.route(k, pages, codes, rs, rz, ts, tz)
    with cost_hook.kernel_call("polar_encode", lambda: work(
            k, codes.shape[2], pages=pages.numel(), fixed=fixed)):
        if where == "cpu":
            polar_encode_pages_plain(k, pages, codes, rs, rz, ts, tz,
                                     r_bits=r_bits, t_bits=t_bits,
                                     fixed=fixed)
            return
        g = codes.shape[2]
        _check_keys(k, g)
        b, h, t, d = k.shape
        B.require(pages.dtype == torch.int32 and pages.is_contiguous()
                  and tuple(pages.shape) == (b, t // g),
                  f"pages must be contiguous int32 {(b, t // g)}")
        B.require(codes.dtype == torch.uint8 and codes.is_contiguous()
                  and codes.shape[1:] == (h, g, d // 2),
                  "codes pool must be contiguous uint8 (PP, Hkv, g, d/2)")
        for s in (rs, rz, ts, tz):
            B.require(s.dtype == torch.float32 and s.is_contiguous()
                      and s.shape[1:] == (h, 1, d // 2),
                      "stat pools must be contiguous float32 "
                      "(PP, Hkv, 1, d/2)")
        if where == "cuda":
            _launch(k, pages, (codes, rs, rz, ts, tz), g=g, r_bits=r_bits,
                    t_bits=t_bits, fixed=fixed)
