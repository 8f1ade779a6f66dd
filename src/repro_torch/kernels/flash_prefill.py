"""Causal GQA flash attention for whole-prompt prefill: hand-written CUDA
kernel + its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_prefill.py::
flash_prefill``; the JAX serving path computes the same function with the
jnp ``core/attention.flash_attention`` (``models/attn_block.py:161``), and
the port puts this kernel at that spot. Source: ``csrc/flash_prefill.cu``.

One block per (q tile, head, batch row): Q tile, K/V tile, score tile and
softmax carry in shared memory, output accumulator in registers, the k
loop stopped at the causal bound, an l == 0 guard. Bound: operations
(quadratic in the prompt against linear bytes); this first version uses
fp32 FMAs, not the tensor cores. Its yardstick is
``torch.nn.functional.scaled_dot_product_attention``, which the port never
calls.
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import reference_attention
from repro_torch.kernels import _build as B

#: kernel launches since the last reset (CPU calls never count)
launches = 0


def _bind(lib) -> None:
    lib.flash_prefill_launch.argtypes = [
        B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT, B.INT, B.INT, B.INT, B.INT,
        B.INT, B.INT, B.FLOAT, B.INT, B.VOIDP]
    lib.flash_prefill_launch.restype = B.INT


def flash_prefill_plain(q, k, v, *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """Plain version: O(T^2) reference attention."""
    return reference_attention(q, k, v, mode="causal" if causal else "full",
                               scale=scale)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """q (B, H, Tq, d); k/v (B, Hkv, Tk, d) -> (B, H, Tq, d) in q.dtype.
    The kernel for CUDA tensors, the plain version for CPU tensors."""
    global launches
    if not B.on_card(q, k, v):
        return flash_prefill_plain(q, k, v, causal=causal, scale=scale)
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    for x in (q, k, v):
        B.require(x.is_contiguous() and x.dtype == q.dtype
                  and x.dtype in (torch.float32, torch.bfloat16),
                  "q/k/v must be contiguous and all bf16 or all fp32")
    B.require(tuple(k.shape) == (b, hkv, tk, d) and k.shape == v.shape
              and h % hkv == 0, "k/v must be (B, Hkv, Tk, d), H % Hkv == 0")
    B.require(d in (32, 64, 128), f"head_dim {d} not in (32, 64, 128)")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lib = B.library("flash_prefill", _bind)
    err = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, hkv, tq, tk, d, float(scale),
        int(causal), B.stream_ptr(q))
    B.check(err, "flash_prefill")
    launches += 1
    return out
