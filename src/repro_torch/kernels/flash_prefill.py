"""GQA flash attention for whole-prompt prefill: hand-written CUDA kernel
+ its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_prefill.py::
flash_prefill``; the JAX serving path computes the same function with the
jnp ``core/attention.flash_attention`` (``models/attn_block.py:161``), and
the port puts this kernel at that spot. Source: ``csrc/flash_prefill.cu``.

Bound: operations (quadratic in the prompt against linear bytes). bf16
inputs run a FlashAttention-2 style tensor-core body: one block of 4 warps
per (64-row q tile, head, batch row), Q in registers, 64-key K/V tiles
double-buffered through ``cp.async``, ``mma.sync`` bf16 products with fp32
accumulators, the online softmax in registers, heaviest q tiles first
(at d 256 the Q fragments are reread from shared memory each key tile
instead of living in registers). fp32 inputs (held to 1e-4, which TF32
would not meet) and bf16 pointers that are not 16-byte aligned run the
fp32-FMA body. Head dims 32, 64, 128 and 256.

Mask modes (``core/attention.py``): ``causal``, ``full``, ``prefix``
(bidirectional over the first ``prefix_len[b]`` keys of row b, causal
after; PaliGemma) and ``local`` (keys ``i - window < j <= i``;
RecurrentGemma). Both bodies walk only the key tiles the mode can reach:
up to the diagonal (causal, local), or to ``max(diagonal, prefix_len)``
(prefix), and from the window's first tile on (local, so a local prefill
is O(T·window)); a row whose every key is masked ends with l == 0 and is
written as zeros. Its yardstick is
``torch.nn.functional.scaled_dot_product_attention``, which the port never
calls.

``return_lse=True`` also returns each row's log-sum-exp of its scaled
scores, fp32 (B, H, Tq): the forward of the training path's
differentiable ``core/attention.flash_attention``, whose backward needs
it. The serving calls pass no ``lse`` buffer and keep their bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.attention import (MASK_MODES, flash_forward,
                                        reference_attention)
from repro_torch.kernels import _build as B
from repro_torch.kernels import work as W
from repro_torch import cost_hook

#: kernel launches since the last reset (CPU calls never count)
launches = 0
#: of those, the serving launches in mode ``full`` (the encoder-decoder's
#: encoder and cross-attention)
launches_full = 0
#: of those, the launches that also wrote the log-sum-exp (the training
#: path's forward, any mode); apart from ``launches_full``
launches_lse = 0


def _bind(lib) -> None:
    lib.flash_prefill_launch.argtypes = [
        B.VOIDP, B.VOIDP, B.VOIDP, B.VOIDP, B.INT, B.INT, B.INT, B.INT, B.INT,
        B.INT, B.INT, B.FLOAT, B.INT, B.INT, B.VOIDP, B.VOIDP, B.VOIDP]
    lib.flash_prefill_launch.restype = B.INT


def flash_prefill_plain(q, k, v, *, mode: str = "causal", window: int = 0,
                        prefix_len=None, scale: float | None = None,
                        return_lse: bool = False):
    """Plain version: O(T^2) reference attention; with ``return_lse``
    the chunked online-softmax forward (``flash_forward``), which returns
    (out, lse)."""
    if return_lse:
        return flash_forward(q, k, v, mode=mode, window=window, scale=scale,
                             prefix_len=prefix_len)
    return reference_attention(q, k, v, mode=mode, window=window,
                               prefix_len=prefix_len, scale=scale)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  mode: str = "causal", window: int = 0,
                  prefix_len: torch.Tensor | None = None,
                  scale: float | None = None, return_lse: bool = False):
    """q (B, H, Tq, d); k/v (B, Hkv, Tk, d) -> (B, H, Tq, d) in q.dtype;
    ``mode`` one of ``MASK_MODES``, ``prefix_len`` (B,) int32 for
    ``prefix``, ``window`` > 0 for ``local``; ``return_lse``: (out, lse
    (B, H, Tq) fp32). The kernel for CUDA tensors, the plain version for
    CPU tensors, outputs of the kernel's shapes for meta tensors; the
    call's :func:`work` goes to the dry run's counter
    (``launch/op_cost.py``)."""
    B.require(mode in MASK_MODES, f"unknown mask mode {mode!r}")
    B.require((prefix_len is not None) == (mode == "prefix"),
              "prefix_len is required by, and only by, mode 'prefix'")
    B.require(mode != "local" or window > 0, "mode 'local' needs window > 0")
    tensors = (q, k, v) + ((prefix_len,) if prefix_len is not None else ())
    where = B.route(*tensors)
    with cost_hook.kernel_call("flash_prefill", lambda: work(
            q, k, mode=mode, window=window, return_lse=return_lse)):
        if where == "cpu":
            return flash_prefill_plain(q, k, v, mode=mode, window=window,
                                       prefix_len=prefix_len, scale=scale,
                                       return_lse=return_lse)
        return _launch(q, k, v, mode, window, prefix_len, scale, return_lse,
                       where)


def work(q, k, *, mode: str = "causal", window: int = 0,
         return_lse: bool = False) -> W.Work:
    """One call's work from the shapes (``kernels/work.py``): the visible
    pairs of ``mode`` (``prefix`` counted as causal)."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    pairs = b * W.visible_pairs(mode, tq, tk, window)
    return W.flash_prefill(b, h, hkv, tq, tk, d, pairs,
                           elt=q.element_size(), lse=return_lse)


def _launch(q, k, v, mode, window, prefix_len, scale, return_lse, where):
    global launches, launches_full, launches_lse
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    for x in (q, k, v):
        B.require(x.is_contiguous() and x.dtype == q.dtype
                  and x.dtype in (torch.float32, torch.bfloat16),
                  "q/k/v must be contiguous and all bf16 or all fp32")
    B.require(tuple(k.shape) == (b, hkv, tk, d) and k.shape == v.shape
              and h % hkv == 0, "k/v must be (B, Hkv, Tk, d), H % Hkv == 0")
    B.require(d in (32, 64, 128, 256),
              f"head_dim {d} not in (32, 64, 128, 256)")
    if prefix_len is not None:
        B.require(prefix_len.dtype == torch.int32
                  and prefix_len.is_contiguous()
                  and tuple(prefix_len.shape) == (b,),
                  "prefix_len must be contiguous int32 (B,)")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if where == "meta":
        return (out, lse) if return_lse else out
    lib = B.library("flash_prefill", _bind)
    err = lib.flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, hkv, tq, tk, d, float(scale),
        MASK_MODES.index(mode), int(window),
        None if prefix_len is None else prefix_len.data_ptr(),
        None if lse is None else lse.data_ptr(), B.stream_ptr(q))
    B.check(err, "flash_prefill")
    launches += 1
    launches_full += int(mode == "full" and not return_lse)
    launches_lse += int(return_lse)
    return (out, lse) if return_lse else out
