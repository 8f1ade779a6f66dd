"""Dense quantized KV cache over pluggable key codecs (port of
``repro/core/kv_cache.py``).

The cache owns placement and the method-agnostic machinery; the resolved
:class:`~repro_torch.core.codecs.KeyCodec` owns buffer shapes,
encode/decode and the score path. Buffers:

* grouped codecs (polar, kivi, zipcache): ``key_codes`` (B, Hkv, G, g, ·)
  uint8, ``key_scales`` per-group stat arrays, ``key_residual``
  (B, Hkv, g, d) in ``cfg.residual_dtype`` — the tokens of the
  not-yet-full group;
* token-wise codecs (int, the fp passthrough ``"none"``): ``key_codes``
  (B, Hkv, T, ·) and per-token ``key_scales`` (``{}`` for ``"none"``);
* values, token-major: ``value_fp`` (B, Hkv, T, d) in the model dtype,
  or, under ``cfg.value_bits > 0``, ``value_codes`` (B, Hkv, T, d) uint8
  mid-tread codes with one ``value_scale`` / ``value_zero`` (B, Hkv, T, 1)
  in ``cfg.scale_dtype`` per (token, kv head) row; the other form is
  ``None``.

``flushed = (length // g) * g`` tokens live in quantized groups; positions
``[flushed, length)`` live in the residual at row ``pos % g`` (which is
why ``max_len`` is a multiple of g).

**Layouts.** A :class:`~repro_torch.core.cache_layout.LinearLayout` keeps
position ``pos`` at slot ``pos`` (``length <= max_len``). A
:class:`~repro_torch.core.cache_layout.RingLayout` (local attention,
capacity == window rounded up to g) keeps it at slot ``pos % max_len`` and
key group ``n`` at group slot ``n % (max_len / g)``; ``length`` keeps
counting absolute positions, and :func:`position_masks` recovers each
slot's position.

**Lengths.** ``length`` is an int32 tensor on the cache's device: ``()``
for a lock-step batch (the static engine), ``(B,)`` for gathered paged
views where every slot sits at its own position. A ``()`` cache also keeps
its value on the host (``host_length``): :func:`append` decides the group
flush from it, so a decode step never waits for the device (JAX's
``lax.cond`` flush).

**In-place updates.** JAX's functions return new caches; here
:func:`prefill` and :func:`append` write the buffers and the length in
place and return the same cache object.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import quantizers as qz
from repro_torch.core.cache_layout import LinearLayout, ring_segments
from repro_torch.core.quantizers import QuantConfig
from repro_torch.utils import resolve_device, torch_dtype

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    key_codes: torch.Tensor          # codec codes (fp keys for "none")
    key_scales: dict                 # codec stat arrays (may be {})
    key_residual: Optional[torch.Tensor]   # grouped codecs only
    value_codes: Optional[torch.Tensor]    # (B, Hkv, T, d) uint8
    value_scale: Optional[torch.Tensor]    # (B, Hkv, T, 1)
    value_zero: Optional[torch.Tensor]     # (B, Hkv, T, 1)
    value_fp: Optional[torch.Tensor]       # (B, Hkv, T, d)
    length: torch.Tensor             # () or (B,) int32
    cfg: QuantConfig
    max_len: int
    layout: object                   # LinearLayout | RingLayout
    host_length: Optional[int] = None   # the host's copy of a () length

    @property
    def num_kv_heads(self) -> int:
        return self.key_codes.shape[1]

    @property
    def head_dim(self) -> int:
        return value_buffers(self)[0].shape[-1]

    @property
    def codec(self):
        return self.cfg.codec

    @property
    def grouped(self) -> bool:
        return self.cfg.codec.grouped


def init_cache(cfg: QuantConfig, batch: int, num_kv_heads: int,
               head_dim: int, max_len: int, dtype=torch.bfloat16,
               device=None, layout=None) -> KVCache:
    """Allocate an empty cache of ``max_len`` tokens on ``device`` (the
    card unless named); ``layout`` places them (default: linear)."""
    device = resolve_device(device)
    b, h, d = batch, num_kv_heads, head_dim
    codec = cfg.codec
    key_codes, key_scales = codec.init_buffers(cfg, (b, h), max_len, d,
                                               dtype, device)
    key_residual = None
    if codec.grouped:
        key_residual = torch.zeros((b, h, cfg.group_size, d),
                                   dtype=torch_dtype(cfg.residual_dtype),
                                   device=device)
    return KVCache(
        key_codes=key_codes, key_scales=key_scales,
        key_residual=key_residual,
        **init_values(cfg, (b, h, max_len), d, dtype, device),
        length=torch.zeros((), dtype=torch.int32, device=device), cfg=cfg,
        max_len=max_len,
        layout=layout if layout is not None else LinearLayout(max_len),
        host_length=0)


def init_values(cfg: QuantConfig, lead: tuple, head_dim: int, dtype,
                device) -> dict:
    """Zeroed value buffers of token-major shape ``(*lead, head_dim)``:
    uint8 codes + (…, 1) scale and zero under ``cfg.value_bits > 0``, else
    fp rows in ``dtype``; as the four ``value_*`` fields."""
    if not cfg.value_bits:
        return {"value_codes": None, "value_scale": None, "value_zero": None,
                "value_fp": torch.zeros((*lead, head_dim), dtype=dtype,
                                        device=device)}
    sdt = torch_dtype(cfg.scale_dtype)
    return {"value_codes": torch.zeros((*lead, head_dim), dtype=torch.uint8,
                                       device=device),
            "value_scale": torch.zeros((*lead, 1), dtype=sdt, device=device),
            "value_zero": torch.zeros((*lead, 1), dtype=sdt, device=device),
            "value_fp": None}


def value_buffers(cache):
    """(values, vscale, vzero) of a dense or paged cache: the uint8 codes
    with their row scale and zero, or the fp rows with ``None, None``."""
    if cache.value_codes is not None:
        return cache.value_codes, cache.value_scale, cache.value_zero
    return cache.value_fp, None, None


def value_fields(cfg: QuantConfig, v: torch.Tensor) -> dict:
    """What the value buffers store for rows ``v`` (…, T, d) under
    ``cfg``: ``{"value_fp": v}``, or the token-wise mid-tread encode
    ``{"value_codes", "value_scale", "value_zero"}``."""
    if not cfg.value_bits:
        return {"value_fp": v}
    qv = qz.encode_values(v, cfg.value_bits, cfg.scale_dtype)
    return {"value_codes": qv.codes, "value_scale": qv.scale,
            "value_zero": qv.zero}


def dequant_rows(values: torch.Tensor, vscale=None,
                 vzero=None) -> torch.Tensor:
    """fp32 value rows: uint8 mid-tread codes · ``vscale`` + ``vzero`` (one
    per row, last dim 1), or the fp rows cast when ``vscale`` is None."""
    if vscale is None:
        return values.float()
    return qz.affine_decode(values, vscale, vzero, "midtread")


def append(cache: KVCache, k_new: torch.Tensor,
           v_new: torch.Tensor) -> KVCache:
    """Append one token to every row, in place. k_new/v_new: (B, Hkv, 1, d)
    post-RoPE. Token-major rows go to slot ``layout.token_slot(pos)``. A
    grouped codec writes the key to residual row ``pos % g`` and, when that
    completes the group, encodes the residual into group slot
    ``layout.group_slot(pos // g)`` (one encode launch, decided on the
    host from the absolute position)."""
    cfg = cache.cfg
    codec = cache.codec
    lay = cache.layout
    pos = cache.host_length
    if pos is None:
        raise ValueError("append needs a lock-step () length")
    if isinstance(lay, LinearLayout) and pos >= cache.max_len:
        raise ValueError(f"linear cache of capacity {cache.max_len} is full")
    slot = lay.token_slot(pos)
    for key, rows in value_fields(cfg, v_new).items():
        buf = getattr(cache, key)
        buf[:, :, slot] = rows[:, :, 0].to(buf.dtype)
    if not codec.grouped:
        codes, scales = codec.encode(cfg, k_new)
        cache.key_codes[:, :, slot] = codes[:, :, 0].to(
            cache.key_codes.dtype)
        for key, buf in cache.key_scales.items():
            buf[:, :, slot] = scales[key][:, :, 0].to(buf.dtype)
    else:
        g = cfg.group_size
        res = cache.key_residual
        res[:, :, pos % g] = k_new[:, :, 0].to(res.dtype)
        if pos % g == g - 1:
            # res (B,H,g,d) -> codes (B,H,1,g,·) / scales (B,H,1,1,·)
            codes, scales = codec.encode(cfg, res)
            gidx = lay.group_slot(pos // g, cache.key_codes.shape[2])
            cache.key_codes[:, :, gidx] = codes[:, :, 0]
            for key, buf in cache.key_scales.items():
                buf[:, :, gidx] = scales[key][:, :, 0].to(buf.dtype)
    cache.length += 1
    cache.host_length = pos + 1
    return cache


def prefill(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> KVCache:
    """Fill an empty cache with ``T`` tokens at once, in place.
    k/v: (B, Hkv, T, d) post-RoPE.

    A linear cache takes ``T <= max_len``. A ring cache takes any T: only
    the last ``max_len`` tokens are stored token-major at slots
    ``pos % max_len``, and of the key groups (absolute-aligned) the last
    ``max_len / g``; the few grouped keys older than the window are masked
    out at attention time (:func:`position_masks`)."""
    cfg = cache.cfg
    codec = cache.codec
    lay = cache.layout
    t = k.shape[2]
    off = lay.prefill_offset(t)    # tokens before `off` fall out of the ring
    segs = lay.copy_segments(t)

    def write_tok(buf, src):
        for lo, hi, dst in segs:
            buf[:, :, dst:dst + (hi - lo)] = src[:, :, lo - off:hi - off].to(
                buf.dtype)

    for key, rows in value_fields(cfg, v[:, :, off:]).items():
        write_tok(getattr(cache, key), rows)
    if not codec.grouped:
        codes, scales = codec.encode(cfg, k[:, :, off:])
        write_tok(cache.key_codes, codes)
        for key, buf in cache.key_scales.items():
            write_tok(buf, scales[key])
    else:
        g = cfg.group_size
        nfull = t // g
        goff = max(0, nfull - cache.max_len // g)   # group ring offset
        rem = t - nfull * g
        # round through the residual dtype so bulk prefill and token-by-
        # token append produce bit-identical codes (streaming parity)
        k_rdt = k[:, :, goff * g:].to(torch_dtype(cfg.residual_dtype))
        if nfull > goff:
            codes, scales = codec.encode(cfg, k_rdt[:, :, :(nfull - goff) * g])
            for lo, hi, dst in ring_segments(nfull, cache.max_len // g):
                n = hi - lo
                cache.key_codes[:, :, dst:dst + n] = \
                    codes[:, :, lo - goff:hi - goff]
                for key, buf in cache.key_scales.items():
                    buf[:, :, dst:dst + n] = \
                        scales[key][:, :, lo - goff:hi - goff].to(buf.dtype)
        if rem:
            cache.key_residual[:, :, :rem] = k_rdt[:, :, (nfull - goff) * g:]
    cache.length.fill_(t)
    cache.host_length = t
    return cache


def key_scores(cache: KVCache, q: torch.Tensor) -> torch.Tensor:
    """Scores of q (B, Hkv, Qh, d) against all stored keys through the
    codec's score path -> (B, Hkv, Qh, max_len)."""
    return cache.codec.scores(cache.cfg, q, cache.key_codes,
                              cache.key_scales)


def position_masks(t_cap: int, g: int, length: torch.Tensor,
                   window: int = 0):
    """Validity masks over the buffer slots.

    ``window == 0``: a linear cache, slot == position. ``window > 0``: ring
    semantics (capacity == window): slot ``i`` of the token-major value
    buffer holds position ``i + floor((length-1-i)/t_cap)*t_cap``, key-group
    slots wrap by ``flushed`` instead, and a grouped key older than
    ``length - window`` is invalid. A slot's key expires from the window
    exactly when its value slot is overwritten, so grouped validity and
    residual membership never overlap.

    ``length`` is () — one shared length — or (B,) per-row lengths.
    Returns (valid_grouped, in_residual, flushed): (t_cap,) bools and a
    () flushed count, or (B, t_cap) bools and (B,) for per-row lengths."""
    i = torch.arange(t_cap, dtype=torch.int32, device=length.device)
    flushed = (length // g) * g
    fl, ln = flushed, length
    if length.dim():
        i, fl, ln = i[None, :], flushed[:, None], length[:, None]
    if window <= 0:
        return i < fl, (i >= fl) & (i < ln), flushed
    abs_k = i + torch.div(fl - 1 - i, t_cap, rounding_mode="floor") * t_cap
    abs_v = i + torch.div(ln - 1 - i, t_cap, rounding_mode="floor") * t_cap
    valid_g = (abs_k >= 0) & (abs_k < fl) & (abs_k >= ln - window)
    in_res = (abs_v >= fl) & (abs_v < ln)
    return valid_g, in_res, flushed


def decode_attention(cache: KVCache, q: torch.Tensor,
                     scale: float | None = None,
                     window: int = 0) -> torch.Tensor:
    """Single-step attention of q (B, Hq, d) over the cache: masked softmax
    over the codec's scores (the score-only LUT kernel for polar) and the
    fp residual's, then p @ V. GQA folds query heads onto their kv head.
    ``window > 0`` applies ring-buffer local-attention semantics (capacity
    == window). Returns (B, Hq, d) in q.dtype."""
    cfg = cache.cfg
    b, hq, d = q.shape
    hkv = cache.num_kv_heads
    qpk = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    q4 = (q.float() * scale).reshape(b, hkv, qpk, d)
    t_cap = cache.max_len
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)

    def bc(mask):  # (T,) or (B,T) -> broadcastable against (B,Hkv,Qh,T)
        return mask if mask.dim() == 1 else mask[:, None, None, :]

    if cache.grouped:
        g = cfg.group_size
        valid_g, in_res, _ = position_masks(t_cap, g, cache.length, window)
        s_grouped = key_scores(cache, q4)                        # (B,H,Qh,T)
        res = cache.key_residual.float()                         # (B,H,g,d)
        s_res = torch.einsum("bhqd,bhgd->bhqg", q4, res)
        s_res_tiled = s_res.repeat(1, 1, 1, t_cap // g)          # slot % g
        scores = torch.where(bc(in_res), s_res_tiled,
                             torch.where(bc(valid_g), s_grouped, neg))
    else:
        valid_g, in_res, _ = position_masks(t_cap, 1, cache.length, window)
        scores = torch.where(bc(valid_g | in_res), key_scores(cache, q4),
                             neg)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqt,bhtd->bhqd", probs,
                       dequant_rows(*value_buffers(cache)))
    return out.reshape(b, hq, d).to(q.dtype)


def fused_decode_attention(cache: KVCache, q: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """Single-step decode attention through the codec's fused flash-decode
    kernel (polar: :func:`repro_torch.kernels.ops.
    polar_decode_attention_full`): LUT scores over the quantized groups
    fused with the value matmul, merged exactly with the fp residual.
    Equal to :func:`decode_attention` on a linear cache; ``cache.length``
    may be () or (B,). A ring cache is refused: it wraps, and the kernel's
    ``pos < flushed`` mask would validate overwritten slots."""
    if not cache.codec.supports_fused_decode:
        raise ValueError("fused decode path requires a codec with a fused "
                         f"kernel, got {cache.codec.name!r}")
    if not isinstance(cache.layout, LinearLayout):
        raise ValueError("fused decode path requires a linear layout")
    return cache.codec.fused_decode(cache, q, scale=scale)


def cache_logical_bits(cache: KVCache) -> float:
    """Logical bits per key element of this cache's policy (the paper's
    accounting)."""
    return cache.cfg.key_bits_per_element(cache.head_dim)
