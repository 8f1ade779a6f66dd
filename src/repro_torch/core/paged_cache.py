"""Paged quantized KV cache: a shared page pool + per-slot page tables
(port of ``repro/core/paged_cache.py``, the paths of classic
continuous-batching serving).

One page holds exactly one quantization group (``page_size ==
group_size``): its key codes/stats and its ``page_size`` token-major value
rows. Buffer shapes (``PP = num_pages + 1``: the last page is the
masked-write scratch page, ``S`` = slots, ``g`` = page size):

* ``key_codes``    (PP, H, g, P) uint8 page pool
* ``key_scales``   dict of four (PP, H, 1, P) fp32 stat pools
* ``key_residual`` (S, H, g, d) per-slot not-yet-full group
  (``cfg.residual_dtype``)
* ``value_fp``     (PP, H, g, d) token-major value rows (model dtype)
* ``lengths``      (S,) int32 per-slot token counts

Value rows for positions ``[0, len)`` live in pages (row ``pos % g`` of
page ``table[pos // g]``), key codes for ``[0, flushed)`` live in pages,
and keys of the partial group ``[flushed, len)`` live in the residual.

**In-place updates.** The JAX engine donates its state to each jitted
step; here :func:`paged_prefill` and :func:`paged_append` update the pools,
the residual and ``lengths`` in place (``index_copy_``, indexed
assignment) and return the same cache object. Group encodes write codes
and stats straight into their pool pages (one kernel launch); a group
that is not written (padding pages at prefill, non-flushing slots at
decode) is skipped rather than redirected to the scratch page, so only
the never-read scratch page can differ from the JAX cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.cache_layout import PagedLayout
from repro_torch.core.quantizers import QuantConfig
from repro_torch.utils import torch_dtype


@dataclasses.dataclass
class PagedKVCache:
    key_codes: torch.Tensor          # (PP, H, g, P) uint8
    key_scales: dict                 # four (PP, H, 1, P) stat pools
    key_residual: torch.Tensor       # (S, H, g, d)
    value_fp: torch.Tensor           # (PP, H, g, d)
    lengths: torch.Tensor            # (S,) int32
    cfg: QuantConfig
    layout: PagedLayout

    @property
    def codec(self):
        return self.cfg.codec


def init_paged_cache(cfg: QuantConfig, layout: PagedLayout, num_kv_heads: int,
                     head_dim: int, dtype=torch.bfloat16,
                     device="cpu") -> PagedKVCache:
    """Allocate empty page pools for ``layout`` under policy ``cfg``."""
    codec = cfg.codec
    if not codec.grouped or not codec.supports_paged_decode:
        raise ValueError(f"codec {cfg.method!r} has no paged path in this "
                         "port")
    if cfg.value_bits:
        raise ValueError("quantized values come in a later slice of the "
                         "port (value_bits must be 0)")
    if layout.page_size != cfg.group_size:
        raise ValueError(
            f"page_size {layout.page_size} must equal group_size "
            f"{cfg.group_size} (one page == one quantization group)")
    pp, s = layout.pool_pages, layout.slots
    h, d, g = num_kv_heads, head_dim, layout.page_size
    key_codes, key_scales = codec.init_buffers(cfg, (pp, h), g, d, dtype,
                                               device)
    # one group per page: drop the G axis so the pool indexes pages directly
    key_codes = key_codes[:, :, 0].contiguous()
    key_scales = {k: v[:, :, 0].contiguous() for k, v in key_scales.items()}
    return PagedKVCache(
        key_codes=key_codes, key_scales=key_scales,
        key_residual=torch.zeros((s, h, g, d),
                                 dtype=torch_dtype(cfg.residual_dtype),
                                 device=device),
        value_fp=torch.zeros((pp, h, g, d), dtype=dtype, device=device),
        lengths=torch.zeros((s,), dtype=torch.int32, device=device),
        cfg=cfg, layout=layout)


def paged_prefill(cache: PagedKVCache, slot: int, page_row: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, true_len: int,
                  start: int = 0) -> PagedKVCache:
    """Write one request's prompt into its assigned pages, in place.

    k/v: (1, Hkv, Tp, d) post-RoPE, ``Tp`` a bucket length (multiple of
    the page size; the real tokens are the first ``true_len``).
    ``page_row``: (N,) int32 table row of ``slot`` on the cache's device.
    Value rows of every page holding a real token, and the key groups that
    are fully real, go to ``page_row[start // g:]``; the partial group goes
    to the slot's residual (rounded through ``cfg.residual_dtype`` like
    every encoded key, the streaming-parity invariant). The slot length
    becomes ``start + true_len``."""
    cfg = cache.cfg
    g = cache.layout.page_size
    _, h, tp, d = k.shape
    if tp % g:
        raise ValueError(f"bucket length {tp} not a multiple of page {g}")
    if start % g:
        raise ValueError(f"start {start} is not page-aligned")
    nfull = true_len // g                     # fully-real key groups
    ntouch = -(-true_len // g)                # pages holding any real value
    p0 = start // g
    if p0 + ntouch > page_row.shape[0]:
        raise ValueError("prompt overruns the slot's page-table row")

    # --- values: token-major rows of every touched page ---
    if ntouch:
        vp = v[0, :, :ntouch * g].reshape(h, ntouch, g, d).transpose(0, 1)
        cache.value_fp.index_copy_(0, page_row[p0:p0 + ntouch].long(),
                                   vp.to(cache.value_fp.dtype))

    # --- keys: full groups encoded straight into their pages ---
    k_rdt = k.to(torch_dtype(cfg.residual_dtype))
    if nfull:
        pages = page_row[p0:p0 + nfull].to(torch.int32).reshape(1, nfull)
        cache.codec.encode_pages(cfg, k_rdt[:, :, :nfull * g], pages,
                                 cache.key_codes,
                                 cache.key_scales)
    # partial group -> per-slot residual (when true_len % g == 0 this is a
    # stale window; every residual read is masked by lengths and appends
    # overwrite row pos % g before it becomes visible)
    res_lo = min(nfull * g, tp - g)
    cache.key_residual[slot] = k_rdt[0, :, res_lo:res_lo + g].to(
        cache.key_residual.dtype)
    cache.lengths[slot] = start + true_len
    return cache


def paged_append(cache: PagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, page_table: torch.Tensor,
                 active: torch.Tensor) -> PagedKVCache:
    """Append one token per *active* slot, in place. k_new/v_new:
    (S, Hkv, 1, d) post-RoPE; page_table: (S, N) int32 (may be
    width-sliced); active: (S,) bool — all on the cache's device, and no
    host synchronisation happens here.

    Inactive slots write their value row to the scratch page and keep
    their residual and length. One encode launch covers every slot's
    residual group each step; only slots whose append completes the group
    (row g-1) write it to their page (the masked flush), the others are
    skipped."""
    g = cache.layout.page_size
    scratch = cache.layout.scratch_page
    s = k_new.shape[0]
    pos = cache.lengths                                   # (S,)
    # clamp to the table width: inactive slots whose stale position
    # exceeds a width-sliced table are redirected to scratch below anyway
    gidx = torch.clamp(pos // g, max=page_table.shape[1] - 1).long()
    page = torch.gather(page_table, 1, gidx[:, None])[:, 0]
    page = torch.where(active, page, torch.full_like(page, scratch)).long()
    row = (pos % g).long()
    sid = torch.arange(s, device=pos.device)

    # --- values (token-major page rows) ---
    cache.value_fp[page, :, row] = v_new[:, :, 0].to(cache.value_fp.dtype)

    # --- keys: residual row write, then the masked flush ---
    res = cache.key_residual
    new_rows = torch.where(active[:, None, None], k_new[:, :, 0].to(res.dtype),
                           res[sid, :, row])
    res[sid, :, row] = new_rows
    flush = active & (row == g - 1)
    fpage = torch.where(flush, page, torch.full_like(page, -1))
    cache.codec.encode_pages(cache.cfg, res, fpage.to(torch.int32)[:, None],
                             cache.key_codes, cache.key_scales)
    cache.lengths += active.to(torch.int32)
    return cache


def paged_decode_attention(cache: PagedKVCache, q: torch.Tensor,
                           page_table: torch.Tensor,
                           scale: float | None = None) -> torch.Tensor:
    """Single-step attention of q (S, Hq, d) over all slots' pages — the
    page-native ``"paged_fused"`` route: the codec walks the page table
    and reads quantized pages in place. ``page_table`` may be width-sliced
    to the live pages."""
    return cache.codec.paged_decode(cache, q, page_table, scale=scale)
