"""Paged quantized KV cache: a shared page pool + per-slot page tables
(port of ``repro/core/paged_cache.py``, the paths of paged
continuous-batching serving: whole-prompt and chunked prefill, decode
append, decode attention on its three backends, page-native chunk
attention, copy-on-write copies).

One page holds exactly one quantization group (``page_size ==
group_size``): its key codes/stats and its ``page_size`` token-major value
rows. Buffer shapes (``PP = num_pages + 1``: the last page is the
masked-write scratch page, ``S`` = slots, ``g`` = page size):

* ``key_codes``    (PP, H, g, P) uint8 page pool
* ``key_scales``   dict of four (PP, H, 1, P) fp32 stat pools
* ``key_residual`` (S, H, g, d) per-slot not-yet-full group
  (``cfg.residual_dtype``)
* ``value_fp``     (PP, H, g, d) token-major value rows (model dtype), or
  under ``cfg.value_bits > 0`` ``value_codes`` (PP, H, g, d) uint8 with
  ``value_scale`` / ``value_zero`` (PP, H, g, 1) (``cfg.scale_dtype``),
  one per (token, kv head) row; the other form is ``None``
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
:func:`copy_pool_pages` (the device half of a COW split) also copies in
place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.core.cache_layout import LinearLayout, PagedLayout
from repro_torch.core.quantizers import QuantConfig
from repro_torch.utils import resolve_device, torch_dtype

@dataclasses.dataclass
class PagedKVCache:
    key_codes: torch.Tensor          # (PP, H, g, P) uint8
    key_scales: dict                 # four (PP, H, 1, P) stat pools
    key_residual: torch.Tensor       # (S, H, g, d)
    value_codes: torch.Tensor | None     # (PP, H, g, d) uint8
    value_scale: torch.Tensor | None     # (PP, H, g, 1)
    value_zero: torch.Tensor | None      # (PP, H, g, 1)
    value_fp: torch.Tensor | None        # (PP, H, g, d)
    lengths: torch.Tensor            # (S,) int32
    cfg: QuantConfig
    layout: PagedLayout

    @property
    def codec(self):
        return self.cfg.codec


def init_paged_cache(cfg: QuantConfig, layout: PagedLayout, num_kv_heads: int,
                     head_dim: int, dtype=torch.bfloat16,
                     device=None) -> PagedKVCache:
    """Allocate empty page pools for ``layout`` under policy ``cfg`` on
    ``device`` (the card unless named)."""
    device = resolve_device(device)
    codec = cfg.codec
    if not codec.grouped or not codec.supports_paged_decode:
        raise ValueError(f"codec {cfg.method!r} has no paged path in this "
                         "port")
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
        **kvc.init_values(cfg, (pp, h, g), d, dtype, device),
        lengths=torch.zeros((s,), dtype=torch.int32, device=device),
        cfg=cfg, layout=layout)


def zero_cache(cache: PagedKVCache) -> PagedKVCache:
    """Zero every buffer in place: the state :func:`init_paged_cache`
    returns, at the same addresses (captured decode graphs bind them)."""
    for buf in (cache.key_codes, *cache.key_scales.values(),
                cache.key_residual, cache.value_codes, cache.value_scale,
                cache.value_zero, cache.value_fp, cache.lengths):
        if buf is not None:
            buf.zero_()
    return cache


def paged_prefill(cache: PagedKVCache, slot: int, page_row: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, true_len: int,
                  start: int = 0) -> PagedKVCache:
    """Write one request's prompt into its assigned pages, in place.

    k/v: (1, Hkv, Tp, d) post-RoPE, ``Tp`` a bucket length (multiple of
    the page size; the real tokens are the first ``true_len``). A prefill
    *chunk* passes its page-aligned absolute offset ``start`` (k RoPE'd at
    the absolute positions).
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
    # only the pages holding real tokens are written, so a final chunk
    # whose bucket window [p0, p0 + tp/g) overruns the row writes nothing
    # past it (JAX pads the row with scratch for the same effect)
    if p0 + ntouch > page_row.shape[0]:
        raise ValueError("prompt overruns the slot's page-table row")

    # --- values: token-major rows of every touched page ---
    if ntouch:
        pages = page_row[p0:p0 + ntouch].long()
        for key, x in kvc.value_fields(cfg, v[:, :, :ntouch * g]).items():
            buf = getattr(cache, key)
            xp = x[0].reshape(h, ntouch, g, x.shape[-1]).transpose(0, 1)
            buf.index_copy_(0, pages, xp.to(buf.dtype))

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


# ---------------------------------------------------------------------------
# Chunked prefill: attention of one chunk over the cached prefix
# ---------------------------------------------------------------------------


def paged_prefill_attention(cache: PagedKVCache, q: torch.Tensor,
                            k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                            page_row: torch.Tensor, start: int,
                            chunk_len: int,
                            scale: float | None = None) -> torch.Tensor:
    """Chunk-prefill attention, page-native (the ``"paged_fused"`` route
    of ``repro/core/paged_cache.py:347``): the codec walks the slot's
    table row and scores the quantized prefix pages in place with one
    online softmax over prefix + chunk — the paged-prefill kernel for
    CUDA tensors, its plain version for CPU tensors. ``page_row`` may be
    width-sliced to the pages covering ``start + chunk_len``."""
    return cache.codec.paged_prefill(cache, q, k_chunk, v_chunk, page_row,
                                     start, chunk_len, scale=scale)


# ---------------------------------------------------------------------------
# Copy-on-write page copy (device half of PageAllocator.cow)
# ---------------------------------------------------------------------------


def _pool_buffers(cache: PagedKVCache) -> list[torch.Tensor]:
    values = [x for x in kvc.value_buffers(cache) if x is not None]
    return [cache.key_codes, *cache.key_scales.values(), *values]


def copy_pool_pages(cache: PagedKVCache, src: int, dst: int
                    ) -> PagedKVCache:
    """Copy pool page ``src`` -> ``dst`` in every page-indexed buffer, in
    place (``index_copy_``) — the device half of a COW split. Slot state
    (``key_residual``, ``lengths``) is untouched."""
    dev = cache.key_codes.device
    s = torch.tensor([src], dtype=torch.long, device=dev)
    d = torch.tensor([dst], dtype=torch.long, device=dev)
    for buf in _pool_buffers(cache):
        buf.index_copy_(0, d, buf.index_select(0, s))
    return cache


def pool_page_bytes(cache: PagedKVCache) -> int:
    """Physical bytes one pool page occupies across the page-indexed
    buffers — the unit of the shared-prefix memory win."""
    return sum(buf.numel() * buf.element_size() // buf.shape[0]
               for buf in _pool_buffers(cache))


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
    for key, x in kvc.value_fields(cache.cfg, v_new).items():
        buf = getattr(cache, key)
        buf[page, :, row] = x[:, :, 0].to(buf.dtype)

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


# ---------------------------------------------------------------------------
# Gathered dense view + decode attention
# ---------------------------------------------------------------------------


def gather_view(cache: PagedKVCache,
                page_table: torch.Tensor) -> kvc.KVCache:
    """Materialize per-slot dense cache views from the page table.

    Returns a :class:`~repro_torch.core.kv_cache.KVCache` with batch ==
    slots and ``length`` (S,), consumable by ``kv_cache.decode_attention``
    and ``kv_cache.fused_decode_attention``. Unassigned table entries (the
    scratch page, or out of pool range) are masked at *page* granularity:
    their gathered pages are zeroed before any scoring, so stale
    masked-write garbage on the scratch page can never leak through a
    zero-probability lane (``0 * NaN``)."""
    lay = cache.layout
    s, n = page_table.shape
    t_cap = n * lay.page_size
    pvalid = (page_table >= 0) & (page_table < lay.num_pages)     # (S, N)
    idx = page_table.long().clamp(0, lay.pool_pages - 1)

    def masked(x):  # (PP, H, a, b) -> (S, H, N, a, b), dead pages zeroed
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        # where() keeps the transposed strides: the kernels take dense rows
        return torch.where(pvalid[:, None, :, None, None],
                           x[idx].transpose(1, 2), zero).contiguous()

    def tokens(x):  # (PP, H, g, b) -> (S, H, N*g, b), dead pages zeroed
        if x is None:
            return None
        x = masked(x)
        return x.reshape(s, x.shape[1], t_cap, x.shape[-1])

    return kvc.KVCache(
        key_codes=masked(cache.key_codes),
        key_scales={k: masked(v) for k, v in cache.key_scales.items()},
        key_residual=cache.key_residual,
        **{f: tokens(getattr(cache, f)) for f in
           ("value_codes", "value_scale", "value_zero", "value_fp")},
        length=cache.lengths, cfg=cache.cfg, max_len=t_cap,
        layout=LinearLayout(t_cap))


#: decode backends over a paged cache: "jnp" and "gathered" read a dense
#: per-slot copy (gather_view) through the score-only LUT kernel + softmax
#: and through the fused dense kernel; "paged_fused" walks the page table
#: in place. In the port the tensors' device picks kernel or plain version.
DECODE_BACKENDS = ("jnp", "gathered", "paged_fused")


def gathered_decode_attention(cache: PagedKVCache, q: torch.Tensor,
                              page_table: torch.Tensor, *,
                              scale: float | None = None,
                              backend: str = "jnp") -> torch.Tensor:
    """Decode attention over the dense per-slot view (an O(capacity) copy):
    ``kv_cache.decode_attention`` for ``"jnp"``, the fused dense kernel
    otherwise. The pre-page-native formulation, kept as a reference and
    A/B arm."""
    view = gather_view(cache, page_table)
    if backend == "jnp" or not cache.codec.supports_fused_decode:
        return kvc.decode_attention(view, q, scale=scale)
    return kvc.fused_decode_attention(view, q, scale=scale)


def paged_decode_attention(cache: PagedKVCache, q: torch.Tensor,
                           page_table: torch.Tensor,
                           scale: float | None = None,
                           backend: str = "paged_fused") -> torch.Tensor:
    """Single-step attention of q (S, Hq, d) over all slots' pages, on one
    of :data:`DECODE_BACKENDS`. ``"paged_fused"``: the codec walks the page
    table and reads quantized pages in place. ``page_table`` may be
    width-sliced to the live pages."""
    if backend not in DECODE_BACKENDS:
        raise ValueError(f"unknown paged decode backend {backend!r}; "
                         f"expected one of {DECODE_BACKENDS}")
    if backend == "paged_fused":
        return cache.codec.paged_decode(cache, q, page_table, scale=scale)
    return gathered_decode_attention(cache, q, page_table, scale=scale,
                                     backend=backend)
