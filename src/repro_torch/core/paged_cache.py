"""Paged quantized KV cache: a shared page pool + per-slot page tables
(port of ``repro/core/paged_cache.py``, the paths of paged
continuous-batching serving: whole-prompt and chunked prefill, decode
append, decode attention on its three backends, chunk attention on its
two, copy-on-write copies, the speculative span's attention and commit).

One page holds exactly one quantization group (``page_size ==
group_size``): its key codes/stats and its ``page_size`` token-major value
rows. Key buffers come from the resolved codec (``core/codecs.py``).
Buffer shapes (``PP = num_pages + 1``: the last page is the masked-write
scratch page, ``S`` = slots, ``g`` = page size):

* grouped codecs (polar, kivi, zipcache):
    - ``key_codes``    (PP, H, g, ·) uint8 page pool (polar: (PP, H, g, P))
    - ``key_scales``   dict of (PP, H, 1|g, ·) stat pools (polar: four
      (PP, H, 1, P) fp32)
    - ``key_residual`` (S, H, g, d) per-slot not-yet-full group
      (``cfg.residual_dtype``)
* token-wise codecs (int, the fp passthrough ``"none"``): ``key_codes``
  (PP, H, g, ·) token-major page rows (the keys themselves in the model
  dtype for ``"none"``) + per-token ``key_scales`` pools; no residual
  (``key_residual`` is ``None``)
* ``value_fp``     (PP, H, g, d) token-major value rows (model dtype), or
  under ``cfg.value_bits > 0`` ``value_codes`` (PP, H, g, d) uint8 with
  ``value_scale`` / ``value_zero`` (PP, H, g, 1) (``cfg.scale_dtype``),
  one per (token, kv head) row; the other form is ``None``
* ``lengths``      (S,) int32 per-slot token counts

``H`` is the KV heads the cache holds. On a mesh that splits the pools
over KV heads (``distributed/serving.py``, DESIGN.md §17) a rank's cache
holds one block of them and says which: ``head_shard = (r, n)``, block
``r`` of ``n``; page ids, tables and lengths are the same on every rank.

Value rows for positions ``[0, len)`` live in pages (row ``pos % g`` of
page ``table[pos // g]``); a grouped codec's key codes for ``[0,
flushed)`` live in pages and keys of the partial group ``[flushed, len)``
in the residual, a token-wise codec's key rows sit beside the value rows.

Decode and chunk attention dispatch on the codec's capabilities, as JAX
does: a codec with a page-native kernel (``supports_paged_decode`` /
``supports_paged_prefill``: polar) reads its pages in place; the others
take the gathered route (:func:`gather_view` + the dense decode) and
:func:`chunk_prefill_attention`.

**In-place updates.** The JAX engine donates its state to each jitted
step; here :func:`paged_prefill` and :func:`paged_append` update the pools,
the residual and ``lengths`` in place (``index_copy_``, indexed
assignment) and return the same cache object. Group encodes write codes
and stats straight into their pool pages (one kernel launch for polar); a
polar group that is not written (padding pages at prefill, non-flushing
slots at decode) is skipped rather than redirected to the scratch page,
so only the never-read scratch page can differ from the JAX cache.
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
    key_codes: torch.Tensor          # codec page pool (fp rows for "none")
    key_scales: dict                 # codec stat pools (may be {})
    key_residual: torch.Tensor | None    # (S, H, g, d), grouped codecs
    value_codes: torch.Tensor | None     # (PP, H, g, d) uint8
    value_scale: torch.Tensor | None     # (PP, H, g, 1)
    value_zero: torch.Tensor | None      # (PP, H, g, 1)
    value_fp: torch.Tensor | None        # (PP, H, g, d)
    lengths: torch.Tensor            # (S,) int32
    cfg: QuantConfig
    layout: PagedLayout
    #: (block, blocks) when the pools hold one contiguous block of the
    #: model's KV heads; None when they hold every head
    head_shard: tuple[int, int] | None = None

    @property
    def codec(self):
        return self.cfg.codec

    @property
    def kv_heads(self) -> int:
        """The model's KV heads (every block's, under a head shard)."""
        n = 1 if self.head_shard is None else self.head_shard[1]
        return self.key_codes.shape[1] * n

    @property
    def grouped(self) -> bool:
        return self.cfg.codec.grouped


def init_paged_cache(cfg: QuantConfig, layout: PagedLayout, num_kv_heads: int,
                     head_dim: int, dtype=torch.bfloat16,
                     device=None,
                     head_shard: tuple[int, int] | None = None
                     ) -> PagedKVCache:
    """Allocate empty page pools for ``layout`` under policy ``cfg`` on
    ``device`` (the card unless named). ``head_shard = (r, n)``: the pools
    hold block ``r`` of ``n`` of the ``num_kv_heads`` heads."""
    device = resolve_device(device)
    if head_shard is not None:
        r, n = head_shard
        if num_kv_heads % n or not 0 <= r < n:
            raise ValueError(f"head block {head_shard} of {num_kv_heads} "
                             "kv heads")
        num_kv_heads //= n
    codec = cfg.codec
    if codec.grouped and layout.page_size != cfg.group_size:
        raise ValueError(
            f"page_size {layout.page_size} must equal group_size "
            f"{cfg.group_size} (one page == one quantization group)")
    pp, s = layout.pool_pages, layout.slots
    h, d, g = num_kv_heads, head_dim, layout.page_size
    key_codes, key_scales = codec.init_buffers(cfg, (pp, h), g, d, dtype,
                                               device)
    key_residual = None
    if codec.grouped:
        # one group per page: drop the G axis so the pool indexes pages
        # directly
        key_codes = key_codes[:, :, 0].contiguous()
        key_scales = {k: v[:, :, 0].contiguous()
                      for k, v in key_scales.items()}
        key_residual = torch.zeros((s, h, g, d),
                                   dtype=torch_dtype(cfg.residual_dtype),
                                   device=device)
    return PagedKVCache(
        key_codes=key_codes, key_scales=key_scales,
        key_residual=key_residual,
        **kvc.init_values(cfg, (pp, h, g), d, dtype, device),
        lengths=torch.zeros((s,), dtype=torch.int32, device=device),
        cfg=cfg, layout=layout, head_shard=head_shard)


def _state_buffers(cache: PagedKVCache) -> list[torch.Tensor]:
    return [buf for buf in (cache.key_codes, *cache.key_scales.values(),
                            cache.key_residual, cache.value_codes,
                            cache.value_scale, cache.value_zero,
                            cache.value_fp, cache.lengths)
            if buf is not None]


def empty_like_cache(cache: PagedKVCache) -> PagedKVCache:
    """A cache of the same shapes with fresh, uninitialized buffers (the
    scan verifier's shadow state, filled by :func:`copy_cache`)."""
    def e(x):
        return None if x is None else torch.empty_like(x)
    return dataclasses.replace(
        cache, key_codes=e(cache.key_codes),
        key_scales={k: e(v) for k, v in cache.key_scales.items()},
        key_residual=e(cache.key_residual), value_codes=e(cache.value_codes),
        value_scale=e(cache.value_scale), value_zero=e(cache.value_zero),
        value_fp=e(cache.value_fp), lengths=e(cache.lengths))


def copy_cache(dst: PagedKVCache, src: PagedKVCache) -> PagedKVCache:
    """Copy every buffer of ``src`` into ``dst``'s, in place."""
    for d, s in zip(_state_buffers(dst), _state_buffers(src), strict=True):
        d.copy_(s)
    return dst


def zero_cache(cache: PagedKVCache) -> PagedKVCache:
    """Zero every buffer in place: the state :func:`init_paged_cache`
    returns, at the same addresses (captured decode graphs bind them)."""
    for buf in _state_buffers(cache):
        buf.zero_()
    return cache


def _row_writes(cache: PagedKVCache, v: torch.Tensor,
                k: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(pool, rows) pairs of a token-major write of (…, T, ·) rows: the
    value rows of ``v`` and, under a token-wise codec, the encoded key
    rows of ``k`` (codes and per-token stats)."""
    out = [(getattr(cache, key), x)
           for key, x in kvc.value_fields(cache.cfg, v).items()]
    if not cache.grouped:
        codes, scales = cache.codec.encode(cache.cfg, k)
        out.append((cache.key_codes, codes))
        out += [(pool, scales[key]) for key, pool in cache.key_scales.items()]
    return out


def paged_prefill(cache: PagedKVCache, slot: int, page_row: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, true_len: int,
                  start: int = 0) -> PagedKVCache:
    """Write one request's prompt into its assigned pages, in place.

    k/v: (1, Hkv, Tp, d) post-RoPE, ``Tp`` a bucket length (multiple of
    the page size; the real tokens are the first ``true_len``). A prefill
    *chunk* passes its page-aligned absolute offset ``start`` (k RoPE'd at
    the absolute positions).
    ``page_row``: (N,) int32 table row of ``slot`` on the cache's device.
    Value rows of every page holding a real token — and a token-wise
    codec's key rows — and a grouped codec's key groups that are fully
    real go to ``page_row[start // g:]``; the partial group goes to the
    slot's residual (rounded through ``cfg.residual_dtype`` like every
    encoded group, the streaming-parity invariant). The slot length
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

    # --- values (and token-wise keys): token-major rows of every touched
    # page ---
    if ntouch:
        pages = page_row[p0:p0 + ntouch].long()
        for buf, x in _row_writes(cache, v[:, :, :ntouch * g],
                                  k[:, :, :ntouch * g]):
            xp = x[0].reshape(h, ntouch, g, x.shape[-1]).transpose(0, 1)
            buf.index_copy_(0, pages, xp.to(buf.dtype))
    if not cache.grouped:
        cache.lengths[slot] = start + true_len
        return cache

    # --- grouped keys: full groups encoded straight into their pages ---
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


def chunk_prefill_attention(cache: PagedKVCache, q: torch.Tensor,
                            k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                            page_row: torch.Tensor, start: int,
                            chunk_len: int,
                            scale: float | None = None) -> torch.Tensor:
    """Attention of one prefill chunk over the slot's cached prefix, on a
    gathered copy of the row's pages (port of
    ``repro/core/paged_cache.py:259-340``): the ``"jnp"`` route, and the
    route of every codec without a page-native prefill.

    q: (1, Hq, Tc, d) post-RoPE queries at absolute positions ``start +
    [0, Tc)``; k_chunk/v_chunk: (1, Hkv, Tc, d) the chunk's own fp
    keys/values (real tokens = first ``chunk_len``). ``start`` is
    page-aligned, so the prefix ``[0, start)`` is fully in pages (no
    residual term). Prefix scores go through the codec's score path over
    the encoded page bytes (polar: the score-only LUT kernel for CUDA
    tensors), the chunk's own scores are fp causal, and one softmax
    covers both. Returns (1, Hq, Tc, d) in q.dtype."""
    cfg = cache.cfg
    codec = cache.codec
    lay = cache.layout
    _, hq, tc, d = q.shape
    hkv = cache.key_codes.shape[1]
    qpk = hq // hkv
    n = page_row.shape[0]
    g = lay.page_size
    t_cap = n * g
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    pvalid = (page_row >= 0) & (page_row < lay.num_pages)
    idx = page_row.long().clamp(0, lay.pool_pages - 1)

    def gat(pool):  # (PP, H, a, b) -> (1, H, N, a, b), dead pages zeroed
        zero = torch.zeros((), dtype=pool.dtype, device=pool.device)
        x = torch.where(pvalid[:, None, None, None], pool[idx], zero)
        return x.transpose(0, 1)[None].contiguous()

    def flat(x):  # (1, H, N, g, ·) -> (1, H, N*g, ·)
        return x.reshape(1, hkv, t_cap, x.shape[-1])

    q4 = (q.float() * scale).reshape(1, hkv, qpk, tc, d)

    # --- prefix scores: the codec's score path over the gathered pages,
    # the chunk's queries folded onto the query-head axis ---
    key_codes = gat(cache.key_codes)
    key_scales = {kk: gat(vv) for kk, vv in cache.key_scales.items()}
    if not cache.grouped:
        key_codes = flat(key_codes)
        key_scales = {kk: flat(vv) for kk, vv in key_scales.items()}
    qf = q4.reshape(1, hkv, qpk * tc, d)
    s_prefix = codec.scores(cfg, qf, key_codes, key_scales)
    s_prefix = s_prefix.reshape(1, hkv, qpk, tc, t_cap)
    neg = torch.full((), kvc.NEG_INF, dtype=torch.float32, device=dev)
    pos = torch.arange(t_cap, device=dev)
    s_prefix = torch.where(pos < start, s_prefix, neg)

    # --- the chunk's own fp causal scores ---
    s_chunk = torch.einsum("bhqtd,bhsd->bhqts", q4, k_chunk.float())
    i = torch.arange(tc, device=dev)
    cmask = (i[:, None] >= i[None, :]) & (i[None, :] < chunk_len)
    s_chunk = torch.where(cmask, s_chunk, neg)
    probs = torch.softmax(torch.cat([s_prefix, s_chunk], dim=-1), dim=-1)

    # --- values: dequantized prefix rows + the chunk's own fp rows ---
    values, vscale, vzero = kvc.value_buffers(cache)
    v_pre = kvc.dequant_rows(*(None if x is None else flat(gat(x))
                               for x in (values, vscale, vzero)))
    v_all = torch.cat([v_pre, v_chunk.float()], dim=2)
    out = torch.einsum("bhqts,bhsd->bhqtd", probs, v_all)
    return out.reshape(1, hq, tc, d).to(q.dtype)


#: chunk-prefill backends over a paged cache: "jnp" gathers the row's pages
#: (:func:`chunk_prefill_attention`); "paged_fused" walks them in place
#: where the codec has the kernel. The tensors' device picks kernel or
#: plain version.
PREFILL_BACKENDS = ("jnp", "paged_fused")


def paged_prefill_attention(cache: PagedKVCache, q: torch.Tensor,
                            k_chunk: torch.Tensor, v_chunk: torch.Tensor,
                            page_row: torch.Tensor, start: int,
                            chunk_len: int, scale: float | None = None,
                            backend: str = "paged_fused") -> torch.Tensor:
    """Chunk-prefill attention on one of :data:`PREFILL_BACKENDS`
    (``repro/core/paged_cache.py:347-387``). ``"paged_fused"`` on a codec
    with a page-native prefill (``supports_paged_prefill``): the codec
    walks the slot's table row and scores the quantized prefix pages in
    place with one online softmax over prefix + chunk — the paged-prefill
    kernel for CUDA tensors, its plain version for CPU tensors. ``"jnp"``,
    or a codec without the capability: :func:`chunk_prefill_attention`.
    ``page_row`` may be width-sliced to the pages covering
    ``start + chunk_len``."""
    if backend not in PREFILL_BACKENDS:
        raise ValueError(f"unknown paged prefill backend {backend!r}; "
                         f"expected one of {PREFILL_BACKENDS}")
    if backend == "jnp" or not cache.codec.supports_paged_prefill:
        return chunk_prefill_attention(cache, q, k_chunk, v_chunk, page_row,
                                       start, chunk_len, scale=scale)
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

    Inactive slots write their value row (and a token-wise codec's key
    row) to the scratch page and keep their residual and length. Under a
    grouped codec one encode launch covers every slot's residual group
    each step; only slots whose append completes the group (row g-1)
    write it to their page (the masked flush), the others are skipped."""
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

    # --- values and token-wise keys (token-major page rows) ---
    for buf, x in _row_writes(cache, v_new, k_new):
        buf[page, :, row] = x[:, :, 0].to(buf.dtype)
    if not cache.grouped:
        cache.lengths += active.to(torch.int32)
        return cache

    # --- grouped keys: residual row write, then the masked flush ---
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


def paged_append_span(cache: PagedKVCache, k_span: torch.Tensor,
                      v_span: torch.Tensor, page_table: torch.Tensor,
                      n_keep: torch.Tensor) -> PagedKVCache:
    """Append the first ``n_keep[s]`` span tokens of every slot in one
    shot, in place (port of ``repro/core/paged_cache.py:516-596``).

    k_span/v_span: (S, Hkv, Q, d) post-RoPE (the speculative verifier's
    span kv); ``n_keep``: (S,) int32 tokens to commit (0 = slot untouched)
    — all on the cache's device, no host synchronisation. Bit-identical,
    outside the never-read scratch page, to ``n_keep`` sequential masked
    :func:`paged_append` calls PROVIDED the kept rows stay inside the
    slot's current group (``n_keep <= g - lengths % g``; the engine's
    span clamp guarantees it): kept value rows land at ``(page, r0 + j)``
    and the rest on the scratch page; kept residual rows are written
    through a one-row discard extension (a rejected row can never
    overwrite a kept one); and the at-most-one group flush (kept row
    ``g - 1``, necessarily the last) goes through one encode launch whose
    non-flushing slots are skipped — computed every time, so the dispatch
    can be captured (JAX gates it behind a ``lax.cond``)."""
    g = cache.layout.page_size
    scratch = cache.layout.scratch_page
    s, h, qn, d = k_span.shape
    pos = cache.lengths                                    # (S,)
    r0 = pos % g
    j = torch.arange(qn, device=pos.device)
    keep = j[None, :] < n_keep[:, None]                    # (S, Q)
    gidx = torch.clamp(pos // g, max=page_table.shape[1] - 1).long()
    page = torch.gather(page_table, 1, gidx[:, None])[:, 0]
    page = torch.where(n_keep > 0, page, torch.full_like(page, scratch))
    rows = torch.clamp(r0[:, None] + j[None, :], max=g - 1).long()
    pages_j = torch.where(keep, page[:, None].expand(s, qn),
                          torch.full_like(rows, scratch)).long()

    # --- values and token-wise keys: kept rows to (page, r0 + j), the
    # rest to scratch ---
    for buf, x in _row_writes(cache, v_span, k_span):
        buf[pages_j, :, rows] = x.transpose(1, 2).to(buf.dtype)
    if not cache.grouped:
        cache.lengths += n_keep.to(torch.int32)
        return cache

    # --- grouped keys: kept residual rows, then the masked flush ---
    res = cache.key_residual
    ext = torch.cat([res, res.new_zeros((s, h, 1, d))], dim=2)
    wrows = torch.where(keep, rows, torch.full_like(rows, g))
    sid = torch.arange(s, device=pos.device)[:, None].expand(s, qn)
    ext[sid, :, wrows] = k_span.transpose(1, 2).to(res.dtype)
    res.copy_(ext[:, :, :g])
    flush = (n_keep > 0) & (r0 + n_keep == g)
    fpage = torch.where(flush, page, torch.full_like(page, -1))
    cache.codec.encode_pages(cache.cfg, res, fpage.to(torch.int32)[:, None],
                             cache.key_codes, cache.key_scales)
    cache.lengths += n_keep.to(torch.int32)
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

    # grouped codecs keep the (S, H, N, g, ·) group axes; token-wise key
    # rows flatten like the value rows
    keys = masked if cache.grouped else tokens
    return kvc.KVCache(
        key_codes=keys(cache.key_codes),
        key_scales={k: keys(v) for k, v in cache.key_scales.items()},
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
    ``kv_cache.decode_attention`` for ``"jnp"`` and for a codec without the
    fused dense kernel, that kernel otherwise. The pre-page-native
    formulation, kept as a reference and A/B arm, and the route of every
    codec without a page-native decode."""
    view = gather_view(cache, page_table)
    if backend == "jnp" or not cache.codec.supports_fused_decode:
        return kvc.decode_attention(view, q, scale=scale)
    return kvc.fused_decode_attention(view, q, scale=scale)


def paged_decode_attention(cache: PagedKVCache, q: torch.Tensor,
                           page_table: torch.Tensor,
                           scale: float | None = None,
                           backend: str = "paged_fused") -> torch.Tensor:
    """Single-step attention of q (S, Hq, d) over all slots' pages, on one
    of :data:`DECODE_BACKENDS`. ``"paged_fused"``: a codec with a
    page-native kernel (``supports_paged_decode``) walks the page table
    and reads quantized pages in place; the others take the gathered
    route (``repro/core/paged_cache.py:692-730``). ``page_table`` may be
    width-sliced to the live pages."""
    if backend not in DECODE_BACKENDS:
        raise ValueError(f"unknown paged decode backend {backend!r}; "
                         f"expected one of {DECODE_BACKENDS}")
    if backend == "paged_fused" and cache.codec.supports_paged_decode:
        return cache.codec.paged_decode(cache, q, page_table, scale=scale)
    return gathered_decode_attention(cache, q, page_table, scale=scale,
                                     backend=backend)


def span_verify_attention(cache: PagedKVCache, q: torch.Tensor,
                          k_span: torch.Tensor, v_span: torch.Tensor,
                          page_table: torch.Tensor,
                          scale: float | None = None) -> torch.Tensor:
    """Speculative-span attention: Q draft positions per slot in one call,
    reproducing the sequential ``"jnp"`` decode view bit for bit (port of
    ``repro/core/paged_cache.py:733-885``).

    q: (S, Hq, Q, d) post-RoPE queries at absolute positions ``lengths +
    [0, Q)``; k_span/v_span: (S, Hkv, Q, d) the span's own post-RoPE
    keys/values. The cache is NOT mutated (the engine commits accepted
    positions afterwards, :func:`paged_append_span`).

    Sequential decode at span position j appends its own kv first, then
    attends over groups ``[0, flushed)`` through the codec, residual rows
    ``[flushed, L+j+1)`` at full precision (span keys rounded to
    ``cfg.residual_dtype`` by the append), and — when row ``(L+j) % g``
    is ``g - 1`` — the group that append flushed, through the codec. All
    three are emulated against the original cache: span keys written into
    a copy of the residual, span values into the gathered value view, and
    the possible flush by encoding the final residual once (the bytes a
    sequential flush encodes, because callers keep every span inside the
    slot's current group, so at most the LAST position crosses). The
    flush encode and its scores run every call (JAX gates them behind a
    ``lax.cond``), so the dispatch can be captured.

    The LUT scores run once over the pages and once over the flushed
    group, with the span folded onto the query-head axis (``Qh = Hq/Hkv
    * Q`` rows; the score rows are independent of each other). The ops
    whose kernels are chosen by the number of rows — the residual scores,
    the softmax and ``p @ V`` — run per span column at the one-token
    step's shapes, so each column's output has the decode step's bits.
    A token-wise codec needs no residual or flush emulation: the span keys
    are encoded per row and written into the gathered key rows, and each
    column scores them through the codec at the decode step's shapes.
    Span rows that fall past the table width (``lengths + j >=`` width *
    g, padding columns only) are dropped. Returns (S, Hq, Q, d) in
    ``q.dtype``."""
    cfg = cache.cfg
    codec = cache.codec
    g = cache.layout.page_size
    s, hq, qn, d = q.shape
    hkv = cache.key_codes.shape[1]
    qpk = hq // hkv
    t_cap = page_table.shape[1] * g
    scale = scale if scale is not None else d ** -0.5
    lengths = cache.lengths                                 # (S,)
    dev = lengths.device
    flushed0 = (lengths // g) * g
    j = torch.arange(qn, device=dev)
    sid = torch.arange(s, device=dev)[:, None].expand(s, qn)
    view = gather_view(cache, page_table)

    def with_span(x, upd):  # write span rows into a (S, H, T, b) view
        ext = torch.cat([x, x.new_zeros((s, x.shape[1], 1, x.shape[-1]))],
                        dim=2)
        tpos = torch.clamp(lengths[:, None] + j[None, :], max=t_cap).long()
        ext[sid, :, tpos] = upd.transpose(1, 2).to(x.dtype)
        return ext[:, :, :t_cap]

    q4 = (q.float() * scale).reshape(s, hkv, qpk, qn, d)
    v_view = {f: with_span(getattr(view, f), x) for f, x in
              kvc.value_fields(cfg, v_span).items()}
    values = kvc.dequant_rows(
        *kvc.value_buffers(dataclasses.replace(view, **v_view)))
    if not cache.grouped:
        codes, scales = codec.encode(cfg, k_span)
        kc = with_span(view.key_codes, codes)
        ks = {kk: with_span(vv, scales[kk])
              for kk, vv in view.key_scales.items()}
        pos = torch.arange(t_cap, device=dev)[None, :]
        neg = torch.full((), kvc.NEG_INF, dtype=torch.float32, device=dev)
        out = []
        for i in range(qn):
            scores = codec.scores(cfg, q4[:, :, :, i].contiguous(), kc, ks)
            valid = pos < (lengths[:, None] + 1 + i)           # (S, T)
            probs = torch.softmax(
                torch.where(valid[:, None, None], scores, neg), dim=-1)
            o = torch.einsum("bhqt,bhtd->bhqd", probs, values)
            out.append(o.reshape(s, hq, d).to(q.dtype))
        return torch.stack(out, dim=2)

    # the final residual: span keys rounded and written at rows r0 + j
    # (rows past the group land on a discard row)
    res = cache.key_residual
    rows = (lengths % g)[:, None] + j[None, :]
    wrows = torch.where(rows < g, rows, torch.full_like(rows, g)).long()
    ext = torch.cat([res, res.new_zeros((s, hkv, 1, d))], dim=2)
    ext[sid, :, wrows] = k_span.transpose(1, 2).to(res.dtype)
    res_new = ext[:, :, :g].contiguous()

    # fold span positions onto the query-head axis: rows (qpk, Q)
    qf = q4.reshape(s, hkv, qpk * qn, d)
    s_pages = codec.scores(cfg, qf, view.key_codes, view.key_scales)
    fcodes, fscales = codec.encode(cfg, res_new)           # (S, H, 1, g, ·)
    s_flush = codec.scores(cfg, qf, fcodes, fscales)       # (S, H, Qh, g)
    s_pages = s_pages.reshape(s, hkv, qpk, qn, t_cap)
    s_flush = s_flush.reshape(s, hkv, qpk, qn, g)

    res32 = res_new.float()
    pos = torch.arange(t_cap, dtype=torch.int32, device=dev)[None, :]
    base = flushed0[:, None]                                # (S, 1)
    neg = torch.full((), kvc.NEG_INF, dtype=torch.float32, device=dev)
    reps = t_cap // g
    out = []
    for i in range(qn):
        vl = lengths[:, None] + 1 + i                       # (S, 1)
        m_pages = pos < base
        m_flush = (pos >= base) & (pos < base + g) & (vl >= base + g)
        m_res = (pos >= base) & (pos < vl) & (vl < base + g)
        qi = q4[:, :, :, i].contiguous()
        s_res = torch.einsum("bhqd,bhgd->bhqg", qi, res32)
        scores = torch.where(
            m_res[:, None, None], s_res.repeat(1, 1, 1, reps),
            torch.where(m_flush[:, None, None],
                        s_flush[:, :, :, i].repeat(1, 1, 1, reps),
                        torch.where(m_pages[:, None, None],
                                    s_pages[:, :, :, i], neg)))
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqt,bhtd->bhqd", probs, values)
        out.append(o.reshape(s, hq, d).to(q.dtype))
    return torch.stack(out, dim=2)
