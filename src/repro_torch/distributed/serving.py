"""Mesh-sharded paged serving: head-parallel page pools (port of
``repro/distributed/serving.py``, DESIGN.md §17).

One process per mesh position; each holds the params whole and runs the
same host schedule.

* **Pools are partitioned over KV heads.** Every page-pool buffer carries
  its head axis at ``ndim - 3`` — ``(PP, H, g, ·)`` pools, ``(S, H, g,
  d)`` residual — and a rank's cache holds one contiguous block of it
  along the mesh's ``model`` axis (``PagedKVCache.head_shard = (r, n)``);
  ``lengths`` (and anything below rank 4) is whole on every rank.
* **PageAllocator and the page table stay on the host, shard-agnostic.**
  Every rank runs the same allocator, prefix index and COW decisions and
  holds the same page ids; only pool payload is partitioned.
* **Kernels run per shard.** Per-KV-head attention has no cross-head
  math: each rank walks the same page table over its head block of the
  pools with the matching query-head block (both head counts divide the
  axis, so the rank's contiguous query heads map onto its contiguous KV
  heads), and the per-head outputs are gathered over the axis in head
  order before the replicated ``wo`` — bit-identical per head to the
  unsharded call. The paged decode kernel plans its splits from the
  model's KV-head count (``PagedKVCache.kv_heads``) for that reason.
* **Dense caches too.** The static engine under a mesh
  (``ServeEngine(mesh=)``) holds per-layer linear caches
  (``kv_cache.KVCache``) of the rank's head block
  (``KVCache.head_shard``); its prefill (#3) and decode (#5 or #6) run
  through :func:`dispatch_flash_prefill`, :func:`dispatch_decode_attention`
  and :func:`dispatch_fused_decode_attention`, and the speculative span
  verifier's attention through :func:`dispatch_span_verify_attention`.
* **GQA fallback.** When ``num_kv_heads`` (or ``num_heads``) does not
  divide the model axis, every rank holds the whole pools and dispatch
  runs the plain path — same math, no partitioning, no collective.
* **Context-parallel decode** (:func:`context_parallel_decode`): the page
  table's columns are sharded instead, each rank scores its slice of the
  context and the online-softmax carries are merged with the collectives
  of ``distributed/collectives.py`` (or the score rows all-gathered). It
  is the reference for the stats-merge collectives; the serving path is
  head-sharded.

JAX runs the sharded calls inside ``shard_map`` over a full state; here
the caller already holds its block, and the gather is a collective over
the rank's line of the model axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import kv_cache as kvc
from repro_torch.core import paged_cache as pgc
from repro_torch.distributed import ctx
from repro_torch.distributed.collectives import (
    allgather_concat, finalize_softmax, merge_softmax_stats, softmax_stats,
)
from repro_torch.distributed.ctx import P, PartitionSpec
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh

MODEL_AXIS = "model"

#: the tensor fields of a PagedKVCache, in declaration order
_FIELDS = ("key_codes", "key_scales", "key_residual", "value_codes",
           "value_scale", "value_zero", "value_fp", "lengths")


# ---------------------------------------------------------------------------
# Head-axis partition specs
# ---------------------------------------------------------------------------


def _pool_heads(cache: pgc.PagedKVCache) -> int:
    """KV heads the pools hold, read at the canonical head axis
    (``ndim - 3``)."""
    kc = cache.key_codes
    return kc.shape[kc.ndim - 3]


def leaf_pspec(x, num_kv_heads: int, axis: str = MODEL_AXIS) -> PartitionSpec:
    """PartitionSpec for one pool leaf: the head axis (``ndim - 3``) over
    ``axis`` when it is the head axis; everything else (lengths, scalars)
    replicated."""
    nd = x.ndim
    if nd >= 4 and x.shape[nd - 3] == num_kv_heads:
        spec: list = [None] * nd
        spec[nd - 3] = axis
        return P(*spec)
    return P()


def _map_fields(fn, cache: pgc.PagedKVCache) -> dict:
    """``fn`` over every tensor field of ``cache`` (``key_scales`` maps
    to a dict); None fields stay None."""
    out = {}
    for f in _FIELDS:
        x = getattr(cache, f)
        if isinstance(x, dict):
            out[f] = {k: fn(v) for k, v in x.items()}
        else:
            out[f] = None if x is None else fn(x)
    return out


def cache_pspecs(cache: pgc.PagedKVCache, axis: str = MODEL_AXIS) -> dict:
    """PartitionSpecs of ``cache``'s tensor fields (field -> spec, dict of
    specs for ``key_scales``, None for an absent field): pool head axes
    over ``axis``, slot-indexed state replicated."""
    h = _pool_heads(cache)
    return _map_fields(lambda x: leaf_pspec(x, h, axis), cache)


def _head_divisible(kv_heads: int, q_heads: int, mesh, axis: str) -> bool:
    n = mesh.shape.get(axis, 0)
    return n > 0 and kv_heads % n == 0 and q_heads % n == 0


def paged_state_shardings(state: Any, mesh, axis: str = MODEL_AXIS) -> Any:
    """Spec dicts (:func:`cache_pspecs`) for one cache or a list of
    per-layer caches: head-partitioned pools where the KV head count
    divides the mesh axis, everything replicated (``P()``) otherwise."""
    model_n = mesh.shape.get(axis, 1)

    def one(c):
        if _pool_heads(c) % model_n:
            return _map_fields(lambda x: P(), c)
        return cache_pspecs(c, axis)
    return [one(c) for c in state] if isinstance(state, list) else one(state)


def head_block(mesh: Mesh, axis: str = MODEL_AXIS) -> tuple[int, int]:
    """(this rank's coordinate on ``axis``, the axis size): the head block
    its pools hold."""
    return mesh.axis_index(axis), mesh.shape[axis]


def shard_paged_state(state: Any, mesh: Mesh, axis: str = MODEL_AXIS) -> Any:
    """This rank's block of one cache or a list of per-layer caches that
    hold every head: a copy holding block :func:`head_block` of the
    head-axis leaves (and the other leaves whole), ``head_shard`` set; a
    cache whose KV heads do not divide the axis is returned as it is (the
    GQA fallback)."""
    r, n = head_block(mesh, axis)

    def one(c):
        h = _pool_heads(c)
        if c.head_shard is not None:
            raise ValueError(f"cache already holds head block {c.head_shard}")
        if h % n:
            return c
        b = h // n

        def take(x):  # a copy: the shard's in-place updates stay its own
            if leaf_pspec(x, h, axis) == P():
                return x.clone()
            return x.narrow(x.ndim - 3, r * b, b).clone(
                memory_format=torch.contiguous_format)
        return dataclasses.replace(c, **_map_fields(take, c),
                                   head_shard=(r, n))
    return [one(c) for c in state] if isinstance(state, list) else one(state)


# ---------------------------------------------------------------------------
# Head-sharded attention (the serving hot path)
# ---------------------------------------------------------------------------


def local_heads(cache, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The block of ``x``'s heads (axis ``dim``) that ``cache``'s head
    shard holds, contiguous; ``x`` itself for a cache of every head.
    ``cache``: a paged or a dense (``kv_cache.KVCache``) cache."""
    if cache.head_shard is None:
        return x
    r, n = cache.head_shard
    b = x.shape[dim] // n
    return x.narrow(dim, r * b, b).contiguous()


def _check_block(cache, mesh: Mesh, axis: str) -> None:
    if cache.head_shard != head_block(mesh, axis):
        raise ValueError(f"cache holds head block {cache.head_shard}, but "
                         f"this rank is {head_block(mesh, axis)} of mesh "
                         f"axis {axis!r}")


def sharded_paged_decode_attention(cache: pgc.PagedKVCache, q: torch.Tensor,
                                   page_table: torch.Tensor, *, mesh: Mesh,
                                   axis: str = MODEL_AXIS,
                                   scale: float | None = None,
                                   backend: str = "paged_fused"
                                   ) -> torch.Tensor:
    """Head-sharded :func:`pgc.paged_decode_attention`: ``cache`` is this
    rank's head shard (or the whole pools, the fallback: the plain call),
    ``q`` (S, Hq, d) every query head. The rank runs the decode dispatch
    over its KV-head block with the matching query-head block, and the
    blocks are gathered over ``axis``: (S, Hq, d) on every rank."""
    if cache.head_shard is None:
        return pgc.paged_decode_attention(cache, q, page_table, scale=scale,
                                          backend=backend)
    _check_block(cache, mesh, axis)
    out = pgc.paged_decode_attention(cache, local_heads(cache, q),
                                     page_table, scale=scale,
                                     backend=backend)
    return allgather_concat(out, mesh, axis, axis=1)


def sharded_paged_prefill_attention(cache: pgc.PagedKVCache, q: torch.Tensor,
                                    k_chunk: torch.Tensor,
                                    v_chunk: torch.Tensor,
                                    page_row: torch.Tensor, start: int,
                                    chunk_len: int, *, mesh: Mesh,
                                    axis: str = MODEL_AXIS,
                                    scale: float | None = None,
                                    backend: str = "paged_fused"
                                    ) -> torch.Tensor:
    """Head-sharded :func:`pgc.paged_prefill_attention` (the chunk-prefill
    twin of :func:`sharded_paged_decode_attention`): q (1, Hq, Tc, d) and
    the chunk's k/v (1, Hkv, Tc, d) with every head in, (1, Hq, Tc, d)
    out."""
    if cache.head_shard is None:
        return pgc.paged_prefill_attention(cache, q, k_chunk, v_chunk,
                                           page_row, start, chunk_len,
                                           scale=scale, backend=backend)
    _check_block(cache, mesh, axis)
    out = pgc.paged_prefill_attention(
        cache, local_heads(cache, q), local_heads(cache, k_chunk),
        local_heads(cache, v_chunk), page_row, start, chunk_len, scale=scale,
        backend=backend)
    return allgather_concat(out, mesh, axis, axis=1)


def _active_head_axis(cache, q_heads: int):
    """(mesh, axis) when the installed sharding context maps ``kv_heads``
    onto a mesh axis that divides both head counts and ``cache`` (paged or
    dense) is a head shard; (None, None) otherwise (no context, the GQA
    fallback, a cache of every head such as a draft model's, a test
    double). A head shard outside such a context raises: its buffers hold
    only some of the heads."""
    mesh = ctx.current_mesh()
    rules = ctx.current_rules() or {}
    axis = rules.get("kv_heads")
    if (not isinstance(mesh, Mesh) or not isinstance(axis, str)
            or axis not in mesh.shape
            or not _head_divisible(cache.kv_heads, q_heads, mesh, axis)):
        if cache.head_shard is not None:
            raise ValueError(f"a cache of head block {cache.head_shard} "
                             "needs the mesh context that split it")
        return None, None
    if cache.head_shard is None:
        return None, None
    return mesh, axis


def dispatch_paged_decode_attention(cache: pgc.PagedKVCache, q: torch.Tensor,
                                    page_table: torch.Tensor, *,
                                    scale: float | None = None,
                                    backend: str = "paged_fused"
                                    ) -> torch.Tensor:
    """Context-aware decode dispatch: head-sharded when the engine
    installed a mesh whose ``kv_heads`` rule divides the heads, the plain
    single-process path otherwise. Model code calls this so it stays
    mesh-agnostic."""
    mesh, axis = _active_head_axis(cache, q.shape[1])
    if mesh is None:
        return pgc.paged_decode_attention(cache, q, page_table, scale=scale,
                                          backend=backend)
    return sharded_paged_decode_attention(cache, q, page_table, mesh=mesh,
                                          axis=axis, scale=scale,
                                          backend=backend)


def dispatch_paged_prefill_attention(cache: pgc.PagedKVCache, q: torch.Tensor,
                                     k_chunk: torch.Tensor,
                                     v_chunk: torch.Tensor,
                                     page_row: torch.Tensor, start: int,
                                     chunk_len: int, *,
                                     scale: float | None = None,
                                     backend: str = "paged_fused"
                                     ) -> torch.Tensor:
    """Context-aware chunk-prefill dispatch (see
    :func:`dispatch_paged_decode_attention`)."""
    mesh, axis = _active_head_axis(cache, q.shape[1])
    if mesh is None:
        return pgc.paged_prefill_attention(cache, q, k_chunk, v_chunk,
                                           page_row, start, chunk_len,
                                           scale=scale, backend=backend)
    return sharded_paged_prefill_attention(
        cache, q, k_chunk, v_chunk, page_row, start, chunk_len, mesh=mesh,
        axis=axis, scale=scale, backend=backend)


def dispatch_flash_prefill(cache, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, **kw) -> torch.Tensor:
    """Flash attention of a whole prompt (q (B, Hq, T, d), k/v (B, Hkv, T,
    d); ``kw``: ``ops.flash_prefill``'s mask mode, window and prefix
    lengths), over the head block of ``cache``'s shard (paged or dense)
    and gathered when the engine installed a mesh (see
    :func:`dispatch_paged_decode_attention`) — the port's counterpart of
    the GSPMD-partitioned flash attention of JAX's
    ``attention_prefill_paged`` and ``attention_prefill``."""
    mesh, axis = _active_head_axis(cache, q.shape[1])
    if mesh is None:
        return ops.flash_prefill(q, k, v, **kw)
    _check_block(cache, mesh, axis)
    out = ops.flash_prefill(local_heads(cache, q), local_heads(cache, k),
                            local_heads(cache, v), **kw)
    return allgather_concat(out, mesh, axis, axis=1)


def dispatch_span_verify_attention(cache: pgc.PagedKVCache, q: torch.Tensor,
                                   k_span: torch.Tensor,
                                   v_span: torch.Tensor,
                                   page_table: torch.Tensor
                                   ) -> torch.Tensor:
    """Context-aware speculative-span attention (the span verifier's,
    :func:`pgc.span_verify_attention`): q (S, Hq, Q, d) and the span's
    k/v (S, Hkv, Q, d) with every head in, (S, Hq, Q, d) out. Under a
    mesh that splits the heads the rank scores its head block and the
    blocks are gathered (see :func:`dispatch_paged_decode_attention`);
    the plain call otherwise."""
    mesh, axis = _active_head_axis(cache, q.shape[1])
    if mesh is None:
        return pgc.span_verify_attention(cache, q, k_span, v_span,
                                         page_table)
    _check_block(cache, mesh, axis)
    out = pgc.span_verify_attention(
        cache, local_heads(cache, q), local_heads(cache, k_span),
        local_heads(cache, v_span), page_table)
    return allgather_concat(out, mesh, axis, axis=1)


def dispatch_decode_attention(cache: kvc.KVCache, q: torch.Tensor, *,
                              window: int = 0) -> torch.Tensor:
    """Context-aware decode over a dense cache on the score route
    (:func:`kvc.decode_attention`: #6 + softmax for polar): q (B, Hq, d)
    every query head, (B, Hq, d) out; per head block and gathered under
    a mesh that splits the heads (``cache`` the rank's
    ``head_shard``)."""
    mesh, axis = _active_head_axis(cache, q.shape[1])
    if mesh is None:
        return kvc.decode_attention(cache, q, window=window)
    _check_block(cache, mesh, axis)
    out = kvc.decode_attention(cache, local_heads(cache, q), window=window)
    return allgather_concat(out, mesh, axis, axis=1)


def dispatch_fused_decode_attention(cache: kvc.KVCache,
                                    q: torch.Tensor) -> torch.Tensor:
    """Context-aware decode over a dense cache through the codec's fused
    kernel (:func:`kvc.fused_decode_attention`: #5 for polar, its splits
    planned for the model's KV heads); see
    :func:`dispatch_decode_attention`."""
    mesh, axis = _active_head_axis(cache, q.shape[1])
    if mesh is None:
        return kvc.fused_decode_attention(cache, q)
    _check_block(cache, mesh, axis)
    out = kvc.fused_decode_attention(cache, local_heads(cache, q))
    return allgather_concat(out, mesh, axis, axis=1)


# ---------------------------------------------------------------------------
# Context-parallel decode (page-table columns sharded; stats-merge oracle)
# ---------------------------------------------------------------------------


def _block_scores_values(cache: pgc.PagedKVCache, q: torch.Tensor,
                         pt_block: torch.Tensor, pos0: int,
                         scale: float | None):
    """Masked scores + value rows for a contiguous block of page-table
    columns whose first token sits at global position ``pos0`` (a page
    multiple).

    Per slot, a token position is scored from exactly one source: codec
    codes when it is flushed into a page (``pos < flushed``), the fp
    residual row when it is in the open group (``flushed <= pos < len``;
    only the rank owning the open group's page column scores it, so
    values and scores stay on one rank). Everything else is ``NEG_INF`` /
    zeroed, so a block with no live positions yields a zero-weight
    carry."""
    cfg, codec, lay = cache.cfg, cache.codec, cache.layout
    s, n = pt_block.shape
    hkv = _pool_heads(cache)
    hq, d = q.shape[1], q.shape[-1]
    qpk = hq // hkv
    g = lay.page_size
    t_loc = n * g
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    pvalid = (pt_block >= 0) & (pt_block < lay.num_pages)
    idx = pt_block.long().clamp(0, lay.pool_pages - 1)

    def masked(x):  # (PP, H, a, b) -> (S, H, N, a, b), invalid pages zeroed
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        return torch.where(pvalid[:, None, :, None, None],
                           x[idx].transpose(1, 2), zero)

    def flat(x):  # (S, H, N, g, ·) -> (S, H, N*g, ·)
        return x.reshape(s, hkv, t_loc, x.shape[-1])

    qf = (q.float() * scale).reshape(s, hkv, qpk, d)
    key_codes = masked(cache.key_codes)
    key_scales = {kk: masked(vv) for kk, vv in cache.key_scales.items()}
    if not cache.grouped:
        key_codes = flat(key_codes)
        key_scales = {kk: flat(vv) for kk, vv in key_scales.items()}
    s_pages = codec.scores(cfg, qf, key_codes, key_scales)  # (S,Hkv,qpk,Tl)

    pos = pos0 + torch.arange(t_loc, dtype=torch.int32, device=dev)
    length = cache.lengths[:, None]                           # (S, 1)
    neg = torch.full((), kvc.NEG_INF, dtype=torch.float32, device=dev)
    if cache.grouped:
        flushed = (cache.lengths // g * g)[:, None]
        res = cache.key_residual.float()                      # (S, H, g, d)
        s_res = torch.einsum("shqd,shgd->shqg", qf, res)      # (S,Hkv,qpk,g)
        s_res = s_res.repeat(1, 1, 1, n)                      # row == pos % g
        in_page = pos[None, :] < flushed                      # (S, T_loc)
        in_res = (pos[None, :] >= flushed) & (pos[None, :] < length)
        scores = torch.where(in_page[:, None, None, :], s_pages,
                             torch.where(in_res[:, None, None, :], s_res,
                                         neg))
    else:
        live = pos[None, :] < length
        scores = torch.where(live[:, None, None, :], s_pages, neg)

    values, vscale, vzero = kvc.value_buffers(cache)
    v_tilde = kvc.dequant_rows(*(None if x is None else flat(masked(x))
                                 for x in (values, vscale, vzero)))
    return scores, v_tilde.reshape(s, hkv, 1, t_loc, -1)     # qpk broadcast


def context_parallel_decode(cache: pgc.PagedKVCache, q: torch.Tensor,
                            page_table: torch.Tensor, *, mesh: Mesh,
                            axis: str = MODEL_AXIS, merge: str = "psum",
                            scale: float | None = None) -> torch.Tensor:
    """Context-parallel (page-column-sharded) decode reference.

    Every rank holds the whole cache and query; rank ``r`` scores its
    contiguous block of every slot's page-table row (padded with -1 to a
    multiple of the axis size) — quantized pages through the codec score
    path, the open group through the fp residual — and the partials are
    merged across ``axis``:

    * ``merge="psum"`` — MAX / SUM all-reduces of the rescaled carries
      (:func:`merge_softmax_stats`); fp-tolerance against the
      single-process path (the reduction order differs), degenerate
      ranks guarded.
    * ``merge="allgather"`` — score rows and value rows gathered in mesh
      order and one softmax over the full row (:func:`allgather_concat`).

    Returns (S, Hq, d) on every rank."""
    if merge not in ("psum", "allgather"):
        raise ValueError(f"unknown merge {merge!r}")
    world = mesh.shape[axis]
    s, n = page_table.shape
    n_pad = -(-n // world) * world
    if n_pad != n:
        pad = torch.full((s, n_pad - n), -1, dtype=page_table.dtype,
                         device=page_table.device)
        page_table = torch.cat([page_table, pad], dim=1)
    g = cache.layout.page_size
    hq = q.shape[1]
    r = mesh.axis_index(axis)
    per = n_pad // world
    pt = page_table[:, r * per:(r + 1) * per]
    scores, values = _block_scores_values(cache, q, pt, r * per * g, scale)
    if merge == "allgather":
        scores = allgather_concat(scores, mesh, axis, axis=-1)
        values = allgather_concat(values, mesh, axis, axis=-2)
        _, l, acc = softmax_stats(scores, values)
    else:
        m, l, acc = softmax_stats(scores, values)
        _, l, acc = merge_softmax_stats(m, l, acc, mesh, axis)
    out = finalize_softmax(l, acc)                            # (S,Hkv,qpk,d)
    return out.reshape(s, hq, -1).to(q.dtype)
