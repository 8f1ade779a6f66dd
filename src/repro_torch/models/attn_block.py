"""GQA attention block over the quantized KV caches (port of the dense,
paged and forward encoder-decoder entries of
``repro/models/attn_block.py``).

* ``make_cache`` — one layer's dense cache: capacity rounded up to a
  group multiple; a linear layout, or for a windowed config a ring of
  ``min(max_len, window)`` slots.
* ``attention_train`` — attention over a whole sequence with no cache
  (every family's training loss, and the encoder-decoder's encoder and
  prefill cross-attention): RoPE'd self-attention in ``mask_mode``
  (``prefix_len``, ``window`` as the prefill's), or with ``memory``
  cross-attention — K/V from the encoder memory, no RoPE, mode ``full``,
  Tq != Tk. Where JAX runs the jnp ``flash_attention``, inputs that need
  a gradient go through the differentiable ``core.attention.
  flash_attention`` (the flash-prefill kernel with its log-sum-exp, and
  the ported backward); the serving calls, under ``torch.no_grad``,
  through the forward-only flash-prefill kernel.
* ``cross_attention_cache`` — a decoder layer's cross cache filled from
  the un-rotated memory K/V (the encode kernel).
* ``attention_prefill`` — the static batch's prompt: flash attention in
  mask mode ``causal``, ``prefix`` (the VLM's image + prefix text,
  ``prefix_len`` per row) or ``local`` (``window``) — the flash-prefill
  kernel, where JAX runs the jnp ``flash_attention`` — + the dense cache
  fill (the encode kernel).
* ``attention_decode`` — one token per row over the dense cache: append
  (residual write, group flush through the encode kernel) and decode
  attention on ``cfg.decode_backend``: ``"jnp"`` through the score-only
  LUT kernel + softmax, ``"paged_fused"`` and ``"gathered"`` through the
  fused dense kernel (JAX's ``_dense_kernel_backend`` mapping); codecs
  without a fused kernel, and windowed (ring) layers, take the ``"jnp"``
  route. ``cross=True``: a static cross cache — no RoPE, no append, and
  the score route on any backend, as JAX.
* ``attention_prefill_paged`` — one request's prompt: causal flash
  attention (the flash-prefill kernel) + the paged cache fill (the encode
  kernel writes the prompt's key groups into their pages).
* ``attention_prefill_chunk`` — one prefill chunk at a page-aligned
  offset: the paged cache fill at ``start`` + attention over the
  quantized prefix and the chunk's own causal tile on
  ``cfg.prefill_backend`` (``"paged_fused"``: the paged-prefill kernel
  walks the pages in place; ``"jnp"``, and every codec without that
  kernel: ``chunk_prefill_attention`` over a gathered copy).
* ``attention_decode_paged`` — one token per slot: append (residual
  write + masked group flush through the encode kernel) and page-native
  decode attention on ``cfg.decode_backend`` (``"paged_fused"``: the
  paged-decode kernel walks the pages in place); ``return_kv`` also
  returns the step's post-RoPE kv for the speculative scan verifier.
* ``attention_verify_span`` — Q speculative span positions per slot in
  one attention call over the unmodified cache (the score-only LUT
  kernel with the span folded onto the query-head axis, plus the flush
  emulation's encode); the projections run per span column.

The paged attention sites (whole-prompt and chunk prefill, decode, the
span verify) and the dense cache's prefill and decode go through
``distributed/serving.py``'s dispatch, as JAX's do: when the engine
installed a mesh and the cache is one rank's head shard, the rank writes
its block of the step's k/v, attends over its head block and gathers the
heads before ``wo``; otherwise the plain calls run. (The cross cache of
the encoder-decoder is never sharded: that family is refused under a
mesh.)
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kv_cache as kvc
from repro_torch.core import paged_cache as pgc
from repro_torch.core.attention import flash_attention
from repro_torch.core.cache_layout import LinearLayout, RingLayout
from repro_torch.distributed import serving as dsrv
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.utils import torch_dtype


def init_attention(cfg: ModelConfig, generator: torch.Generator | None,
                   device, dtype: torch.dtype) -> dict:
    """``wq``, ``wk``, ``wv``, ``wo`` at JAX's ``init_attention`` scales (and
    zero fp32 q/k/v biases where the config has them)."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    p = {n: L.dense_init(a, b, generator, device, dtype) for n, a, b in (
        ("wq", d, hq), ("wk", d, hkv), ("wv", d, hkv), ("wo", hq, d))}
    if cfg.qkv_bias:
        p.update({n: torch.zeros(w, device=device)
                  for n, w in (("bq", hq), ("bk", hkv), ("bv", hkv))})
    return p


def _project(params: dict, x: torch.Tensor, cfg: ModelConfig):
    q = L.split_heads(L.linear(x, params["wq"], params.get("bq")),
                      cfg.num_heads)
    k = L.split_heads(L.linear(x, params["wk"], params.get("bk")),
                      cfg.num_kv_heads)
    v = L.split_heads(L.linear(x, params["wv"], params.get("bv")),
                      cfg.num_kv_heads)
    return q, k, v


def make_cache(cfg: ModelConfig, batch: int, max_len: int, layer: int = 0,
               device=None,
               head_shard: tuple[int, int] | None = None) -> kvc.KVCache:
    """Allocate layer ``layer``'s dense cache under
    ``cfg.policy.layer_config(layer)`` on ``device`` (the card unless
    named). A windowed config gets a ring of ``min(max_len, window)``
    slots, any other a linear cache of ``max_len``; the capacity rounds up
    to the layer's group multiple, as the residual's ``slot % g`` tiling
    needs. ``head_shard = (r, n)``: the cache holds block ``r`` of ``n``
    of the KV heads (a rank of a mesh that splits them)."""
    quant = cfg.policy.layer_config(layer)
    cap = min(max_len, cfg.window) if cfg.window else max_len
    g = quant.group_size
    cap = -(-cap // g) * g
    layout = RingLayout(cap) if cfg.window else LinearLayout(cap)
    return kvc.init_cache(quant, batch, cfg.num_kv_heads, cfg.head_dim,
                          cap, dtype=torch_dtype(cfg.dtype), device=device,
                          layout=layout, head_shard=head_shard)


def attention_train(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    mask_mode: str = "causal",
                    prefix_len: torch.Tensor | None = None,
                    memory: torch.Tensor | None = None,
                    window: int = 0) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D), no cache, in ``mask_mode`` (``causal``,
    ``full``, ``prefix`` with ``prefix_len`` (B,) int32, ``local`` with
    ``window``). ``memory`` (B, Tm, D) switches to cross-attention: K/V
    from memory, no RoPE on keys or queries, mode ``full``."""
    if memory is None:
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        q, k, v = _project(params, x, cfg)
        q = L.apply_rope(q, positions, cfg.rope_base, cfg.rope_ntk_scale)
        k = L.apply_rope(k, positions, cfg.rope_base, cfg.rope_ntk_scale)
    else:
        q = L.split_heads(L.linear(x, params["wq"], params.get("bq")),
                          cfg.num_heads)
        k, v = _memory_kv(params, memory, cfg)
        mask_mode = "full"
    kw = dict(mode=mask_mode, window=window, prefix_len=prefix_len)
    if q.requires_grad or k.requires_grad or v.requires_grad:
        out = flash_attention(q, k, v, **kw)
    else:
        out = ops.flash_prefill(q.contiguous(), k.contiguous(),
                                v.contiguous(), **kw)
    return L.linear(L.merge_heads(out), params["wo"])


def _memory_kv(params: dict, memory: torch.Tensor, cfg: ModelConfig):
    """Un-rotated K/V (B, Hkv, Tm, d) of the encoder memory."""
    k = L.split_heads(L.linear(memory, params["wk"], params.get("bk")),
                      cfg.num_kv_heads)
    v = L.split_heads(L.linear(memory, params["wv"], params.get("bv")),
                      cfg.num_kv_heads)
    return k, v


def cross_attention_cache(params: dict, memory: torch.Tensor,
                          cfg: ModelConfig,
                          cache: kvc.KVCache) -> kvc.KVCache:
    """Fill a cross-attention cache from encoder memory (B, Tm, D), no
    RoPE, in place."""
    k, v = _memory_kv(params, memory, cfg)
    return kvc.prefill(cache, k.contiguous(), v.contiguous())


def attention_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                      cache: kvc.KVCache, *, mask_mode: str = "causal",
                      prefix_len: torch.Tensor | None = None,
                      window: int = 0):
    """Attention over the static batch's prompt in ``mask_mode`` (causal,
    prefix with ``prefix_len`` (B,) int32, local with ``window``) + bulk
    cache fill. x: (B, T, D). Returns (y (B, T, D), cache)."""
    t = x.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=x.device)
    q, k, v = _project(params, x, cfg)
    q = L.apply_rope(q, positions, cfg.rope_base, cfg.rope_ntk_scale)
    k = L.apply_rope(k, positions, cfg.rope_base, cfg.rope_ntk_scale)
    v = v.contiguous()
    cache = kvc.prefill(cache, dsrv.local_heads(cache, k),
                        dsrv.local_heads(cache, v))
    out = dsrv.dispatch_flash_prefill(cache, q, k, v, mode=mask_mode,
                                      window=window, prefix_len=prefix_len)
    return L.linear(L.merge_heads(out), params["wo"]), cache


def attention_decode(params: dict, x: torch.Tensor, cfg: ModelConfig,
                     cache: kvc.KVCache, *, window: int = 0,
                     cross: bool = False):
    """Single-token decode of every row at the shared position
    ``cache.length``. x: (B, 1, D). ``window > 0``: a ring cache's local
    attention, which stays on the score route (the fused kernel assumes
    linear placement). ``cross``: attention over a static cross cache —
    no RoPE, no append, the score route. Returns (y (B, 1, D), cache)."""
    b = x.shape[0]
    if cross:
        q = L.split_heads(L.linear(x, params["wq"], params.get("bq")),
                          cfg.num_heads)
        out = kvc.decode_attention(cache, q[:, :, 0])
        return L.linear(out.reshape(b, 1, -1), params["wo"]), cache
    q, k, v = _project(params, x, cfg)
    pos = cache.length.reshape(1)
    q = L.apply_rope(q, pos, cfg.rope_base, cfg.rope_ntk_scale)
    k = L.apply_rope(k, pos, cfg.rope_base, cfg.rope_ntk_scale)
    cache = kvc.append(cache, dsrv.local_heads(cache, k),
                       dsrv.local_heads(cache, v))
    if (cfg.decode_backend != "jnp" and cache.codec.supports_fused_decode
            and window == 0):
        out = dsrv.dispatch_fused_decode_attention(cache, q[:, :, 0])
    else:
        out = dsrv.dispatch_decode_attention(cache, q[:, :, 0],
                                             window=window)
    return L.linear(out.reshape(b, 1, -1), params["wo"]), cache


def attention_prefill_paged(params: dict, x: torch.Tensor, cfg: ModelConfig,
                            cache: pgc.PagedKVCache, *, slot: int,
                            page_row: torch.Tensor, true_len: int):
    """x: (1, Tp, D), Tp a bucket length; real tokens are ``[0, true_len)``.
    Causal masking keeps the padding tail from touching real positions.
    Returns (y (1, Tp, D), cache)."""
    t = x.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=x.device)
    q, k, v = _project(params, x, cfg)
    q = L.apply_rope(q, positions, cfg.rope_base, cfg.rope_ntk_scale)
    k = L.apply_rope(k, positions, cfg.rope_base, cfg.rope_ntk_scale)
    v = v.contiguous()
    cache = pgc.paged_prefill(cache, slot, page_row,
                              dsrv.local_heads(cache, k),
                              dsrv.local_heads(cache, v), true_len)
    out = dsrv.dispatch_flash_prefill(cache, q, k, v)
    return L.linear(L.merge_heads(out), params["wo"]), cache


def attention_prefill_chunk(params: dict, x: torch.Tensor, cfg: ModelConfig,
                            cache: pgc.PagedKVCache, *, slot: int,
                            page_row: torch.Tensor, start: int,
                            chunk_len: int):
    """One prefill chunk's attention + paged cache fill at offset
    ``start`` (page-aligned). x: (1, Tc, D), real tokens ``[0,
    chunk_len)``. RoPE runs at the absolute positions ``start + i``; the
    queries attend to the slot's quantized prefix ``[0, start)`` and, fp
    causally, to the chunk. Returns (y (1, Tc, D), cache)."""
    t = x.shape[1]
    positions = start + torch.arange(t, dtype=torch.int32, device=x.device)
    q, k, v = _project(params, x, cfg)
    q = L.apply_rope(q, positions, cfg.rope_base, cfg.rope_ntk_scale)
    k = L.apply_rope(k, positions, cfg.rope_base, cfg.rope_ntk_scale)
    v = v.contiguous()
    cache = pgc.paged_prefill(cache, slot, page_row,
                              dsrv.local_heads(cache, k),
                              dsrv.local_heads(cache, v), chunk_len,
                              start=start)
    out = dsrv.dispatch_paged_prefill_attention(
        cache, q, k, v, page_row, start, chunk_len,
        backend=cfg.prefill_backend)
    return L.linear(L.merge_heads(out), params["wo"]), cache


def attention_decode_paged(params: dict, x: torch.Tensor, cfg: ModelConfig,
                           cache: pgc.PagedKVCache, *,
                           page_table: torch.Tensor, active: torch.Tensor,
                           return_kv: bool = False):
    """Batched single-token decode over continuous-batching slots.

    x: (S, 1, D); every slot sits at its own position (cache.lengths), so
    RoPE uses per-slot positions and attention masks per-slot lengths.
    Returns (y (S, 1, D), cache) — or (y, cache, (k, v)) with
    ``return_kv``: the post-RoPE kv (S, Hkv, 1, hd) the speculative scan
    verifier re-commits for accepted positions."""
    s = x.shape[0]
    q, k, v = _project(params, x, cfg)
    pos = cache.lengths[:, None]                          # (S, 1)
    q = L.apply_rope(q, pos, cfg.rope_base, cfg.rope_ntk_scale)
    k = L.apply_rope(k, pos, cfg.rope_base, cfg.rope_ntk_scale)
    cache = pgc.paged_append(cache, dsrv.local_heads(cache, k),
                             dsrv.local_heads(cache, v), page_table, active)
    out = dsrv.dispatch_paged_decode_attention(cache, q[:, :, 0], page_table,
                                               backend=cfg.decode_backend)
    y = L.linear(out.reshape(s, 1, -1), params["wo"])
    if return_kv:
        return y, cache, (k, v)
    return y, cache


def attention_verify_span(params: dict, x: torch.Tensor, cfg: ModelConfig,
                          cache: pgc.PagedKVCache, *,
                          page_table: torch.Tensor):
    """Speculative-span attention block (port of
    ``repro/models/attn_block.py:236-258``): Q positions per slot, cache
    untouched (the accepted positions are appended later through
    ``paged_append_span``).

    x: (S, Q, D) at absolute positions ``cache.lengths + [0, Q)``. The
    projections, RoPE and the output projection run per span column at
    the one-token step's shape (``L.per_column``), so every column has
    the decode step's bits. Returns (y (S, Q, D), (k, v)) with the span's
    post-RoPE kv (S, Hkv, Q, hd) for the commit."""
    s, qn, _ = x.shape
    qs, ks, vs = [], [], []
    for i in range(qn):
        q, k, v = _project(params, x[:, i:i + 1].contiguous(), cfg)
        pos = cache.lengths[:, None] + i                  # (S, 1)
        qs.append(L.apply_rope(q, pos, cfg.rope_base, cfg.rope_ntk_scale))
        ks.append(L.apply_rope(k, pos, cfg.rope_base, cfg.rope_ntk_scale))
        vs.append(v)
    k, v = torch.cat(ks, dim=2), torch.cat(vs, dim=2)
    out = dsrv.dispatch_span_verify_attention(
        cache, torch.cat(qs, dim=2), k, v, page_table)    # (S, Hq, Q, hd)
    y = L.per_column(lambda o: L.linear(o.reshape(s, 1, -1), params["wo"]),
                     out.transpose(1, 2))
    return y, (k, v)
