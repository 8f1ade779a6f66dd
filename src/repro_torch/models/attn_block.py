"""GQA attention block over the paged quantized KV cache (port of the
paged entries of ``repro/models/attn_block.py``).

* ``attention_prefill_paged`` — one request's prompt: causal flash
  attention (the flash-prefill kernel) + the paged cache fill (the encode
  kernel writes the prompt's key groups into their pages).
* ``attention_decode_paged`` — one token per slot: append (residual
  write + masked group flush through the encode kernel) and page-native
  LUT decode attention (the paged-decode kernel).

Blocks call ``paged_cache`` directly; this slice has no mesh dispatch.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged_cache as pgc
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def _project(params: dict, x: torch.Tensor, cfg: ModelConfig):
    q = L.split_heads(L.linear(x, params["wq"], params.get("bq")),
                      cfg.num_heads)
    k = L.split_heads(L.linear(x, params["wk"], params.get("bk")),
                      cfg.num_kv_heads)
    v = L.split_heads(L.linear(x, params["wv"], params.get("bv")),
                      cfg.num_kv_heads)
    return q, k, v


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
    cache = pgc.paged_prefill(cache, slot, page_row, k, v, true_len)
    out = ops.flash_prefill(q, k, v, causal=True)
    return L.linear(L.merge_heads(out), params["wo"]), cache


def attention_decode_paged(params: dict, x: torch.Tensor, cfg: ModelConfig,
                           cache: pgc.PagedKVCache, *,
                           page_table: torch.Tensor, active: torch.Tensor):
    """Batched single-token decode over continuous-batching slots.

    x: (S, 1, D); every slot sits at its own position (cache.lengths), so
    RoPE uses per-slot positions and attention masks per-slot lengths.
    Returns (y (S, 1, D), cache)."""
    s = x.shape[0]
    q, k, v = _project(params, x, cfg)
    pos = cache.lengths[:, None]                          # (S, 1)
    q = L.apply_rope(q, pos, cfg.rope_base, cfg.rope_ntk_scale)
    k = L.apply_rope(k, pos, cfg.rope_base, cfg.rope_ntk_scale)
    cache = pgc.paged_append(cache, k, v, page_table, active)
    out = pgc.paged_decode_attention(cache, q[:, :, 0], page_table)
    return L.linear(out.reshape(s, 1, -1), params["wo"]), cache
