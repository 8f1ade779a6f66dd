"""Decoder-only transformer LM over paged caches (port of the
continuous-batching entries of ``repro/models/transformer.py``).

A Python loop over the layers replaces ``_scan_segments``; the state is
one :class:`~repro_torch.core.paged_cache.PagedKVCache` per layer, all
sharing one page-table numbering and updated in place.

Params are a dict: ``embed`` (V, D), ``final_norm`` (D,), ``lm_head``
(D, V) unless embeddings are tied, and ``layers``, a list of
``{"ln1", "ln2", "attn": {wq, wk, wv, wo}, "ffn": {wg, wu, wd}}``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged_cache as pgc
from repro_torch.models import attn_block as AB
from repro_torch.models import layers as L
from repro_torch.utils import torch_dtype


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.scale_embedding:
        x = x * (cfg.d_model ** 0.5)
    return x


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def _block_prefill_paged(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                         cache, *, slot, page_row, true_len):
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    y, cache = AB.attention_prefill_paged(bp["attn"], h, cfg, cache,
                                          slot=slot, page_row=page_row,
                                          true_len=true_len)
    x = x + y
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp(bp["ffn"], h, cfg.act), cache


def _block_prefill_chunk(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                         cache, *, slot, page_row, start, chunk_len):
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    y, cache = AB.attention_prefill_chunk(bp["attn"], h, cfg, cache,
                                          slot=slot, page_row=page_row,
                                          start=start, chunk_len=chunk_len)
    x = x + y
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp(bp["ffn"], h, cfg.act), cache


def _block_decode_paged(bp: dict, x: torch.Tensor, cfg: ModelConfig, cache,
                        *, page_table, active):
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    y, cache = AB.attention_decode_paged(bp["attn"], h, cfg, cache,
                                         page_table=page_table,
                                         active=active)
    x = x + y
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + L.mlp(bp["ffn"], h, cfg.act), cache


def init_paged_caches(cfg: ModelConfig, layout, device) -> list:
    """One paged cache per layer, sharing one page-table numbering."""
    return [pgc.init_paged_cache(cfg.quant, layout, cfg.num_kv_heads,
                                 cfg.head_dim, dtype=torch_dtype(cfg.dtype),
                                 device=device)
            for _ in range(cfg.num_layers)]


@torch.no_grad()
def prefill_paged_fn(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                     caches: list, slot: int, page_row: torch.Tensor,
                     true_len: int):
    """Prefill ONE request into its slot's pages (in place).

    tokens: (1, Tp) int, Tp a bucket length (real prompt = first
    ``true_len``). Returns (last-real-token logits (1, V), caches)."""
    x = embed_tokens(params, tokens, cfg)
    for bp, cache in zip(params["layers"], caches):
        x, _ = _block_prefill_paged(bp, x, cfg, cache, slot=slot,
                                    page_row=page_row, true_len=true_len)
    logits = lm_logits(params, x[:, true_len - 1:true_len], cfg)
    return logits[:, 0], caches


@torch.no_grad()
def prefill_paged_chunk_fn(params: dict, tokens: torch.Tensor,
                           cfg: ModelConfig, caches: list, slot: int,
                           page_row: torch.Tensor, start: int,
                           chunk_len: int):
    """Prefill ONE fixed-size chunk of one request at absolute offset
    ``start`` (page-aligned; the engine drives chunks front to back), in
    place. tokens: (1, Tc) int (real tokens = first ``chunk_len``).
    Returns (logits of row ``chunk_len - 1`` (1, V), caches); they are
    meaningful only on a request's final chunk."""
    x = embed_tokens(params, tokens, cfg)
    for bp, cache in zip(params["layers"], caches):
        x, _ = _block_prefill_chunk(bp, x, cfg, cache, slot=slot,
                                    page_row=page_row, start=start,
                                    chunk_len=chunk_len)
    logits = lm_logits(params, x[:, chunk_len - 1:chunk_len], cfg)
    return logits[:, 0], caches


def copy_state_pages(caches: list, src: int, dst: int) -> list:
    """Copy pool page ``src`` -> ``dst`` in every layer's pools, in place —
    the device half of a COW split (DESIGN.md §12)."""
    for c in caches:
        pgc.copy_pool_pages(c, src, dst)
    return caches


@torch.no_grad()
def decode_paged_fn(params: dict, caches: list, token: torch.Tensor,
                    page_table: torch.Tensor, active: torch.Tensor,
                    cfg: ModelConfig):
    """Batched decode step over all slots (in place). token: (S,) int ->
    (logits (S, V), caches). Inactive slots produce don't-care logits and
    leave their cache state untouched (lengths included). ``page_table``
    may be width-sliced to the live pages."""
    x = embed_tokens(params, token[:, None], cfg)
    for bp, cache in zip(params["layers"], caches):
        x, _ = _block_decode_paged(bp, x, cfg, cache, page_table=page_table,
                                   active=active)
    logits = lm_logits(params, x, cfg)
    return logits[:, 0], caches
