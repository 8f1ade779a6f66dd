"""Model interface over the serving entries of every family: dense, MoE,
VLM, hybrid, encoder-decoder and SSM (port of
``repro/models/registry.py:34-72,106-195``).

``get_model(cfg)`` returns a :class:`Model` bundle:
  init(generator, device) -> params
  loss(params, batch, remat="block", ce_chunk=512) -> (loss, metrics) —
      the training loss: batch["tokens"] (B, T+1) (+ "patches" for the
      VLM, "frames" for the encoder-decoder); metrics {"ce", "aux"} for
      the dense, MoE and VLM families, {"ce"} for the others, as JAX
  init_decode_state(batch, max_len, device) -> the decode state: a list of
      per-layer KVCaches (dense, MoE, VLM; these also take
      ``head_shard=(r, n)``: block r of n of the KV heads), of ring caches
      and RG-LRU states (hybrid) or of (conv, SSD) states (SSM), or the
      encoder-decoder's {"self": [...], "cross": [...]} caches
  prefill(params, {"tokens": (B, T)[, "patches" | "frames": (B, Nf, F)]},
          state) -> (last logits (B, V), state)
  decode(params, state, token (B,)) -> (logits (B, V), state)
  cache_layer_bytes(state) -> physical cache bytes per layer (None for the
      hybrid, encoder-decoder and SSM families, as JAX)
The paged entries below are None for the VLM, hybrid, encoder-decoder
and SSM families, which JAX serves on the static engine only (the VLM
and encoder-decoder prefills need their frontends; the paged attention
has no sliding-window mask; the SSM has no KV cache):
  init_paged_state(layout, device, head_shard=None) -> list of per-layer
      PagedKVCaches (``head_shard = (r, n)``: block r of n of the KV heads)
  prefill_paged(params, tokens (1,Tp), state, slot, page_row, true_len)
  prefill_paged_chunk(params, tokens (1,Tc), state, slot, page_row, start,
                      chunk_len)
  decode_paged(params, state, token (S,), page_table, active)
  decode_runahead(params, state, token (S,), page_table, active, generator,
                  remaining, done, *, horizon, temperature, top_k, eos_id)
      — H decode micro-steps with on-device sampling + EOS/budget masking
      and no host sync (DESIGN.md §18); returns the (H, S) token block
      plus the carries that seed the next horizon
  copy_pages(state, src, dst) — COW page copy across every layer's pools
  decode_paged_collect(params, state, token (S,), page_table, active) /
  commit_paged(state, kvs, page_table, keep) — the speculative scan
      verifier's split: decode_paged that also returns each layer's
      post-RoPE kv, and the re-append of one span position's saved kv
  verify_span(params, state, tokens (S, Q), page_table, active) ->
      (logits (S, Q, V), kvs) / commit_span(state, kvs, page_table,
      n_keep) — the span verifier's pair: all Q span positions in one
      pass, then one fused multi-row append per layer (spec/verify.py
      picks the pair per cfg.decode_backend)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm_lm as SSM
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., dict]
    init_decode_state: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    loss: Callable[..., Any]
    cache_layer_bytes: Callable[[Any], list[int]] | None = None
    init_paged_state: Callable[..., Any] | None = None
    prefill_paged: Callable[..., Any] | None = None
    prefill_paged_chunk: Callable[..., Any] | None = None
    decode_paged: Callable[..., Any] | None = None
    decode_runahead: Callable[..., Any] | None = None
    copy_pages: Callable[..., Any] | None = None
    decode_paged_collect: Callable[..., Any] | None = None
    commit_paged: Callable[..., Any] | None = None
    verify_span: Callable[..., Any] | None = None
    commit_span: Callable[..., Any] | None = None


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in ("dense", "moe", "vlm") and not cfg.policy.is_uniform:
        # JAX's refusal and message, kept for parity (the port's per-layer
        # state list could hold mixed caches)
        raise ValueError(
            f"per-layer cache policies are not supported for the "
            f"{cfg.family!r} family (its decode state stacks one cache "
            "shape across layers)")
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "encdec", "ssm"):
        raise ValueError(f"unknown family {cfg.family!r}")
    from repro_torch.weights import init_params

    def init(generator=None, device=None):
        return init_params(cfg, generator=generator, device=device)
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg, init=init,
            init_decode_state=lambda batch, max_len, device:
                HY.init_decode_state(cfg, batch, max_len, device),
            prefill=lambda p, b, s: HY.prefill_fn(p, b, cfg, s),
            decode=lambda p, s, t: HY.decode_fn(p, s, t, cfg),
            loss=lambda p, b, **kw: HY.lm_loss(p, b, cfg, **kw))
    if cfg.family == "encdec":
        return Model(
            cfg=cfg, init=init,
            init_decode_state=lambda batch, max_len, device:
                ED.init_decode_state(cfg, batch, max_len, device),
            prefill=lambda p, b, s: ED.prefill_fn(p, b, cfg, s),
            decode=lambda p, s, t: ED.decode_fn(p, s, t, cfg),
            loss=lambda p, b, **kw: ED.lm_loss(p, b, cfg, **kw))
    if cfg.family == "ssm":
        return Model(
            cfg=cfg, init=init,
            init_decode_state=lambda batch, max_len, device:
                SSM.init_decode_state(cfg, batch, device),
            prefill=lambda p, b, s: SSM.prefill_fn(p, b, cfg, s),
            decode=lambda p, s, t: SSM.decode_fn(p, s, t, cfg),
            loss=lambda p, b, **kw: SSM.lm_loss(p, b, cfg, **kw))
    static = dict(
        cfg=cfg, init=init,
        init_decode_state=lambda batch, max_len, device, head_shard=None:
            TF.init_decode_caches(cfg, batch, max_len, device, head_shard),
        prefill=lambda p, b, s: TF.prefill_fn(p, b, cfg, s),
        decode=lambda p, s, t: TF.decode_fn(p, s, t, cfg),
        loss=lambda p, b, **kw: TF.lm_loss(p, b, cfg, **kw),
        cache_layer_bytes=TF.per_layer_cache_bytes)
    if cfg.family == "vlm" or cfg.window:
        return Model(**static)
    return Model(
        **static,
        init_paged_state=lambda layout, device, head_shard=None:
            TF.init_paged_caches(cfg, layout, device, head_shard),
        prefill_paged=lambda p, toks, s, slot, row, tl:
            TF.prefill_paged_fn(p, toks, cfg, s, slot, row, tl),
        prefill_paged_chunk=lambda p, toks, s, slot, row, start, cl:
            TF.prefill_paged_chunk_fn(p, toks, cfg, s, slot, row, start, cl),
        decode_paged=lambda p, s, t, table, active:
            TF.decode_paged_fn(p, s, t, table, active, cfg),
        decode_runahead=lambda p, s, t, table, active, generator, rem, done,
            horizon, temperature, top_k, eos_id: TF.decode_runahead_fn(
                p, s, t, table, active, generator, rem, done, cfg,
                horizon=horizon, temperature=temperature, top_k=top_k,
                eos_id=eos_id),
        copy_pages=TF.copy_state_pages,
        decode_paged_collect=lambda p, s, t, table, active:
            TF.decode_paged_collect_fn(p, s, t, table, active, cfg),
        commit_paged=lambda s, kv, table, keep:
            TF.commit_paged_fn(s, kv, table, keep, cfg),
        verify_span=lambda p, s, t, table, active:
            TF.verify_span_fn(p, s, t, table, active, cfg),
        commit_span=lambda s, kv, table, n_keep:
            TF.commit_span_paged_fn(s, kv, table, n_keep, cfg),
    )
