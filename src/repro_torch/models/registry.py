"""Model interface over the serving entries of every family: dense, MoE,
VLM, hybrid, encoder-decoder and SSM (port of
``repro/models/registry.py:34-72,106-195``).

``get_model(cfg)`` returns a :class:`Model` bundle:
  init(generator, device) -> params
  loss(params, batch, remat="block", ce_chunk=512) -> (loss, metrics) —
      the training loss: batch["tokens"] (B, T+1) (+ "patches" for the
      VLM, "frames" for the encoder-decoder); metrics {"ce", "aux"} for
      the dense, MoE and VLM families, {"ce"} for the others, as JAX
  init_decode_state(batch, max_len, device, **blocks) -> the decode state:
      a list of per-layer KVCaches (dense, MoE, VLM), of ring caches and
      RG-LRU states (hybrid) or of (conv, SSD) states (SSM), or the
      encoder-decoder's {"self": [...], "cross": [...]} caches. Under a
      serving mesh, ``blocks`` holds this rank's block (r, n) of each
      logical axis the state splits over (:data:`STATE_BLOCK_KW`):
      ``head_shard`` of the KV heads (every family with caches),
      ``rec_shard`` of the RG-LRU width, ``ssm_shard`` of the SSD heads
  prefill(params, {"tokens": (B, T)[, "patches" | "frames": (B, Nf, F)]},
          state) -> (last logits (B, V), state)
  decode(params, state, token (B,)) -> (logits (B, V), state)
  cache_layer_bytes(state) -> physical cache bytes per layer (None for the
      hybrid, encoder-decoder and SSM families, as JAX)
  input_specs(shape) -> {name: ShapeDtype} — a shape's step inputs
      (JAX's ``_token_specs``: tokens, and the VLM's ``patches`` or the
      encoder-decoder's ``frames``), the dry run's stand-ins
  decode_state_specs(shape, **kw) -> the decode state of the shape's
      batch and length on the meta device (shapes, no values)
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

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm_lm as SSM
from repro_torch.models import transformer as TF
from repro_torch.utils import ShapeDtype, torch_dtype


#: the ``init_decode_state`` keyword of each logical axis a decode state
#: may split over (``serving_rules``' names)
STATE_BLOCK_KW = {"kv_heads": "head_shard", "rec_width": "rec_shard",
                  "ssm_heads": "ssm_shard"}

#: the logical axes of each family's decode state (every other family's:
#: its caches' KV heads)
_STATE_AXES = {"hybrid": ("kv_heads", "rec_width"), "ssm": ("ssm_heads",)}


def state_split_axes(cfg: ModelConfig, mesh) -> dict:
    """The serving placement of ``cfg``'s decode state on ``mesh``
    (DESIGN.md §17): for each logical axis the family's state has —
    ``kv_heads`` (every cache), ``rec_width`` (the RG-LRU states),
    ``ssm_heads`` (the SSD states and their heads' conv channels) — the
    mesh axis ``serving_rules`` splits it over, None where every rank
    holds it whole (the GQA fallback; an RG-LRU width whose gates'
    diagonal blocks do not split with it, :func:`~repro_torch.models.
    rglru.splits`). The SSM family has no KV heads: JAX's rule maps its
    ``num_kv_heads`` of 0 to ``model``, a split of caches that do not
    exist, and it is not read. ``mesh`` needs only its ``shape``."""
    from repro_torch.distributed.sharding import serving_rules
    from repro_torch.models import rglru
    rules = serving_rules(cfg, mesh, 1)   # these rules ignore the batch
    out = {}
    for name in _STATE_AXES.get(cfg.family, ("kv_heads",)):
        axis = rules.get(name)
        if not isinstance(axis, str) or (name == "rec_width" and not
                                         rglru.splits(cfg, mesh.shape[axis])):
            axis = None
        out[name] = axis
    return out


def state_block_kwargs(blocks: dict) -> dict:
    """``init_decode_state``'s keywords for ``blocks`` (logical axis ->
    (r, n) or None): the blocks that are split."""
    return {STATE_BLOCK_KW[k]: v for k, v in blocks.items()
            if v is not None}


def state_part_bytes(state) -> dict:
    """A static decode state's bytes by part, the whole length scalars left
    out: ``kv`` / ``ring`` (a list's linear or ring caches), ``self`` /
    ``cross`` (the encoder-decoder's), ``rg_conv`` / ``rg_h`` (the RG-LRU
    states), ``ssd_conv`` / ``ssd`` (the SSM's) — the parts a mesh splits
    apart."""
    from repro_torch.core.cache_layout import RingLayout
    from repro_torch.core.kv_cache import KVCache
    from repro_torch.utils import tree_bytes
    parts: dict = {}

    def add(k, n):
        parts[k] = parts.get(k, 0) + n
    for name, layers in (state.items() if isinstance(state, dict)
                         else [(None, state)]):
        for x in layers:
            if isinstance(x, KVCache):
                kind = name or ("ring" if isinstance(x.layout, RingLayout)
                                else "kv")
                add(kind, tree_bytes(x) - x.length.numel()
                    * x.length.element_size())
            else:   # an RG-LRU (conv, h) or an SSM (conv, SSD) state
                ssd = x[1].ndim == 5
                add("ssd_conv" if ssd else "rg_conv", tree_bytes(x[0]))
                add("ssd" if ssd else "rg_h", tree_bytes(x[1]))
    return parts


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

    def input_specs(self, shape: ShapeConfig) -> dict:
        """JAX's ``_token_specs`` (``repro/models/registry.py:83-110``):
        train ``tokens`` (B, T+1) and prefill ``tokens`` (B, T), each T
        less the VLM's ``frontend_tokens``, with the VLM's ``patches`` or
        the encoder-decoder's ``frames`` (B, frontend_tokens,
        frontend_dim) in the model dtype; decode one ``token`` (B,)."""
        cfg = self.cfg
        b, t = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"token": ShapeDtype((b,), torch.int32)}
        text = t - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
        specs = {"tokens": ShapeDtype((b, text + (shape.kind == "train")),
                                      torch.int32)}
        front = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
        if front:
            specs[front] = ShapeDtype(
                (b, cfg.frontend_tokens, cfg.frontend_dim),
                torch_dtype(cfg.dtype))
        return specs

    def decode_state_specs(self, shape: ShapeConfig, **kw):
        """The decode state of ``shape.global_batch`` rows and
        ``shape.seq_len`` positions on the meta device (``kw``: the
        family's ``init_decode_state`` options, e.g. ``head_shard``)."""
        return self.init_decode_state(shape.global_batch, shape.seq_len,
                                      "meta", **kw)


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
            init_decode_state=lambda batch, max_len, device,
            head_shard=None, rec_shard=None: HY.init_decode_state(
                cfg, batch, max_len, device, head_shard, rec_shard),
            prefill=lambda p, b, s: HY.prefill_fn(p, b, cfg, s),
            decode=lambda p, s, t: HY.decode_fn(p, s, t, cfg),
            loss=lambda p, b, **kw: HY.lm_loss(p, b, cfg, **kw))
    if cfg.family == "encdec":
        return Model(
            cfg=cfg, init=init,
            init_decode_state=lambda batch, max_len, device,
            head_shard=None: ED.init_decode_state(cfg, batch, max_len,
                                                  device, head_shard),
            prefill=lambda p, b, s: ED.prefill_fn(p, b, cfg, s),
            decode=lambda p, s, t: ED.decode_fn(p, s, t, cfg),
            loss=lambda p, b, **kw: ED.lm_loss(p, b, cfg, **kw))
    if cfg.family == "ssm":
        return Model(
            cfg=cfg, init=init,
            init_decode_state=lambda batch, max_len, device,
            ssm_shard=None: SSM.init_decode_state(cfg, batch, device,
                                                  ssm_shard),
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
