"""Decoder-only transformer LM over quantized caches (port of
``repro/models/transformer.py``: the training loss, and the serving
entries over the static batch's dense caches and continuous batching's
paged caches; the dense, MoE and prefix-LM VLM families).

Training: :func:`lm_loss` runs :func:`forward_hidden` (a Python loop of
:func:`block_train` over the layers, each recomputed in the backward
under ``remat="block"``; JAX scans them under ``jax.checkpoint``) and
:func:`lm_head_loss` (the cross entropy over token chunks, each chunk's
logits recomputed in the backward).

A Python loop over the layers replaces ``_scan_segments``; the state is
one cache per layer under that layer's config of ``cfg.policy`` (a mixed
policy needs no segments), updated in place: a dense
:class:`~repro_torch.core.kv_cache.KVCache` (static batch) or a
:class:`~repro_torch.core.paged_cache.PagedKVCache` (paged caches share
one page-table numbering).

:func:`sample_tokens` is the engine's sampling math (greedy argmax, or
temperature, top-k and Gumbel-max), and :func:`decode_runahead_fn` runs
``horizon`` decode micro-steps with it on the device (DESIGN.md §18).
The speculative verifiers' entries (DESIGN.md §15,
``repro/models/transformer.py:484-600``): :func:`decode_paged_collect_fn`
and :func:`commit_paged_fn` (the scan verifier's per-position step and
commit), :func:`verify_span_fn` and :func:`commit_span_paged_fn` (the
span verifier's one forward over the span and its fused commit).

Params are a dict: ``embed`` (V, D), ``final_norm`` (D,), ``lm_head``
(D, V) unless embeddings are tied, and ``layers``, a list of
``{"ln1", "ln2", "attn": {wq, wk, wv, wo}, "ffn": {wg, wu, wd}}`` — for
the MoE family ``ffn`` is ``{router, wg, wu, wd}`` with expert-stacked
matrices, plus ``shared`` ``{wg, wu, wd}`` where the config has shared
experts (:func:`ffn_apply`). The VLM family adds ``projector``
(frontend_dim, D): :func:`prefill_fn` projects the stubbed frontend's
patch embeddings with it and prepends them to the text under a prefix-LM
mask; the VLM has static entries only, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import paged_cache as pgc
from repro_torch.distributed import serving as dsrv
from repro_torch.models import attn_block as AB
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.utils import torch_dtype, tree_bytes


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


def lm_head_loss(params: dict, h: torch.Tensor, labels: torch.Tensor,
                 cfg: ModelConfig, ce_chunk: int = 512) -> torch.Tensor:
    """Cross entropy of the head over h (B, T, D) without keeping (B, T, V)
    fp32 logits: over chunks of ``ce_chunk`` tokens, each chunk's logits
    recomputed in the backward. Single-shot when ``ce_chunk <= 0``, T <=
    ``ce_chunk`` or T is not a multiple of it, as JAX."""
    t = h.shape[1]
    if ce_chunk <= 0 or t <= ce_chunk or t % ce_chunk:
        return L.cross_entropy_loss(lm_logits(params, h, cfg), labels)

    def body(hx, lx):
        logits = lm_logits(params, hx, cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lx.clamp(min=0)[..., None])[..., 0]
        mask = (lx != -1).float()
        return torch.sum((lse - ll) * mask), torch.sum(mask)

    body = L.remat(body, "block")
    nll = n = torch.zeros((), device=h.device)
    for c0 in range(0, t, ce_chunk):
        a, m = body(h[:, c0:c0 + ce_chunk], labels[:, c0:c0 + ce_chunk])
        nll, n = nll + a, n + m
    return nll / torch.clamp_min(n, 1.0)


def ffn_apply(bp: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The block's FFN by family: the routed experts (``moe_ffn``, capacity
    over each batch row's tokens) or the dense SwiGLU."""
    if cfg.family == "moe":
        return MOE.moe_ffn(bp["ffn"], h, cfg)
    return L.mlp(bp["ffn"], h, cfg.act)


def block_train(bp: dict, x: torch.Tensor, cfg: ModelConfig, *,
                mask_mode: str, prefix_len: Optional[torch.Tensor],
                window: int = 0):
    """One block over a whole sequence, no cache: (x, the MoE aux loss, 0
    for a dense FFN)."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    x = x + AB.attention_train(bp["attn"], h, cfg, mask_mode=mask_mode,
                               prefix_len=prefix_len, window=window)
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = MOE.moe_ffn_train(bp["ffn"], h, cfg)
    else:
        f, aux = L.mlp(bp["ffn"], h, cfg.act), torch.zeros((), device=x.device)
    return x + f, aux


def forward_hidden(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   mask_mode: str = "causal",
                   prefix_len: Optional[torch.Tensor] = None,
                   remat: str = "block"):
    """The layer stack over x (B, T, D): (hidden, the aux losses summed
    over the layers)."""
    def body(lp, h):
        return block_train(lp, h, cfg, mask_mode=mask_mode,
                           prefix_len=prefix_len, window=cfg.window)

    body = L.remat(body, remat)
    aux = torch.zeros((), device=x.device)
    for lp in params["layers"]:
        x, a = body(lp, x)
        aux = aux + a
    return x, aux


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            remat: str = "block", ce_chunk: int = 512):
    """batch["tokens"]: (B, T+1) int (the VLM also ``patches`` (B,
    frontend_tokens, frontend_dim), prepended under the prefix-LM mask and
    dropped before the head). Returns (ce + aux, {"ce", "aux"})."""
    tokens = batch["tokens"].long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    mask_mode = "causal" if cfg.window == 0 else "local"
    x = embed_tokens(params, inputs, cfg)
    prefix_len = None
    if cfg.family == "vlm":
        px = L.linear(batch["patches"].to(x.dtype), params["projector"])
        x = torch.cat([px, x], dim=1)
        prefix_len = torch.full((x.shape[0],), cfg.frontend_tokens,
                                dtype=torch.int32, device=x.device)
        mask_mode = "prefix"
    h, aux = forward_hidden(params, x, cfg, mask_mode=mask_mode,
                            prefix_len=prefix_len, remat=remat)
    if cfg.family == "vlm":
        h = h[:, cfg.frontend_tokens:]
    loss = lm_head_loss(params, h, labels, cfg, ce_chunk)
    return loss + aux, {"ce": loss, "aux": aux}


def _block(bp: dict, x: torch.Tensor, cfg: ModelConfig, attn, cache, **kw):
    """Pre-norm residual block around the attention entry ``attn``."""
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    y, cache = attn(bp["attn"], h, cfg, cache, **kw)
    x = x + y
    h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + ffn_apply(bp, h, cfg), cache


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device,
                       head_shard: Optional[tuple[int, int]] = None) -> list:
    """One dense cache per layer for a static batch of ``batch`` rows,
    each under its layer's ``cfg.policy`` config. ``head_shard = (r, n)``:
    each holds block ``r`` of ``n`` of the KV heads (a rank of a mesh
    that splits them, ``distributed/serving.py``)."""
    return [AB.make_cache(cfg, batch, max_len, layer=i, device=device,
                          head_shard=head_shard)
            for i in range(cfg.num_layers)]


def per_layer_cache_bytes(caches: list) -> list[int]:
    """Physical cache bytes of each layer (equal, for a segment of layers
    under one config, to JAX's segment-averaged figure)."""
    return [tree_bytes(c) for c in caches]


@torch.no_grad()
def prefill_fn(params: dict, batch: dict, cfg: ModelConfig, caches: list):
    """Prefill the static batch into its dense caches (in place).
    batch["tokens"]: (B, T) int; for the VLM also batch["patches"] (B,
    frontend_tokens, frontend_dim): projected (cast to the model dtype,
    not scaled by the embedding scale) and prepended to the text, with
    the prefix-LM mask bidirectional over the ``frontend_tokens`` image
    positions. Returns (last-token logits (B, V), caches)."""
    x = embed_tokens(params, batch["tokens"], cfg)
    mask_mode = "causal" if cfg.window == 0 else "local"
    prefix_len = None
    if cfg.family == "vlm":
        px = L.linear(batch["patches"].to(x.dtype), params["projector"])
        x = torch.cat([px, x], dim=1)
        prefix_len = torch.full((x.shape[0],), cfg.frontend_tokens,
                                dtype=torch.int32, device=x.device)
        mask_mode = "prefix"
    for bp, cache in zip(params["layers"], caches):
        x, _ = _block(bp, x, cfg, AB.attention_prefill, cache,
                      mask_mode=mask_mode, prefix_len=prefix_len,
                      window=cfg.window)
    logits = lm_logits(params, x[:, -1:], cfg)
    return logits[:, 0], caches


@torch.no_grad()
def decode_fn(params: dict, caches: list, token: torch.Tensor,
              cfg: ModelConfig):
    """One lock-step decode step over the dense caches (in place).
    token: (B,) int -> (logits (B, V), caches)."""
    x = embed_tokens(params, token[:, None], cfg)
    for bp, cache in zip(params["layers"], caches):
        x, _ = _block(bp, x, cfg, AB.attention_decode, cache,
                      window=cfg.window)
    logits = lm_logits(params, x, cfg)
    return logits[:, 0], caches


def init_paged_caches(cfg: ModelConfig, layout, device,
                      head_shard: Optional[tuple[int, int]] = None) -> list:
    """One paged cache per layer under its layer's ``cfg.policy`` config,
    all sharing one page-table numbering. ``head_shard = (r, n)``: each
    pool holds block ``r`` of ``n`` of the KV heads (a rank of a mesh that
    splits the pools over KV heads, ``distributed/serving.py``)."""
    return [pgc.init_paged_cache(cfg.policy.layer_config(i), layout,
                                 cfg.num_kv_heads, cfg.head_dim,
                                 dtype=torch_dtype(cfg.dtype), device=device,
                                 head_shard=head_shard)
            for i in range(cfg.num_layers)]


@torch.no_grad()
def prefill_paged_fn(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                     caches: list, slot: int, page_row: torch.Tensor,
                     true_len: int):
    """Prefill ONE request into its slot's pages (in place).

    tokens: (1, Tp) int, Tp a bucket length (real prompt = first
    ``true_len``). Returns (last-real-token logits (1, V), caches)."""
    x = embed_tokens(params, tokens, cfg)
    for bp, cache in zip(params["layers"], caches):
        x, _ = _block(bp, x, cfg, AB.attention_prefill_paged, cache,
                      slot=slot, page_row=page_row, true_len=true_len)
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
        x, _ = _block(bp, x, cfg, AB.attention_prefill_chunk, cache,
                      slot=slot, page_row=page_row, start=start,
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
        x, _ = _block(bp, x, cfg, AB.attention_decode_paged, cache,
                      page_table=page_table, active=active)
    logits = lm_logits(params, x, cfg)
    return logits[:, 0], caches


def sample_tokens(logits: torch.Tensor, temperature: float, top_k: int,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy argmax at temperature <= 0; otherwise temperature scaling,
    top-k masking and Gumbel-max sampling (the categorical draw of the JAX
    engine). ``noise`` injects the Gumbel noise (tests feed both packages
    the same draws); else one ``torch.rand`` of ``logits.shape`` is drawn
    from ``generator``. Returns (…,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = torch.where(logits < vals[..., -1:],
                             torch.full_like(logits, -1e30), logits)
    if noise is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
        noise = -torch.log(-torch.log(u))
    return torch.argmax(logits + noise.to(logits.device), dim=-1).to(
        torch.int32)


@torch.no_grad()
def decode_runahead_fn(params: dict, caches: list, token: torch.Tensor,
                       page_table: torch.Tensor, active: torch.Tensor,
                       generator: Optional[torch.Generator],
                       remaining: torch.Tensor, done: torch.Tensor,
                       cfg: ModelConfig, *, horizon: int, temperature: float,
                       top_k: int, eos_id: int):
    """Run-ahead decode (DESIGN.md §18): ``horizon`` micro-steps, each
    exactly one :func:`decode_paged_fn` step followed by on-device
    sampling (:func:`sample_tokens`) and EOS/budget masking, with no host
    synchronisation in between (port of
    ``repro/models/transformer.py::decode_runahead_fn``; a Python loop
    replaces the ``lax.scan``).

    Carries: ``token (S,)`` the last sampled token per slot (fed at
    micro-step 0), ``remaining (S,)`` int32 per-slot budget left,
    ``done (S,)`` bool slots frozen by an earlier horizon. A slot freezes
    when it samples EOS or exhausts ``remaining``: it leaves the active
    mask, so its cache stops advancing (``paged_append`` routes inactive
    lanes to the scratch page) and its token lane holds its last token.

    Sampling draws one ``torch.rand`` from ``generator`` at EVERY
    micro-step (a captured graph cannot branch on "any lane live"); the
    JAX scan splits its key only in micro-steps in which some lane is
    live. Live micro-steps are a prefix of the horizon, so the engine
    restores the generator to the state after the live ones when the
    block lands (``EngineCore._reconcile_block``).

    The caches are updated in place. Returns ``(tokens (horizon, S),
    token, done, remaining)``; the trailing carries seed the next
    pipelined horizon with no host round trip."""
    toks = []
    for _ in range(horizon):
        act = active & ~done
        logits, caches = decode_paged_fn(params, caches, token, page_table,
                                         act, cfg)
        nxt = sample_tokens(logits, temperature, top_k, generator)
        nxt = torch.where(act, nxt.to(token.dtype), token)
        remaining = remaining - act.to(remaining.dtype)
        done = done | (act & (remaining <= 0))
        if eos_id >= 0:
            done = done | (act & (nxt == eos_id))
        toks.append(nxt)
        token = nxt
    return torch.stack(toks), token, done, remaining


@torch.no_grad()
def decode_paged_collect_fn(params: dict, caches: list, token: torch.Tensor,
                            page_table: torch.Tensor, active: torch.Tensor,
                            cfg: ModelConfig):
    """:func:`decode_paged_fn` that also returns every layer's post-RoPE
    (k, v) (S, Hkv, 1, hd): the speculative scan verifier runs it per
    span position on a shadow copy of the state and re-commits accepted
    positions' kv through :func:`commit_paged_fn`, so verification and
    the vanilla decode step share one graph. Returns (logits (S, V),
    caches, kvs) with ``kvs`` a list of one (k, v) pair per layer."""
    x = embed_tokens(params, token[:, None], cfg)
    kvs = []
    for bp, cache in zip(params["layers"], caches):
        h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
        y, _, kv = AB.attention_decode_paged(
            bp["attn"], h, cfg, cache, page_table=page_table, active=active,
            return_kv=True)
        x = x + y
        h = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        x = x + ffn_apply(bp, h, cfg)
        kvs.append(kv)
    logits = lm_logits(params, x, cfg)
    return logits[:, 0], caches, kvs


@torch.no_grad()
def verify_span_fn(params: dict, caches: list, tokens: torch.Tensor,
                   page_table: torch.Tensor, active: torch.Tensor,
                   cfg: ModelConfig):
    """Speculative verify forward: the Q span positions of every slot in
    one pass over the layers. tokens: (S, Q) int, column 0 the real next
    token, columns 1..Q-1 the zero-padded drafts. Attention scores all
    columns in one call (``attention_verify_span``); norms, GEMMs and
    logits run per column at the one-token step's shape
    (``L.per_column``), so each column equals the sequential decode step
    bit for bit as long as the span stays inside each slot's current
    group. The caches are NOT mutated; ``active`` only gates the later
    commit (inactive slots give don't-care logits). Returns (logits
    (S, Q, V), kvs) with ``kvs`` one ((S, Hkv, Q, hd) k, v) pair per
    layer, for :func:`commit_span_paged_fn`.

    An MoE FFN runs per column too, at t = 1 with the decode step's
    capacity, where JAX runs it once over the span with capacity over its
    Q tokens. The two route alike while no expert takes more than the
    capacity of one slot's span — always for Q <= 8, since the capacity
    is at least 8 after rounding and an expert takes at most one
    assignment per token. The engine's span is at most ``spec.k + 1``,
    and ``EngineCore`` refuses a ``spec.k`` whose span widths exceed
    their capacity."""
    del active
    x = embed_tokens(params, tokens, cfg)
    kvs = []
    for bp, cache in zip(params["layers"], caches):
        h = L.per_column(lambda c: L.rms_norm(c, bp["ln1"], cfg.norm_eps), x)
        y, kv = AB.attention_verify_span(bp["attn"], h, cfg, cache,
                                         page_table=page_table)
        x = x + y
        x = x + L.per_column(lambda c: ffn_apply(
            bp, L.rms_norm(c, bp["ln2"], cfg.norm_eps), cfg), x)
        kvs.append(kv)
    return L.per_column(lambda c: lm_logits(params, c, cfg), x), kvs


@torch.no_grad()
def commit_span_paged_fn(caches: list, kvs: list, page_table: torch.Tensor,
                         n_keep: torch.Tensor, cfg: ModelConfig) -> list:
    """Commit the first ``n_keep[s]`` span positions of every slot with one
    fused multi-row append per layer (``paged_cache.paged_append_span``),
    in place. ``kvs``: :func:`verify_span_fn`'s per-layer (k, v), every
    head (a head shard appends its block)."""
    for cache, (k, v) in zip(caches, kvs):
        pgc.paged_append_span(cache, dsrv.local_heads(cache, k),
                              dsrv.local_heads(cache, v), page_table, n_keep)
    return caches


@torch.no_grad()
def commit_paged_fn(caches: list, kvs: list, page_table: torch.Tensor,
                    active: torch.Tensor, cfg: ModelConfig) -> list:
    """Append one span position's saved per-layer (k, v) through the
    vanilla ``paged_append`` (residual rounding, group flush, masked
    lengths), in place; only ``active`` slots advance. No forward runs:
    the kv come from :func:`decode_paged_collect_fn`, every head (a head
    shard appends its block)."""
    for cache, (k, v) in zip(caches, kvs):
        pgc.paged_append(cache, dsrv.local_heads(cache, k),
                         dsrv.local_heads(cache, v), page_table, active)
    return caches
