"""Hybrid RG-LRU + local-attention LM (RecurrentGemma, arXiv:2402.19427;
port of the serving entries of ``repro/models/hybrid.py``).

Layer types follow ``cfg.block_pattern`` cyclically (("rec","rec","attn")
for recurrentgemma-9b). JAX scans the stack over pattern periods plus a
tail scan over the leftover layers; here a Python loop runs the layers in
order (period p, sub-layer i is layer ``p * len(pattern) + i``, then the
tail), and params and state are lists in that order.

Local attention keeps a ring quantized KV cache (capacity == window) —
this is where PolarQuant applies in this family; prefill runs the
flash-prefill kernel in ``local`` mode, and decode stays on the score
route (the score-only LUT kernel + softmax), never the fused kernel,
which assumes linear placement. The RG-LRU state (conv window, h) is fp.
Under a serving mesh (``ServeEngine(mesh=)``) the rings split over KV
heads as the other families' caches do (whole on every rank where the
KV heads do not divide the axis: recurrentgemma-9b's one) and the RG-LRU
states over their width (``models/rglru.py``).

Params: the LM's ``embed``, ``final_norm``, ``lm_head`` and ``layers``,
each ``{"ln1", "ln2", "ffn": {wg, wu, wd}, "mix"}`` with ``mix`` the
attention's ``{wq, wk, wv, wo}`` or the RG-LRU block's params
(``models/rglru.py``). State: per layer a ring
:class:`~repro_torch.core.kv_cache.KVCache` (attention) or a
``(conv, h)`` tuple (recurrent). ``lm_loss`` trains the same layer list,
each pattern period recomputed in the backward as one unit and each tail
layer as one (JAX's ``jax.checkpoint`` around its period and tail scan
bodies).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attn_block as AB
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models import transformer as TF


def layer_types(cfg: ModelConfig) -> list[str]:
    pat = cfg.block_pattern or ("attn",)
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _period_split(cfg: ModelConfig) -> tuple[int, list[str], list[str]]:
    """(periods, the pattern, the tail's layer types)."""
    pat = list(cfg.block_pattern or ("attn",))
    n_periods = cfg.num_layers // len(pat)
    tail = layer_types(cfg)[n_periods * len(pat):]
    if len(set(tail)) > 1:
        raise ValueError("tail layers must be homogeneous")
    return n_periods, pat, tail


def init_sub_layer(cfg: ModelConfig, kind: str,
                   generator: torch.Generator | None, device,
                   dtype: torch.dtype) -> dict:
    """One layer's params: norms (ones, fp32), the GeGLU FFN and the mixer
    (attention or RG-LRU) at the JAX package's init scales."""
    return {"ln1": torch.ones(cfg.d_model, device=device),
            "ln2": torch.ones(cfg.d_model, device=device),
            "mix": (AB.init_attention(cfg, generator, device, dtype)
                    if kind == "attn"
                    else RG.init_rglru_layer(cfg, generator, device, dtype)),
            "ffn": L.init_mlp(cfg.d_model, cfg.d_ff, generator, device,
                              dtype)}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device, head_shard: tuple[int, int] | None = None,
                      rec_shard: tuple[int, int] | None = None) -> list:
    """Per layer: a ring cache of ``min(max_len, window)`` slots (attention)
    or the zero RG-LRU state (recurrent). Under a serving mesh the rings
    hold block ``head_shard = (r, n)`` of the KV heads and the RG-LRU
    states block ``rec_shard`` of the width."""
    return [AB.make_cache(cfg, batch, max_len, device=device,
                          head_shard=head_shard)
            if kind == "attn" else RG.init_state(cfg, batch, device,
                                                  rec_shard)
            for kind in layer_types(cfg)]


def _sub_train(lp: dict, x: torch.Tensor, cfg: ModelConfig,
               kind: str) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "attn":
        y = AB.attention_train(lp["mix"], h, cfg, mask_mode="local",
                               window=cfg.window)
    else:
        y = RG.rglru_mix(lp["mix"], h, cfg)
    x = x + y
    return x + L.mlp(lp["ffn"], L.rms_norm(x, lp["ln2"], cfg.norm_eps),
                     cfg.act)


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            remat: str = "block", ce_chunk: int = 512):
    """batch["tokens"]: (B, T+1) int. Returns (ce, {"ce"})."""
    tokens = batch["tokens"].long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    x = TF.embed_tokens(params, inputs, cfg)
    n_periods, pat, tail = _period_split(cfg)
    layers = params["layers"]

    def period(lps, h):
        for lp, kind in zip(lps, pat):
            h = _sub_train(lp, h, cfg, kind)
        return h

    period = L.remat(period, remat)
    for p in range(n_periods):
        x = period(layers[p * len(pat):(p + 1) * len(pat)], x)
    if tail:
        tail_layer = L.remat(
            lambda lp, h: _sub_train(lp, h, cfg, tail[0]), remat)
        for lp in layers[n_periods * len(pat):]:
            x = tail_layer(lp, x)
    loss = TF.lm_head_loss(params, x, labels, cfg, ce_chunk)
    return loss, {"ce": loss}


def _sub_prefill(lp: dict, h: torch.Tensor, cfg: ModelConfig, kind: str,
                 sub_state):
    hn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, sub_state = AB.attention_prefill(lp["mix"], hn, cfg, sub_state,
                                            mask_mode="local",
                                            window=cfg.window)
    else:
        # the incoming zero state gives the rank's block of the width
        y, sub_state = RG.rglru_mix(lp["mix"], hn, cfg, want_state=True,
                                    block=RG.state_shard(cfg, sub_state))
    h = h + y
    f = L.mlp(lp["ffn"], L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg.act)
    return h + f, sub_state


def _sub_decode(lp: dict, h: torch.Tensor, cfg: ModelConfig, kind: str,
                sub_state):
    hn = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, sub_state = AB.attention_decode(lp["mix"], hn, cfg, sub_state,
                                           window=cfg.window)
    else:
        y, sub_state = RG.rglru_step(lp["mix"], hn[:, 0], cfg, sub_state)
        y = y[:, None]
    h = h + y
    f = L.mlp(lp["ffn"], L.rms_norm(h, lp["ln2"], cfg.norm_eps), cfg.act)
    return h + f, sub_state


def _run_stack(params: dict, state: list, x: torch.Tensor,
               cfg: ModelConfig, step_fn):
    """Every layer in order; the state list is updated in place (a ring
    cache in place, a recurrent layer's entry replaced)."""
    _period_split(cfg)      # the tail must be homogeneous, as JAX's scan needs
    for i, kind in enumerate(layer_types(cfg)):
        x, state[i] = step_fn(params["layers"][i], x, cfg, kind, state[i])
    return x, state


@torch.no_grad()
def prefill_fn(params: dict, batch: dict, cfg: ModelConfig, state: list):
    """batch["tokens"]: (B, T) int. Returns (last-token logits (B, V),
    state)."""
    x = TF.embed_tokens(params, batch["tokens"], cfg)
    x, state = _run_stack(params, state, x, cfg, _sub_prefill)
    logits = TF.lm_logits(params, x[:, -1:], cfg)
    return logits[:, 0], state


@torch.no_grad()
def decode_fn(params: dict, state: list, token: torch.Tensor,
              cfg: ModelConfig):
    """token: (B,) int -> (logits (B, V), state)."""
    x = TF.embed_tokens(params, token[:, None], cfg)
    x, state = _run_stack(params, state, x, cfg, _sub_decode)
    logits = TF.lm_logits(params, x, cfg)
    return logits[:, 0], state
