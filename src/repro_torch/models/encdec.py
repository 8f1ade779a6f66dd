"""Encoder-decoder transformer (the seamless-m4t backbone, audio frontend
stubbed; port of the serving entries of ``repro/models/encdec.py``).

Encoder: a frontend projection of precomputed frame features
``frames (B, frontend_tokens, frontend_dim)`` (the conformer feature
extractor is stubbed), bidirectional RoPE self-attention (the flash
prefill kernel in ``full`` mode) and MLP per layer, then ``enc_norm``.
Decoder: causal self-attention over a quantized linear cache, cross-
attention over a static quantized cache built once from the encoder
memory, and MLP. The prefill's cross-attention reads the full-precision
memory (``full`` mode, Tq = the prompt, Tk = the frames), as JAX's; every
decode step reads the cross cache on the score route (the score-only LUT
kernel + softmax) and the self cache on ``cfg.decode_backend``.

Under a serving mesh (``ServeEngine(mesh=)``) the self and cross caches
hold the rank's block of the KV heads: the prompt's attention, the cross
cache's fill and both decode attentions run per head block and gather
the heads before ``wo`` (``distributed/serving.py``). The encoder and the
prefill's cross-attention over the fp memory hold no cache and run whole
on every rank.

Params: the LM's ``embed``, ``final_norm`` and ``lm_head``;
``frontend_proj`` (frontend_dim, D); ``enc_layers``, each ``{"ln1",
"ln2", "attn", "ffn"}``; ``dec_layers``, each ``{"ln1", "ln_x", "ln2",
"attn", "xattn", "ffn"}``; ``enc_norm``. State: ``{"self": [...],
"cross": [...]}``, one dense :class:`~repro_torch.core.kv_cache.KVCache`
per decoder layer in each. ``lm_loss`` trains the encoder over the frames
and the decoder over the text (teacher forcing, the cross-attention over
the full-precision memory), each layer recomputed in the backward under
``remat="block"``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attn_block as AB
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.utils import torch_dtype


def init_enc_layer(cfg: ModelConfig, generator: torch.Generator | None,
                   device, dtype: torch.dtype) -> dict:
    return {"ln1": torch.ones(cfg.d_model, device=device),
            "ln2": torch.ones(cfg.d_model, device=device),
            "attn": AB.init_attention(cfg, generator, device, dtype),
            "ffn": L.init_mlp(cfg.d_model, cfg.d_ff, generator, device,
                              dtype)}


def init_dec_layer(cfg: ModelConfig, generator: torch.Generator | None,
                   device, dtype: torch.dtype) -> dict:
    return {**init_enc_layer(cfg, generator, device, dtype),
            "ln_x": torch.ones(cfg.d_model, device=device),
            "xattn": AB.init_attention(cfg, generator, device, dtype)}


def _mlp_residual(lp: dict, h: torch.Tensor, cfg: ModelConfig):
    return h + L.mlp(lp["ffn"], L.rms_norm(h, lp["ln2"], cfg.norm_eps),
                     cfg.act)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           remat: str = "block") -> torch.Tensor:
    """frames (B, Tf, frontend_dim) -> memory (B, Tf, D); each layer
    recomputed in the backward under ``remat="block"`` (when a gradient
    is being recorded)."""
    def layer(lp, h):
        h = h + AB.attention_train(lp["attn"],
                                   L.rms_norm(h, lp["ln1"], cfg.norm_eps),
                                   cfg, mask_mode="full")
        return _mlp_residual(lp, h, cfg)

    layer = L.remat(layer, remat)
    x = L.linear(frames.to(torch_dtype(cfg.dtype)), params["frontend_proj"])
    for lp in params["enc_layers"]:
        x = layer(lp, x)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _dec_block_train(lp: dict, h: torch.Tensor, memory: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    h = h + AB.attention_train(lp["attn"],
                               L.rms_norm(h, lp["ln1"], cfg.norm_eps), cfg,
                               mask_mode="causal")
    h = h + AB.attention_train(lp["xattn"],
                               L.rms_norm(h, lp["ln_x"], cfg.norm_eps), cfg,
                               memory=memory)
    return _mlp_residual(lp, h, cfg)


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            remat: str = "block", ce_chunk: int = 512):
    """batch: ``frames`` (B, Tf, frontend_dim), ``tokens`` (B, T+1) int.
    Returns (ce, {"ce"})."""
    memory = encode(params, batch["frames"], cfg, remat)
    tokens = batch["tokens"].long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    x = TF.embed_tokens(params, inputs, cfg)
    layer = L.remat(lambda lp, h, mem: _dec_block_train(lp, h, mem, cfg),
                    remat)
    for lp in params["dec_layers"]:
        x = layer(lp, x, memory)
    loss = TF.lm_head_loss(params, x, labels, cfg, ce_chunk)
    return loss, {"ce": loss}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device,
                      head_shard: tuple[int, int] | None = None) -> dict:
    """Per decoder layer a self cache of ``max_len`` and a cross cache of
    ``cfg.frontend_tokens`` (each rounded up to a group multiple); under
    a serving mesh both hold block ``head_shard = (r, n)`` of the KV
    heads."""
    def caches(n):
        return [AB.make_cache(cfg, batch, n, device=device,
                              head_shard=head_shard)
                for _ in range(cfg.num_layers)]
    return {"self": caches(max_len), "cross": caches(cfg.frontend_tokens)}


@torch.no_grad()
def prefill_fn(params: dict, batch: dict, cfg: ModelConfig, state: dict):
    """Encode ``batch["frames"]`` (B, frontend_tokens, frontend_dim), fill
    the cross caches from the memory and prefill the decoder prompt
    ``batch["tokens"]`` (B, T), in place. Returns (last-token logits
    (B, V), state)."""
    frames = batch["frames"]
    if frames.shape[1] != cfg.frontend_tokens:
        raise ValueError(f"frames hold {frames.shape[1]} frames; the cross "
                         f"caches take frontend_tokens = "
                         f"{cfg.frontend_tokens}")
    memory = encode(params, frames, cfg)
    x = TF.embed_tokens(params, batch["tokens"], cfg)
    for lp, self_c, cross_c in zip(params["dec_layers"], state["self"],
                                   state["cross"]):
        a, _ = AB.attention_prefill(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, self_c,
            mask_mode="causal")
        x = x + a
        AB.cross_attention_cache(lp["xattn"], memory, cfg, cross_c)
        x = x + AB.attention_train(
            lp["xattn"], L.rms_norm(x, lp["ln_x"], cfg.norm_eps), cfg,
            memory=memory)
        x = _mlp_residual(lp, x, cfg)
    logits = TF.lm_logits(params, x[:, -1:], cfg)
    return logits[:, 0], state


@torch.no_grad()
def decode_fn(params: dict, state: dict, token: torch.Tensor,
              cfg: ModelConfig):
    """token: (B,) int -> (logits (B, V), state); the self caches append
    in place, the cross caches are read only."""
    x = TF.embed_tokens(params, token[:, None], cfg)
    for lp, self_c, cross_c in zip(params["dec_layers"], state["self"],
                                   state["cross"]):
        a, _ = AB.attention_decode(
            lp["attn"], L.rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, self_c)
        x = x + a
        xa, _ = AB.attention_decode(
            lp["xattn"], L.rms_norm(x, lp["ln_x"], cfg.norm_eps), cfg,
            cross_c, cross=True)
        x = _mlp_residual(lp, x + xa, cfg)
    logits = TF.lm_logits(params, x, cfg)
    return logits[:, 0], state
