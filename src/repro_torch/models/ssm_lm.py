"""Mamba-2 language model: a stack of (RMSNorm -> SSD mixer) blocks (port of
the serving entries of ``repro/models/ssm_lm.py``).

Attention-free: the decode state is one (conv window, SSD state) tuple
per layer (:func:`repro_torch.models.mamba2.init_state`) — O(1) in the
sequence length. JAX scans the stack; here a Python loop runs the layers
and the state is a list in layer order. Params: the LM's ``embed``,
``final_norm`` (and ``lm_head`` unless tied) and ``layers``, each the
mixer's params (``models/mamba2.py``) with its pre-norm ``ln``.
``lm_loss`` runs the mixer over the whole sequence from the zero state,
each layer recomputed in the backward under ``remat="block"``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as TF


def init_decode_state(cfg: ModelConfig, batch: int, device,
                      ssm_shard: tuple[int, int] | None = None) -> list:
    """Per layer the zero state: conv window in ``cfg.dtype``, SSD state
    in fp32; under a serving mesh, block ``ssm_shard = (r, n)`` of each
    group's SSD heads (``models/mamba2.py``)."""
    return [M2.init_state(cfg, batch, device, ssm_shard)
            for _ in range(cfg.num_layers)]


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            remat: str = "block", ce_chunk: int = 512):
    """batch["tokens"]: (B, T+1) int. Returns (ce, {"ce"})."""
    tokens = batch["tokens"].long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    x = TF.embed_tokens(params, inputs, cfg)
    layer = L.remat(lambda lp, h: h + M2.mamba_mix(
        lp, L.rms_norm(h, lp["ln"], cfg.norm_eps), cfg), remat)
    for lp in params["layers"]:
        x = layer(lp, x)
    loss = TF.lm_head_loss(params, x, labels, cfg, ce_chunk)
    return loss, {"ce": loss}


@torch.no_grad()
def prefill_fn(params: dict, batch: dict, cfg: ModelConfig, state: list):
    """batch["tokens"]: (B, T) int. The prompt runs from the zero state,
    as JAX's (the incoming state only gives the list its length and the
    rank's block of the heads). Returns (last-token logits (B, V), the
    state after the prompt)."""
    x = TF.embed_tokens(params, batch["tokens"], cfg)
    for i, lp in enumerate(params["layers"]):
        y, state[i] = M2.mamba_mix(lp, L.rms_norm(x, lp["ln"], cfg.norm_eps),
                                   cfg, want_state=True,
                                   block=M2.state_shard(cfg, state[i]))
        x = x + y
    logits = TF.lm_logits(params, x[:, -1:], cfg)
    return logits[:, 0], state


@torch.no_grad()
def decode_fn(params: dict, state: list, token: torch.Tensor,
              cfg: ModelConfig):
    """token: (B,) int -> (logits (B, V), state); one recurrent step per
    layer."""
    x = TF.embed_tokens(params, token[:, None], cfg)
    for i, lp in enumerate(params["layers"]):
        y, state[i] = M2.mamba_step(
            lp, L.rms_norm(x, lp["ln"], cfg.norm_eps)[:, 0], cfg, state[i])
        x = x + y[:, None]
    logits = TF.lm_logits(params, x, cfg)
    return logits[:, 0], state
