"""Model parameters for the port: carried over from the JAX package's
``init_params`` tree, or drawn natively from a seeded generator.

Matrices and the embedding are stored in the model dtype (the JAX
package keeps fp32 masters and casts them at every use, which computes
the same products); norm weights stay fp32, as ``rms_norm`` reads them,
and so does an MoE layer's router, which JAX casts to fp32 (a router in
the model dtype would move the routing).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import init_moe
from repro_torch.utils import resolve_device, torch_dtype

_MATS = {"attn": ("wq", "wk", "wv", "wo"), "ffn": ("wg", "wu", "wd")}


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> dict:
    """JAX ``init_params`` tree (leaves as numpy arrays, layer-stacked
    leaves with a leading layer axis) -> the port's params, one dict per
    layer, on ``device`` (the card unless named)."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype)

    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(dev, dtype)

    lp = np_params["layers"]
    layers = []
    for i in range(cfg.num_layers):
        layer = {"ln1": t(lp["ln1"][i], torch.float32),
                 "ln2": t(lp["ln2"][i], torch.float32)}
        for group, names in _MATS.items():
            layer[group] = {n: t(lp[group][n][i], dt) for n in names}
            layer[group].update({n: t(lp[group][n][i], torch.float32)
                                 for n in ("bq", "bk", "bv", "router")
                                 if n in lp[group]})
        if "shared" in lp["ffn"]:
            layer["ffn"]["shared"] = {n: t(lp["ffn"]["shared"][n][i], dt)
                                      for n in _MATS["ffn"]}
        layers.append(layer)
    out = {"embed": t(np_params["embed"], dt),
           "final_norm": t(np_params["final_norm"], torch.float32),
           "layers": layers}
    if "lm_head" in np_params:
        out["lm_head"] = t(np_params["lm_head"], dt)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None) -> dict:
    """Random params at the JAX package's init scales (dense: normal /
    sqrt(d_in); embedding and MoE router: normal * 0.02; norms: ones),
    drawn on ``device`` from ``generator`` (which must live on that
    device)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": torch.ones(d, device=dev), "ln2": torch.ones(d, device=dev),
            "attn": {"wq": dense(d, cfg.num_heads * hd),
                     "wk": dense(d, cfg.num_kv_heads * hd),
                     "wv": dense(d, cfg.num_kv_heads * hd),
                     "wo": dense(cfg.num_heads * hd, d)},
            "ffn": (init_moe(cfg, generator, dev, dt) if cfg.family == "moe"
                    else {"wg": dense(d, f), "wu": dense(d, f),
                          "wd": dense(f, d)}),
        })
        if cfg.qkv_bias:
            layers[-1]["attn"].update(
                {n: torch.zeros(w, device=dev) for n, w in (
                    ("bq", cfg.num_heads * hd), ("bk", cfg.num_kv_heads * hd),
                    ("bv", cfg.num_kv_heads * hd))})
    out = {"embed": normal((cfg.vocab_size, d), 0.02),
           "final_norm": torch.ones(d, device=dev), "layers": layers}
    if not cfg.tie_embeddings:
        out["lm_head"] = dense(d, cfg.vocab_size)
    return out
