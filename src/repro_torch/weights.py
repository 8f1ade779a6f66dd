"""Model parameters for the port: carried over from the JAX package's
``init_params`` tree, or drawn natively from a seeded generator.

Matrices and the embedding are stored in the model dtype (the JAX
package keeps fp32 masters and casts them at every use, which computes
the same products); norm weights stay fp32, as ``rms_norm`` reads them,
and so does an MoE layer's router, which JAX casts to fp32 (a router in
the model dtype would move the routing), and so do the RG-LRU block's
conv, gate and Lambda params, which JAX computes in fp32.

The VLM family adds ``projector`` (frontend_dim, D). The hybrid family's
JAX tree stacks its layers per pattern period (``periods/sub{i}_{kind}``,
leading axis the period) and in ``tail``; here they are one list in layer
order, each layer's mixer under ``mix``. The SSM family's ``layers`` hold
the Mamba-2 mixer's params: ``in_proj`` and ``out_proj`` in the model
dtype, the conv, the per-head vectors and the norms in fp32. The
encoder-decoder family has ``enc_layers`` and ``dec_layers`` (with
``ln_x`` and the cross-attention ``xattn``) instead of ``layers``, plus
``frontend_proj`` (frontend_dim, D) and ``enc_norm``.

Training keeps fp32 masters, as JAX does: ``params_from_jax(...,
dtype=torch.float32)`` carries every leaf over in fp32, and
:func:`params_to_jax` is its inverse, the port's tree (params, or the
AdamW moments, which have its shape) back in JAX's layout — the layers
stacked, the hybrid's split into its periods and tail — for checkpoints
either package restores.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attn_block as AB
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.moe import init_moe
from repro_torch.utils import resolve_device, torch_dtype

_MATS = {"attn": ("wq", "wk", "wv", "wo"), "ffn": ("wg", "wu", "wd")}
#: the RG-LRU block's matrices, in the model dtype (the rest stays fp32)
_RG_MATS = ("w_gate", "w_in", "w_out")
#: the Mamba-2 mixer's matrices, in the model dtype (the rest stays fp32)
_SSM_MATS = ("in_proj", "out_proj")


def _hybrid_from_jax(np_params: dict, cfg: ModelConfig, t, dt) -> list:
    """The hybrid's period-stacked and tail-stacked layers -> one list in
    layer order (period p, sub-layer i -> layer p * len(pattern) + i, then
    the tail)."""
    n_periods, pat, tail = HY._period_split(cfg)

    def layer(tree, i, kind):
        out = {"ln1": t(tree["ln1"][i], torch.float32),
               "ln2": t(tree["ln2"][i], torch.float32),
               "ffn": {n: t(tree["ffn"][n][i], dt) for n in _MATS["ffn"]}}
        mix = tree["mix"]
        if kind == "attn":
            out["mix"] = {n: t(mix[n][i], dt) for n in _MATS["attn"]}
            out["mix"].update({n: t(mix[n][i], torch.float32)
                               for n in ("bq", "bk", "bv") if n in mix})
        else:
            out["mix"] = {n: t(a[i], dt if n in _RG_MATS else torch.float32)
                          for n, a in mix.items()}
        return out

    layers = [layer(np_params["periods"][f"sub{j}_{kind}"], p, kind)
              for p in range(n_periods) for j, kind in enumerate(pat)]
    layers += [layer(np_params["tail"], i, kind)
               for i, kind in enumerate(tail)]
    return layers


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None,
                    dtype=None) -> dict:
    """JAX ``init_params`` tree (leaves as numpy arrays, layer-stacked
    leaves with a leading layer axis) -> the port's params, one dict per
    layer, on ``device`` (the card unless named); matrices in ``dtype``
    (the model dtype unless named; fp32 for training's masters)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)

    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(dev, dtype)

    out = {"embed": t(np_params["embed"], dt),
           "final_norm": t(np_params["final_norm"], torch.float32)}
    if cfg.family == "hybrid":
        out["layers"] = _hybrid_from_jax(np_params, cfg, t, dt)
    elif cfg.family == "ssm":
        lp = np_params["layers"]
        out["layers"] = [
            {n: t(a[i], dt if n in _SSM_MATS else torch.float32)
             for n, a in lp.items()} for i in range(cfg.num_layers)]
    elif cfg.family == "encdec":
        out["enc_layers"] = _layers_from_jax(
            np_params["enc_layers"], t, cfg.encoder_layers, dt)
        out["dec_layers"] = _layers_from_jax(
            np_params["dec_layers"], t, cfg.num_layers, dt)
        out["enc_norm"] = t(np_params["enc_norm"], torch.float32)
    else:
        out["layers"] = _layers_from_jax(np_params["layers"], t,
                                         cfg.num_layers, dt)
    for name in ("lm_head", "projector", "frontend_proj"):
        if name in np_params:
            out[name] = t(np_params[name], dt)
    return out


def _layers_from_jax(lp: dict, t, n_layers: int, dt) -> list:
    """A dense / MoE / VLM / encoder / decoder layer stack (leading layer
    axis) -> one dict per layer (a decoder layer's ``ln_x`` and ``xattn``
    beside its ``attn``)."""
    groups = {**_MATS, **({"xattn": _MATS["attn"]} if "xattn" in lp else {})}
    layers = []
    for i in range(n_layers):
        layer = {n: t(lp[n][i], torch.float32)
                 for n in ("ln1", "ln2", "ln_x") if n in lp}
        for group, names in groups.items():
            layer[group] = {n: t(lp[group][n][i], dt) for n in names}
            layer[group].update({n: t(lp[group][n][i], torch.float32)
                                 for n in ("bq", "bk", "bv", "router")
                                 if n in lp[group]})
        if "shared" in lp["ffn"]:
            layer["ffn"]["shared"] = {n: t(lp["ffn"]["shared"][n][i], dt)
                                      for n in _MATS["ffn"]}
        layers.append(layer)
    return layers


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy; bf16 (which numpy lacks) as fp32,
    exactly."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def _stack(layers: list, stack):
    """Per-layer trees (dicts of leaves) -> one tree whose every leaf is
    ``stack`` of that leaf across the layers."""
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers], stack) for k in layers[0]}
    return stack(layers)


def jax_layout(params: dict, cfg: ModelConfig, leaf=None, stack=None) -> dict:
    """The port's tree in JAX's ``init_params`` layout: every layer list
    stacked along a leading axis, the hybrid's layers split back into
    ``periods/sub{i}_{kind}`` and ``tail`` by ``_period_split``. ``leaf``
    maps a leaf outside the layer lists, ``stack`` the list of one leaf's
    per-layer values (numpy arrays by default, as :func:`params_to_jax`);
    any other leaf type works alike (``train/sharded.py`` lays out
    references to the port's leaves)."""
    leaf = leaf or _to_numpy
    stack = stack or (lambda xs: np.stack([_to_numpy(x) for x in xs]))
    out = {k: leaf(v) for k, v in params.items()
           if not isinstance(v, (dict, list))}
    if cfg.family == "hybrid":
        n_periods, pat, tail = HY._period_split(cfg)
        layers, n = params["layers"], len(pat)
        out["periods"] = {
            f"sub{i}_{kind}": _stack(layers[i:n_periods * n:n], stack)
            for i, kind in enumerate(pat)}
        if tail:
            out["tail"] = _stack(layers[n_periods * n:], stack)
        return out
    for name in ("layers", "enc_layers", "dec_layers"):
        if name in params:
            out[name] = _stack(params[name], stack)
    return out


def params_to_jax(params: dict, cfg: ModelConfig) -> dict:
    """The port's params (or any tree of their shape, such as the AdamW
    moments) -> numpy in JAX's ``init_params`` layout
    (:func:`jax_layout`). The inverse of ``params_from_jax(...,
    dtype=torch.float32)``, bit for bit."""
    return jax_layout(params, cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=None) -> dict:
    """Random params at the JAX package's init scales (dense: normal /
    sqrt(d_in); embedding and MoE router: normal * 0.02; norms: ones; the
    RG-LRU block's as ``models/rglru.py``, the Mamba-2 mixer's as
    ``models/mamba2.py``), drawn on ``device`` from ``generator`` (which
    must live on that device)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype or cfg.dtype)
    d = cfg.d_model

    def block() -> dict:
        return {"ln1": torch.ones(d, device=dev),
                "ln2": torch.ones(d, device=dev),
                "attn": AB.init_attention(cfg, generator, dev, dt),
                "ffn": (init_moe(cfg, generator, dev, dt)
                        if cfg.family == "moe"
                        else L.init_mlp(d, cfg.d_ff, generator, dev, dt))}

    if cfg.family == "hybrid":
        body = {"layers": [HY.init_sub_layer(cfg, kind, generator, dev, dt)
                           for kind in HY.layer_types(cfg)]}
    elif cfg.family == "ssm":
        body = {"layers": [M2.init_mamba_layer(cfg, generator, dev, dt)
                           for _ in range(cfg.num_layers)]}
    elif cfg.family == "encdec":
        body = {"enc_layers": [ED.init_enc_layer(cfg, generator, dev, dt)
                               for _ in range(cfg.encoder_layers)],
                "dec_layers": [ED.init_dec_layer(cfg, generator, dev, dt)
                               for _ in range(cfg.num_layers)],
                "enc_norm": torch.ones(d, device=dev)}
    else:
        body = {"layers": [block() for _ in range(cfg.num_layers)]}
    embed = torch.randn((cfg.vocab_size, d), generator=generator, device=dev,
                        dtype=torch.float32)
    out = {"embed": (embed * 0.02).to(dt),
           "final_norm": torch.ones(d, device=dev), **body}
    if not cfg.tie_embeddings:
        out["lm_head"] = L.dense_init(d, cfg.vocab_size, generator, dev, dt)
    if cfg.family in ("vlm", "encdec"):
        name = "projector" if cfg.family == "vlm" else "frontend_proj"
        out[name] = L.dense_init(cfg.frontend_dim, d, generator, dev, dt)
    return out
