"""Parameter / activation / cache sharding rules, FSDP x TP x pod (port of
``repro/distributed/sharding.py``).

Pure host functions of names, shapes and mesh sizes; they return
:class:`~repro_torch.distributed.ctx.PartitionSpec` tuples whose entries
equal JAX's. Strategy (DESIGN.md §4):

* **Params** — every weight gets ZeRO-3-style FSDP over the combined
  (``pod``, ``data``) axes on its largest eligible dim, plus tensor
  parallelism over ``model`` on the canonical matmul dim (name-pattern
  table, negative axis indices so stacked (L, ...) weights and the port's
  per-layer ones match alike). Divisibility is checked per arch;
  ineligible dims fall back.
* **Activations** — logical-axis rules installed via ctx.use_sharding:
  batch over (pod, data); heads/ff/experts over model when divisible.
* **Decode caches** — batch over (pod, data); the sequence/group axis
  over model (context-parallel decode).

The paged serving engine uses :func:`serving_rules` only: its params stay
replicated on every rank (weight tensor parallelism is a training-side
concern, as in JAX) and its page pools split over KV heads
(``distributed/serving.py``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import P, PartitionSpec
from repro_torch.launch.mesh import data_axes

# name pattern -> axis (negative index) that carries tensor parallelism
_TP_RULES: list[tuple[str, int]] = [
    (r".*(wq|wg|wu|w_in|w_gate)$", -1),   # column parallel
    (r".*(wo|wd|w_out)$", -2),            # row parallel
    (r".*(wk|wv)$", -1),
    (r".*(bq)$", -1),
    (r".*lm_head$", -1),                  # vocab column parallel
    (r".*conv_w$", -1),                   # depthwise conv channels
    (r".*(rg_w|ig_w)$", -3),              # RG-LRU block-diagonal blocks
    (r".*(rg_b|ig_b|lam|conv_b|norm_w)$", -1),
]

_NO_FSDP = re.compile(r".*(ln1|ln2|ln_x|ln|final_norm|enc_norm|A_log|dt_bias|D)$")


def _divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def _dp(mesh) -> tuple[int, Any]:
    """(data-parallel size, the batch axis entry: one name, a tuple of
    names, or None)."""
    daxes = data_axes(mesh)
    dp = math.prod(mesh.shape[a] for a in daxes) if daxes else 1
    baxes = (daxes if len(daxes) > 1 else daxes[0]) if daxes else None
    return dp, baxes


def _tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over every leaf (anything with ``.shape``) of
    nested dicts, lists, tuples and dataclasses (a dataclass maps to a dict
    of its fields that hold leaves); paths join keys, indices and field
    names with ``/`` as JAX's ``_path_str`` joins tree keys."""
    def sub(key):
        return f"{path}/{key}" if path else str(key)
    if hasattr(tree, "shape"):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, sub(i))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {}
        for f in dataclasses.fields(tree):
            v = getattr(tree, f.name)
            if hasattr(v, "shape") or isinstance(v, (dict, list, tuple)):
                out[f.name] = _tree_map_with_path(fn, v, sub(f.name))
        return out
    return None


def param_pspec(path: str, shape: tuple[int, ...], mesh,
                cfg: Optional[ModelConfig] = None) -> PartitionSpec:
    """Resolve one parameter's PartitionSpec."""
    model_n = mesh.shape.get("model", 1)
    daxes = data_axes(mesh)
    fsdp_n, _ = _dp(mesh)
    spec: list = [None] * len(shape)

    # --- tensor parallelism ---
    tp_axis = None
    for pat, ax in _TP_RULES:
        if re.match(pat, path):
            tp_axis = ax
            break
    # MoE expert tensors: prefer expert parallelism when E % model == 0
    if cfg is not None and cfg.family == "moe" and re.search(
            r"ffn/w[gud]$", path) and len(shape) >= 3:
        if _divides(shape[-3], model_n):
            tp_axis = -3
    if tp_axis is not None and len(shape) >= abs(tp_axis):
        if _divides(shape[tp_axis], model_n):
            spec[tp_axis] = "model"
        else:
            tp_axis = None

    # --- FSDP on the largest remaining eligible dim ---
    if not _NO_FSDP.match(path) and daxes:
        best, best_size = None, 0
        for i, dim in enumerate(shape):
            ni = i - len(shape)
            if spec[ni] is not None:
                continue
            if _divides(dim, fsdp_n) and dim > best_size:
                best, best_size = ni, dim
        if best is not None:
            spec[best] = daxes if len(daxes) > 1 else daxes[0]
    return P(*spec)


def param_pspecs(params: Any, mesh, cfg: Optional[ModelConfig] = None) -> Any:
    """Tree of PartitionSpecs matching a params tree (tensors, or anything
    with ``.shape``)."""
    return _tree_map_with_path(
        lambda path, leaf: param_pspec(path, tuple(leaf.shape), mesh, cfg),
        params)


# ---------------------------------------------------------------------------
# Activation logical rules
# ---------------------------------------------------------------------------


def _batch_entry(mesh, global_batch: int) -> Any:
    """The batch axis entry of a global batch of ``global_batch`` rows:
    the data axes where they divide it, else None (every rank holds it
    whole). The one decision behind ``logical_rules``' ``batch``,
    :func:`batch_pspecs` and :func:`batch_rows`."""
    dp, baxes = _dp(mesh)
    return baxes if _divides(global_batch, dp) else None


def batch_rows(mesh, global_batch: int) -> int:
    """A rank's rows of a global batch of ``global_batch`` rows, as
    :func:`batch_pspecs` splits it."""
    dp, _ = _dp(mesh)
    split = _batch_entry(mesh, global_batch) is not None
    return global_batch // dp if split else global_batch


def logical_rules(cfg: ModelConfig, mesh, global_batch: int) -> dict:
    model_n = mesh.shape.get("model", 1)
    rules: dict[str, Any] = {
        "batch": _batch_entry(mesh, global_batch),
        "heads": "model" if _divides(cfg.num_heads, model_n) else None,
        "kv_heads": "model" if _divides(cfg.num_kv_heads, model_n) else None,
        "ff": "model" if _divides(cfg.d_ff, model_n) else None,
        "vocab": "model" if _divides(cfg.vocab_size, model_n) else None,
        "experts": "model" if _divides(cfg.num_experts, model_n) else None,
        "expert_ff": None,
        "seq": "model",   # context-parallel decode / sequence-sharded saves
    }
    if rules["experts"] is None and cfg.family == "moe":
        eff = cfg.moe_d_ff or cfg.d_ff
        rules["expert_ff"] = "model" if _divides(eff, model_n) else None
    if cfg.family == "ssm":
        from repro_torch.models.mamba2 import dims as ssm_dims
        dm = ssm_dims(cfg)
        rules["ssm_heads"] = ("model" if _divides(
            dm.nheads // dm.ngroups, model_n) else None)
        rules["ssm_conv"] = "model" if _divides(dm.conv_dim, model_n) else None
        rules["ssm_inner"] = "model" if _divides(dm.d_inner, model_n) else None
    if cfg.family == "hybrid":
        w = cfg.lru_width or cfg.d_model
        rules["rec_width"] = "model" if _divides(w, model_n) else None
    return rules


def serving_rules(cfg: ModelConfig, mesh, global_batch: int) -> dict:
    """Logical rules for the paged serving stack (DESIGN.md §17):
    :func:`logical_rules` minus the context-parallel ``seq`` mapping.
    Serving shards heads only — the page pools split over KV heads
    (``distributed/serving.py``) — so sequence/group axes stay
    replicated."""
    rules = logical_rules(cfg, mesh, global_batch)
    rules["seq"] = None
    return rules


def batch_pspecs(batch_specs: dict, mesh, global_batch: int) -> dict:
    baxes = _batch_entry(mesh, global_batch)
    return {k: P(baxes, *([None] * (len(v.shape) - 1)))
            for k, v in batch_specs.items()}


# ---------------------------------------------------------------------------
# Decode-state sharding
# ---------------------------------------------------------------------------

def decode_state_pspec(path: str, shape: tuple[int, ...], mesh,
                       global_batch: int) -> PartitionSpec:
    """Generic decode-state resolver: batch axis over (pod,data); the
    longest remaining axis over model if divisible (sequence for caches,
    heads/width for recurrent states)."""
    model_n = mesh.shape.get("model", 1)
    dp, baxes = _dp(mesh)
    spec: list = [None] * len(shape)
    # batch: find the axis whose size == global_batch (after the L axis)
    b_idx = None
    for i, dim in enumerate(shape):
        if i == 0:
            continue
        if dim == global_batch:
            b_idx = i
            break
    if b_idx is not None and _divides(global_batch, dp) and baxes is not None:
        spec[b_idx] = baxes
    # model axis: largest remaining divisible dim (prefer later axes on tie)
    best, best_size = None, 0
    for i, dim in enumerate(shape):
        if i == 0 or i == b_idx:
            continue
        if _divides(dim, model_n) and dim >= best_size and dim > 1:
            best, best_size = i, dim
    if best is not None:
        spec[best] = "model"
    return P(*spec)


def decode_state_pspecs(state: Any, mesh, global_batch: int) -> Any:
    return _tree_map_with_path(
        lambda path, leaf: decode_state_pspec(path, tuple(leaf.shape), mesh,
                                              global_batch), state)
