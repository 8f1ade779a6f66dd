"""Model interface over the dense family's paged serving entries (port of
``repro/models/registry.py:118-161``; run-ahead, speculative decoding and
page copies come in later slices).

``get_model(cfg)`` returns a :class:`Model` bundle:
  init(generator, device) -> params
  init_paged_state(layout, device) -> list of per-layer PagedKVCaches
  prefill_paged(params, tokens (1,Tp), state, slot, page_row, true_len)
  decode_paged(params, state, token (S,), page_table, active)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., dict]
    init_paged_state: Callable[..., Any]
    prefill_paged: Callable[..., Any]
    decode_paged: Callable[..., Any]


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise ValueError(f"family {cfg.family!r} is not ported yet")
    from repro_torch.weights import init_params
    return Model(
        cfg=cfg,
        init=lambda generator=None, device=None: init_params(
            cfg, generator=generator, device=device),
        init_paged_state=lambda layout, device: TF.init_paged_caches(
            cfg, layout, device),
        prefill_paged=lambda p, toks, s, slot, row, tl:
            TF.prefill_paged_fn(p, toks, cfg, s, slot, row, tl),
        decode_paged=lambda p, s, t, table, active:
            TF.decode_paged_fn(p, s, t, table, active, cfg),
    )
