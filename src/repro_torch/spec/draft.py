"""Draft-model proposer: a small dense-cache model guesses the span (port
of ``repro/spec/draft.py``).

The draft runs real forwards on its own batch-1 dense cache per request
(``model.decode`` over ``model.init_decode_state``); the target's paged
state is never touched by proposal, only by verification
(spec/verify.py). Each ``propose()`` feeds the context delta token by
token (the last accepted span), then greedily rolls out k guesses. The
guesses are appended to the draft cache too, so before returning the
cache is rewound to the real context size: ``length`` on the device and
``host_length``, the host's copy that decides the dense cache's group
flush (``core/kv_cache.py``) — JAX keeps only the former. For grouped
codecs the rewind is lossy at group boundaries (flushed rows are not
un-flushed) — harmless, it can only degrade later guesses, and the
default derived draft config quantizes nothing.

Draft params come from the port's ``init`` with a ``torch.Generator``
seeded by ``spec.draft_seed`` on the target params' device (tests that
need the JAX package's draft weights set ``.params`` to weights carried
across with ``repro_torch.weights.params_from_jax``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.spec.config import SpecConfig
from repro_torch.spec.propose import DraftProposer, register_proposer


def _derive_draft_cfg(target_cfg, spec: SpecConfig):
    """A shrunk, unquantized copy of the target config (the first
    ``draft_layers`` layers' worth of depth, the same vocab so proposed
    ids are meaningful)."""
    from repro_torch.core.quantizers import QuantConfig
    return dataclasses.replace(
        target_cfg,
        name=f"{target_cfg.name}-draft{spec.draft_layers}",
        num_layers=max(1, min(spec.draft_layers, target_cfg.num_layers)),
        cache_policy=None,
        quant=QuantConfig(method="none", value_bits=0,
                          group_size=target_cfg.quant.group_size),
        decode_backend="jnp",
        prefill_backend="jnp",
    )


@register_proposer
class DraftModelProposer(DraftProposer):
    """Classic speculative sampling's proposer half, greedy flavor."""

    name = "draft"

    def __init__(self, spec: SpecConfig, *, target_cfg=None,
                 target_model=None, target_params=None,
                 max_len: int = 0) -> None:
        super().__init__(spec, target_cfg=target_cfg)
        from repro_torch.models.registry import get_model
        self.device = (target_params["embed"].device
                       if target_params is not None else None)
        if spec.draft_arch == "self":
            if target_model is None or target_params is None:
                raise ValueError(
                    "draft_arch='self' needs the target model and params")
            self.model, self.params = target_model, target_params
        else:
            if spec.draft_arch:
                from repro_torch.configs import get_config
                cfg = dataclasses.replace(
                    _derive_draft_cfg(get_config(spec.draft_arch), spec),
                    vocab_size=target_cfg.vocab_size)
            else:
                cfg = _derive_draft_cfg(target_cfg, spec)
            self.model = get_model(cfg)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(spec.draft_seed)
            self.params = self.model.init(generator=gen, device=self.device)
        self.max_len = int(max_len) or 4096
        self._by_rid: Dict[Any, Dict[str, Any]] = {}

    def reset(self) -> None:
        self._by_rid.clear()

    def release(self, rid) -> None:
        self._by_rid.pop(rid, None)

    @staticmethod
    def _rewind(caches: list, n: int) -> list:
        """Forget everything past the first ``n`` tokens: reset each
        cache's device ``length`` and its ``host_length`` (positions >=
        length are masked out of attention, so stale rows are
        unreachable, and the next append writes row ``n``)."""
        for c in caches:
            c.length.fill_(n)
            c.host_length = n
        return caches

    def propose(self, req, k: int) -> List[int]:
        ctx = [int(t) for t in req.prompt] + [int(t) for t in req.out_tokens]
        n = len(ctx)
        k = min(k, self.max_len - n)
        if k <= 0 or n == 0:
            return []
        st = self._by_rid.get(req.rid)
        if st is None or st["n"] > n:
            # a fresh request, or the context shrank (a preemption
            # retracted a token): start over
            st = {"caches": self.model.init_decode_state(1, self.max_len,
                                                         self.device),
                  "n": 0}
            self._by_rid[req.rid] = st
        caches = st["caches"]
        dev = caches[0].length.device
        # absorb the context delta; ``logits`` then predict the next
        # position
        logits = None
        for t in ctx[st["n"]:]:
            logits, caches = self.model.decode(
                self.params, caches,
                torch.full((1,), t, dtype=torch.int64, device=dev))
        st["n"] = n
        if logits is None:   # context unchanged: nothing new to say
            return []
        out: List[int] = []
        while True:
            out.append(int(torch.argmax(logits[0])))  # sync: draft argmax
            if len(out) >= k:
                break
            logits, caches = self.model.decode(
                self.params, caches,
                torch.full((1,), out[-1], dtype=torch.int64, device=dev))
        self._rewind(caches, n)
        return out
