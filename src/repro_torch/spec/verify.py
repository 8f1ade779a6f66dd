"""Score + accept + commit a draft span in one device dispatch (port of
``repro/spec/verify.py``).

The contract (DESIGN.md §15): score the Q = k+1 span token columns
(column 0 the step's real next token, columns 1..k the zero-padded
drafts) against the slot's paged quantized context without mutating it,
compute the greedy longest-matching-prefix acceptance on the device, and
commit exactly the accepted positions through the append path —
rejected positions never touch the committed state.

Two implementations, both bitwise faithful to vanilla greedy decode:

* **Span verifier** (:func:`make_span_verifier`, for the ``"jnp"`` decode
  backend) — one pass over the layers for all Q positions
  (``model.verify_span``: one attention call per layer whose LUT scores
  fold the span onto the query-head axis, GEMMs and norms per column at
  the decode step's shape), then one fused multi-row append per layer
  (``model.commit_span``).
* **Scan verifier** (:func:`make_scan_verifier`, every other backend,
  the port's default ``"paged_fused"`` included) — the vanilla decode
  step (``model.decode_paged_collect``) run Q times over the token
  columns, then a masked per-position commit (``model.commit_paged``).
  JAX scans a donated copy of the state; the port's caches are written
  in place, so the scan runs on a **shadow state**: buffers allocated
  once (at the first call) into which the live state is copied each
  dispatch. The live state is touched only by the masked commit.

Acceptance (shared): ``n_acc = sum(cumprod(draft_j == argmax_j))`` over
the real draft columns; the emitted tokens are the argmaxes of column 0
and of the ``n_acc`` accepted drafts.

Every verifier is ``verify(params, caches, tokens, draft_len, page_table,
active) -> (preds (S, Q) int32, n_acc (S,) int32, caches)`` with the
caches updated in place and no host synchronisation, so the engine can
capture it as a CUDA graph (``serve/graphs.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core import paged_cache as pgc


def _accept(tokens: torch.Tensor, preds: torch.Tensor,
            draft_len: torch.Tensor) -> torch.Tensor:
    """Greedy longest-matching-prefix: n_acc (S,) accepted drafts."""
    s, q = tokens.shape
    if q <= 1:
        return torch.zeros((s,), dtype=torch.int32, device=tokens.device)
    j = torch.arange(q - 1, device=tokens.device)
    match = (tokens[:, 1:] == preds[:, :q - 1]) & (
        j[None, :] < draft_len[:, None])
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)


def make_verifier(model):
    """The verifier for ``model``: the span verifier when the model decodes
    through the ``"jnp"`` backend (whose gathered formulation the span
    attention reproduces bit for bit), else the scan verifier, which
    shares the vanilla decode step whatever the backend — the selection
    rule of ``repro/spec/verify.py``."""
    if model.cfg.decode_backend == "jnp":
        return make_span_verifier(model)
    return make_scan_verifier(model)


def make_span_verifier(model):
    """Batched verifier: one span forward + one fused span commit."""

    @torch.no_grad()
    def verify(params, caches, tokens, draft_len, page_table, active):
        logits, kvs = model.verify_span(params, caches, tokens, page_table,
                                        active)
        preds = torch.argmax(logits, dim=-1).to(torch.int32)   # (S, Q)
        n_acc = _accept(tokens, preds, draft_len)
        n_keep = torch.where(active, n_acc + 1, torch.zeros_like(n_acc))
        model.commit_span(caches, kvs, page_table, n_keep)
        return preds, n_acc, caches

    verify.kind = "span"
    return verify


class _ScanVerifier:
    """Sequential verifier over a shadow state: one per state it is called
    with (the caches list, by identity), allocated at the first call and
    kept as long as the verifier — a captured graph binds it."""

    kind = "scan"

    def __init__(self, model):
        self.model = model
        self._shadows: list[tuple[list, list]] = []

    def shadow(self, caches: list) -> list:
        """The shadow state of ``caches``."""
        for owner, shadow in self._shadows:
            if owner is caches:
                return shadow
        shadow = [pgc.empty_like_cache(c) for c in caches]
        self._shadows.append((caches, shadow))
        return shadow

    @torch.no_grad()
    def __call__(self, params, caches, tokens, draft_len, page_table,
                 active):
        shadow = self.shadow(caches)
        for dst, src in zip(shadow, caches):
            pgc.copy_cache(dst, src)
        preds, kvs = [], []
        for i in range(tokens.shape[1]):
            logits, _, kv = self.model.decode_paged_collect(
                params, shadow, tokens[:, i], page_table, active)
            preds.append(torch.argmax(logits, dim=-1).to(torch.int32))
            kvs.append(kv)
        preds = torch.stack(preds, dim=1)                      # (S, Q)
        n_acc = _accept(tokens, preds, draft_len)
        for i, kv in enumerate(kvs):
            self.model.commit_paged(caches, kv, page_table,
                                    active & (i <= n_acc))
        return preds, n_acc, caches


def make_scan_verifier(model):
    """Sequential reference verifier: the vanilla decode step per span
    column on a shadow state, then a masked per-position commit."""
    return _ScanVerifier(model)
