"""Speculative multi-token decode (DESIGN.md §15; port of
``repro/spec/``).

Three layers: *proposers* guess the next k tokens host-side
(spec/propose.py — protocol + registry, built-in ``ngram`` and
``draft``), the *verifier* scores a whole span against the paged
quantized cache in one dispatch and commits only accepted tokens
(spec/verify.py), and ``EngineCore`` (serve/core.py) wires both into its
step loop behind ``spec=SpecConfig(...)`` — greedy outputs stay those of
plain decode by construction.
"""
from repro_torch.spec.config import SpecConfig
from repro_torch.spec.draft import DraftModelProposer
from repro_torch.spec.propose import (DraftProposer, NgramProposer,
                                      get_proposer, list_proposers,
                                      make_proposer, register_proposer)
from repro_torch.spec.verify import (make_scan_verifier, make_span_verifier,
                                     make_verifier)

__all__ = [
    "SpecConfig",
    "DraftProposer",
    "DraftModelProposer",
    "NgramProposer",
    "register_proposer",
    "get_proposer",
    "list_proposers",
    "make_proposer",
    "make_verifier",
    "make_scan_verifier",
    "make_span_verifier",
]
