"""Speculative-decode configuration (port of ``repro/spec/config.py``,
a copy: host-only)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Knobs for ``EngineCore(spec=...)`` multi-token decode.

    ``mode`` names a registered proposer ("ngram", "draft") or "off";
    ``k`` caps the draft tokens verified per dispatch, so one step
    retires 1..k+1 tokens. Speculation requires greedy sampling — the
    verifier's acceptance rule compares the target model's argmax per
    position (DESIGN.md §15).
    """

    mode: str = "off"
    k: int = 4

    # ngram proposer: match the last n in [min_ngram, max_ngram] context
    # tokens against earlier context, longest n first
    max_ngram: int = 3
    min_ngram: int = 1

    # draft-model proposer: "" derives a shrunk copy of the target config
    # (draft_layers layers, no quantization); "self" reuses the target
    # model+params (an oracle up to dense-vs-paged parity); any other
    # string is a configs registry name
    draft_arch: str = ""
    draft_layers: int = 2
    draft_seed: int = 0

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.min_ngram < 1 or self.max_ngram < self.min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{self.min_ngram}, {self.max_ngram}]")
