"""Deterministic synthetic LM data pipeline (port of
``repro/data/pipeline.py``).

Learnable token streams (a mixture of Markov "documents" with
per-document grammars), fully deterministic in (seed, step): resuming
after a crash replays the exact batch sequence, and the trainer
checkpoints only (seed, step). Host-sharded: each process materializes
only its slice of the global batch. The tokens are numpy and equal JAX's
bit for bit.

The stubbed modality frontends' inputs (the VLM's ``patches``, the
encoder-decoder's ``frames``) are standard normals from a numpy generator
seeded from (seed, step), where JAX draws them with ``jax.random.normal``
(the port replays no ``jax.random`` stream; ROADMAP §3). Parity tests
hand both packages the same numpy batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


def _world() -> tuple[int, int]:
    """(rank, world size) of the ``torch.distributed`` group when one is
    up, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticLMDataset:
    """Markov-mixture token stream. One instance per host process."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, num_grammars: int = 16, order: int = 2,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.state = DataState(seed=seed, step=0)
        rank, world = _world()
        self.process_index = rank if process_index is None else process_index
        self.process_count = world if process_count is None else process_count
        if global_batch % self.process_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.process_count} processes")
        self.local_batch = global_batch // self.process_count
        self.vocab = cfg.vocab_size
        self.order = order
        rng = np.random.default_rng(seed)
        # per-grammar transition "logits" over a hashed context (drawn as
        # JAX does, so the generator's state matches; unused by _tokens)
        self._proj = rng.standard_normal((num_grammars, 64)).astype(np.float32)
        self.num_grammars = num_grammars

    def _tokens(self, step: int, rows: np.ndarray, length: int) -> np.ndarray:
        """Deterministic learnable tokens for the given global row ids:
        each document follows an order-1 chain over a small (64-symbol)
        per-grammar alphabet with 10% noise."""
        alpha = min(64, self.vocab)
        out = np.empty((len(rows), length), np.int64)
        for i, row in enumerate(rows):
            rng = np.random.default_rng(
                (self.state.seed * 1_000_003 + step) * 65_537 + int(row))
            grammar = int(rng.integers(self.num_grammars))
            base = (grammar * 97) % max(self.vocab - alpha, 1)
            a, c = 5 + 2 * grammar, 17 + grammar
            idx = int(rng.integers(alpha))
            noise = rng.random(length) < 0.1
            rand_idx = rng.integers(alpha, size=length)
            seq = np.empty(length, np.int64)
            for j in range(length):
                seq[j] = base + idx
                idx = int(rand_idx[j]) if noise[j] else (a * idx + c) % alpha
            out[i] = seq
        return out

    def local_batch_np(self, step: Optional[int] = None) -> dict:
        """This process's rows of batch ``step`` (the current step unless
        named): ``tokens`` (local_batch, seq_len + 1) int32 (the VLM's text
        is ``frontend_tokens`` shorter), plus ``patches`` (VLM) or
        ``frames`` (encoder-decoder) (local_batch, frontend_tokens,
        frontend_dim) float32."""
        step = self.state.step if step is None else step
        lo = self.process_index * self.local_batch
        rows = np.arange(lo, lo + self.local_batch)
        cfg = self.cfg
        text = self.seq_len - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
        batch = {"tokens": self._tokens(step, rows, text + 1).astype(np.int32)}
        if cfg.family in ("encdec", "vlm"):
            rng = np.random.default_rng((self.state.seed << 20) ^ step)
            feats = rng.standard_normal(
                (self.local_batch, cfg.frontend_tokens, cfg.frontend_dim),
                dtype=np.float32)
            batch["frames" if cfg.family == "encdec" else "patches"] = feats
        return batch

    def next_batch(self) -> dict:
        b = self.local_batch_np()
        self.state.step += 1
        return b
