"""Deterministic synthetic LM data pipeline (port of
``repro/data/pipeline.py``).

Learnable token streams (a mixture of Markov "documents" with
per-document grammars), fully deterministic in (seed, step): resuming
after a crash replays the exact batch sequence, and the trainer
checkpoints only (seed, step). Host-sharded: each process materializes
only its slice of the global batch — under a mesh (``mesh=``) the slice
of its data coordinate, so the ranks along ``model`` see the same rows,
and :meth:`SyntheticLMDataset.global_batch_arrays` gives a rank its block
of the global batch per ``batch_pspecs``. The tokens are numpy and equal
JAX's bit for bit.

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


def _data_block(mesh, entry, global_batch: int) -> tuple[int, int]:
    """(index, count) of this rank's block of the batch rows over a spec
    entry (a data axis, a tuple of them, or None: the whole batch)."""
    from repro_torch.launch.mesh import entry_index
    idx, n = entry_index(mesh, entry)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} data positions")
    return idx, n


class SyntheticLMDataset:
    """Markov-mixture token stream. One instance per host process."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, num_grammars: int = 16, order: int = 2,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None, mesh=None):
        """``mesh``: the process index and count are the rank's data
        coordinate and the data positions (the whole batch, index 0 of 1,
        where it does not split over them: ``batch_pspecs``' rule); without
        one, the world's rank and size."""
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.state = DataState(seed=seed, step=0)
        if mesh is not None:
            from repro_torch.distributed.sharding import batch_pspecs
            spec = batch_pspecs({"tokens": np.zeros((global_batch, 1))}, mesh,
                                global_batch)["tokens"]
            rank, world = _data_block(mesh, spec[0], global_batch)
        else:
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

    def _rows(self, step: int, lo: int, count: int) -> dict:
        """Global rows ``[lo, lo + count)`` of batch ``step``."""
        rows = np.arange(lo, lo + count)
        cfg = self.cfg
        text = self.seq_len - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
        batch = {"tokens": self._tokens(step, rows, text + 1).astype(np.int32)}
        if cfg.family in ("encdec", "vlm"):
            rng = np.random.default_rng((self.state.seed << 20) ^ step)
            feats = rng.standard_normal(
                (count, cfg.frontend_tokens, cfg.frontend_dim),
                dtype=np.float32)
            batch["frames" if cfg.family == "encdec" else "patches"] = feats
        return batch

    def local_batch_np(self, step: Optional[int] = None) -> dict:
        """This process's rows of batch ``step`` (the current step unless
        named): ``tokens`` (local_batch, seq_len + 1) int32 (the VLM's text
        is ``frontend_tokens`` shorter), plus ``patches`` (VLM) or
        ``frames`` (encoder-decoder) (local_batch, frontend_tokens,
        frontend_dim) float32."""
        step = self.state.step if step is None else step
        return self._rows(step, self.process_index * self.local_batch,
                          self.local_batch)

    def next_batch(self) -> dict:
        b = self.local_batch_np()
        self.state.step += 1
        return b

    def batch_pspecs(self, mesh) -> dict:
        """``batch_pspecs`` of this stream's arrays on ``mesh``."""
        from repro_torch.distributed.sharding import batch_pspecs
        keys = ["tokens"] + {"vlm": ["patches"], "encdec": ["frames"]}.get(
            self.cfg.family, [])
        shapes = {k: np.zeros((1,) * (2 if k == "tokens" else 3))
                  for k in keys}
        return batch_pspecs(shapes, mesh, self.global_batch)

    def global_batch_arrays(self, mesh, pspecs: dict) -> dict:
        """The next global batch, as this rank's block of each array per
        ``pspecs`` (``batch_pspecs``: the rows of the rank's data
        coordinate, or every row where the spec leaves the batch whole);
        the block of data coordinate d of n equals ``local_batch_np`` of
        process d of n. Advances the step, as ``next_batch``."""
        step = self.state.step
        self.state.step += 1
        out, cache = {}, {}
        for k in pspecs:
            idx, n = _data_block(mesh, pspecs[k][0], self.global_batch)
            if (idx, n) not in cache:
                count = self.global_batch // n
                cache[(idx, n)] = self._rows(step, idx * count, count)
            out[k] = cache[(idx, n)][k]
        return out
