"""Trainer: the loop and its fault tolerance (checkpoint/restart,
preemption, straggler watchdog) around ``make_train_step`` (port of
``repro/train/trainer.py``).

* Checkpoints save (params, optimizer, data step) in the JAX package's
  format and layout (``train_state_to_jax``), with an atomic manifest;
  a restart resumes at the exact step with the exact next batch (the
  data pipeline is deterministic in (seed, step)), and a checkpoint
  either package wrote restores in the other.
* SIGTERM triggers an emergency checkpoint at the next step boundary.
* A wall-clock watchdog flags steps slower than ``straggler_factor`` x
  the trailing median (logged and recorded).

The step is timed to its end on the device (``torch.cuda.synchronize``,
where JAX blocks on the loss).
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.registry import Model
from repro_torch.train.train_step import (StepConfig, TrainState,
                                          init_train_state, make_train_step,
                                          train_state_from_jax,
                                          train_state_to_jax)
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    seed: int = 0


class Trainer:
    def __init__(self, model: Model, dataset: SyntheticLMDataset,
                 cfg: TrainerConfig, step_cfg: StepConfig = StepConfig(),
                 mesh=None, log_fn: Callable[[str], None] = print,
                 device=None):
        self.model = model
        self.dataset = dataset
        self.cfg = cfg
        self.step_cfg = step_cfg
        self.device = resolve_device(device)
        self.log = log_fn
        self.step_fn = make_train_step(model, mesh, step_cfg,
                                       global_batch=dataset.global_batch)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep=cfg.keep_checkpoints)
        self.straggler_events: list[int] = []
        self._durations: list[float] = []
        self.step = 0
        self.state: Optional[TrainState] = None

    # -- state ----------------------------------------------------------
    def init_or_restore(self) -> TrainState:
        fresh = init_train_state(self.model, self.cfg.seed,
                                 self.step_cfg.param_dtype, self.device)
        last = latest_step(self.cfg.checkpoint_dir)
        if last is None:
            self.state = fresh
            return self.state
        np_state, extra = restore_checkpoint(
            self.cfg.checkpoint_dir, last,
            train_state_to_jax(fresh, self.model.cfg))
        self.state = train_state_from_jax(np_state, self.model.cfg,
                                          self.device,
                                          self.step_cfg.param_dtype)
        self.step = int(extra["step"])
        self.dataset.state.step = int(extra["data_step"])
        self.log(f"[trainer] restored step={self.step}")
        return self.state

    def _extra(self) -> dict:
        return {"step": self.step, "data_step": self.dataset.state.step}

    def _save(self):
        self.ckpt.save(self.step, train_state_to_jax(self.state,
                                                     self.model.cfg),
                       extra=self._extra())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loop ------------------------------------------------------------
    def run(self) -> dict:
        if self.state is None:
            self.init_or_restore()
        history = []
        while self.step < self.cfg.total_steps:
            batch = self.dataset.next_batch()
            t0 = time.monotonic()
            self.state, metrics = self.step_fn(self.state, batch)
            self._sync()
            dur = time.monotonic() - t0
            self.step += 1
            history.append(float(metrics["loss"]))

            # straggler watchdog
            if len(self._durations) >= 5:
                med = statistics.median(self._durations[-20:])
                if dur > self.cfg.straggler_factor * med:
                    self.straggler_events.append(self.step)
                    self.log(f"[trainer] straggler at step {self.step}: "
                             f"{dur:.3f}s vs median {med:.3f}s")
            self._durations.append(dur)

            if self.step % self.cfg.log_every == 0:
                self.log(f"[trainer] step={self.step} "
                         f"loss={float(metrics['loss']):.4f} "
                         f"gnorm={float(metrics['grad_norm']):.3f} "
                         f"lr={float(metrics['lr']):.2e} {dur*1e3:.0f}ms")
            if self.step % self.cfg.checkpoint_every == 0:
                self._save()
            if self.ckpt.preempted:
                self.ckpt.maybe_emergency_save(
                    self.step, train_state_to_jax(self.state,
                                                  self.model.cfg),
                    extra=self._extra())
                self.log("[trainer] preemption checkpoint written; exiting")
                break
        if self.step % self.cfg.checkpoint_every:
            self._save()
        return {"losses": history, "stragglers": self.straggler_events,
                "final_step": self.step}
