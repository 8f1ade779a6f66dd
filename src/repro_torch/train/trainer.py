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

Under a mesh (``Trainer(mesh=)``, one process a position) the state is
the sharded step's: a fresh one is drawn whole from the seed and placed
onto the specs (``step_fn.place``), a checkpoint is restored straight
into each rank's blocks on any mesh (elastic) and saved as blocks at
JAX's offsets, each rank takes its block of every global batch
(``global_batch_arrays``), the losses are the global batch's, a SIGTERM
on any rank checkpoints every rank at the same step, and only the rank at
coordinate 0 on every axis logs.
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
from repro_torch.distributed.collectives import any_rank
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
        self.mesh = mesh
        lead = mesh is None or all(c == 0 for c in mesh.coords.values())
        self.log = log_fn if lead else (lambda msg: None)
        self.step_fn = make_train_step(model, mesh, step_cfg,
                                       global_batch=dataset.global_batch)
        self._bspecs = (dataset.batch_pspecs(mesh) if mesh is not None
                        else None)
        self.ckpt = CheckpointManager(cfg.checkpoint_dir,
                                      keep=cfg.keep_checkpoints)
        self.straggler_events: list[int] = []
        self._durations: list[float] = []
        self.step = 0
        self.state: Optional[TrainState] = None

    # -- state ----------------------------------------------------------
    def init_or_restore(self) -> TrainState:
        last = latest_step(self.cfg.checkpoint_dir)
        layout = getattr(self.step_fn, "layout", None)
        if last is None:
            fresh = init_train_state(self.model, self.cfg.seed,
                                     self.step_cfg.param_dtype, self.device)
            self.state = fresh if layout is None else layout.place(fresh)
            return self.state
        if layout is None:
            fresh = init_train_state(self.model, self.cfg.seed,
                                     self.step_cfg.param_dtype, self.device)
            np_state, extra = restore_checkpoint(
                self.cfg.checkpoint_dir, last,
                train_state_to_jax(fresh, self.model.cfg))
            self.state = train_state_from_jax(np_state, self.model.cfg,
                                              self.device,
                                              self.step_cfg.param_dtype)
        else:
            np_state, extra = restore_checkpoint(
                self.cfg.checkpoint_dir, last, layout.target(),
                blocks=layout.regions())
            self.state = layout.from_numpy(np_state, self.device)
        self.step = int(extra["step"])
        self.dataset.state.step = int(extra["data_step"])
        self.log(f"[trainer] restored step={self.step}")
        return self.state

    def _extra(self) -> dict:
        return {"step": self.step, "data_step": self.dataset.state.step}

    def _tree(self):
        """The state as a checkpoint holds it (JAX's layout)."""
        if self.mesh is None:
            return train_state_to_jax(self.state, self.model.cfg)
        return self.step_fn.layout.checkpoint_tree(self.state)

    def _save(self):
        self.ckpt.save(self.step, self._tree(), extra=self._extra())

    def _preempted(self) -> bool:
        if self.mesh is None:
            return self.ckpt.preempted
        return any_rank(self.ckpt.preempted, self.mesh)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loop ------------------------------------------------------------
    def run(self) -> dict:
        if self.state is None:
            self.init_or_restore()
        history = []
        while self.step < self.cfg.total_steps:
            batch = (self.dataset.next_batch() if self.mesh is None else
                     self.dataset.global_batch_arrays(self.mesh,
                                                      self._bspecs))
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
            if self._preempted():
                # the save below, unless this step's just ran
                self.log("[trainer] preempted: checkpointing and exiting")
                break
        if self.step % self.cfg.checkpoint_every:
            self._save()
        return {"losses": history, "stragglers": self.straggler_events,
                "final_step": self.step}
