"""Checkpoints with atomic manifests, in the JAX package's on-disk format
(port of ``repro/checkpoint/checkpointing.py``).

* Each process writes its leaves into ``step_XXXXXXXXXX/shards-<process>
  .npz``, keyed by ``<leaf-path>@<offset-tuple>``; leaves are whole
  arrays here (the port does not shard a train state), written by
  process 0 at offset 0, as JAX writes an unsharded array.
* ``manifest.json`` (written last, atomically via rename, by process 0)
  records every leaf's global shape and dtype, the step and ``extra``. A
  checkpoint without a manifest is invisible to ``latest_step``.
* Leaf paths are what JAX's ``_flatten_with_paths`` prints: dict keys
  (sorted), NamedTuple fields as ``.name``, list indices, joined by
  ``::`` — so a port ``TrainState`` saved in JAX's layout
  (``train.train_step.train_state_to_jax``) reads back in JAX, and JAX's
  in the port.
* ``CheckpointManager`` adds retention and a SIGTERM emergency save.

Leaves may be tensors (copied to the host) or numpy arrays; restore
returns numpy arrays on ``target``'s tree.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

SEP = "::"


def _process() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flatten_with_paths(tree: Any, prefix: tuple = ()) -> list:
    """[(path string, leaf)] in JAX's leaf order."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(SEP.join(prefix), tree)]
    return [kv for name, sub in items
            for kv in _flatten_with_paths(sub, prefix + (name,))]


def _unflatten(target: Any, leaves) -> Any:
    """``target``'s tree with its leaves replaced, in flatten order."""
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_unflatten(getattr(target, f), leaves)
                              for f in target._fields))
    if isinstance(target, dict):
        out = {k: _unflatten(target[k], leaves) for k in sorted(target)}
        return {k: out[k] for k in target}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(x, leaves) for x in target)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(leaf)


def _write_atomic(path: str, write, mode: str = "wb") -> None:
    d = os.path.dirname(path)
    with tempfile.NamedTemporaryFile(mode, dir=d, delete=False) as tmp:
        write(tmp)
        tmp.flush()
        os.fsync(tmp.fileno())
        name = tmp.name
    os.replace(name, path)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Save ``tree`` (tensors or numpy arrays) for ``step``."""
    ckpt_dir = os.path.join(directory, f"step_{step:010d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    pidx, pcount = _process()
    shards: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    for key, leaf in _flatten_with_paths(tree):
        if leaf is None:
            continue
        arr = _host(leaf)
        meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        if pidx == 0:
            shards[f"{key}@{','.join(['0'] * arr.ndim)}"] = arr
    _write_atomic(os.path.join(ckpt_dir, f"shards-{pidx:05d}.npz"),
                  lambda f: np.savez(f, **shards))
    if pidx == 0:
        manifest = {"step": step, "leaves": meta, "extra": extra or {},
                    "process_count": pcount}
        # the manifest lands last: the atomic commit
        _write_atomic(os.path.join(ckpt_dir, "manifest.json"),
                      lambda f: json.dump(manifest, f), mode="w")
    return ckpt_dir


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.match(r"step_(\d+)$", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int,
                       target: Any) -> tuple[Any, dict]:
    """Restore onto ``target``'s tree structure (its leaves are not read)
    from every shard file, whatever the number of processes that wrote
    them. Returns (tree of numpy arrays, extra)."""
    ckpt_dir = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    blobs: dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(ckpt_dir)):
        if name.startswith("shards-") and name.endswith(".npz"):
            with np.load(os.path.join(ckpt_dir, name)) as z:
                for k in z.files:
                    blobs[k] = z[k]
    assembled: dict[str, np.ndarray] = {}
    for key, info in manifest["leaves"].items():
        full = np.zeros(info["shape"], dtype=np.dtype(info["dtype"]))
        for bk, arr in blobs.items():
            base, offs = bk.rsplit("@", 1)
            if base != key:
                continue
            off = tuple(int(o) for o in offs.split(",")) if offs else ()
            full[tuple(slice(o, o + s) for o, s in zip(off, arr.shape))] = arr
        assembled[key] = full
    leaves = []
    for key, _ in _flatten_with_paths(target):
        if key not in assembled:
            raise KeyError(f"checkpoint missing leaf {key}")
        leaves.append(assembled[key])
    return _unflatten(target, iter(leaves)), manifest["extra"]


class CheckpointManager:
    """Retention + SIGTERM emergency save (preemption tolerance)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._preempted = threading.Event()
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            pass  # not in the main thread

    def _on_sigterm(self, *_):
        self._preempted.set()

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        path = save_checkpoint(self.directory, step, tree, extra)
        self._gc()
        return path

    def maybe_emergency_save(self, step: int, tree: Any,
                             extra: Optional[dict] = None) -> bool:
        if self._preempted.is_set():
            save_checkpoint(self.directory, step, tree, extra)
            return True
        return False

    def _gc(self):
        if _process()[0] != 0:
            return
        steps = sorted(
            int(m.group(1)) for name in os.listdir(self.directory)
            if (m := re.match(r"step_(\d+)$", name)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
