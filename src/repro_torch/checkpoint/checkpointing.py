"""Checkpoints with atomic manifests, in the JAX package's on-disk format
(port of ``repro/checkpoint/checkpointing.py``).

* Each process (a rank of the ``torch.distributed`` world) writes its
  leaves into ``step_XXXXXXXXXX/shards-<rank>.npz``, keyed by
  ``<leaf-path>@<offset-tuple>``. A whole array is written by rank 0 at
  offset 0, as JAX writes an unsharded array; a :class:`Block` (a rank's
  block of a sharded train state, ``train/sharded.py``) by the one rank
  that holds it with ``write`` set — JAX's ``replica_id == 0`` — at its
  offsets in JAX's stacked coordinates.
* ``manifest.json`` (written last, atomically via rename, by rank 0,
  after every rank's shards: a barrier when the tree holds blocks)
  records every leaf's global shape and dtype, the step, ``extra`` and
  the world size. A checkpoint without a manifest is invisible to
  ``latest_step``.
* Restore reassembles each leaf from whatever shard files cover it, on
  any world (elastic): a whole array, or with ``blocks`` only the region
  a rank holds on its mesh.
* Leaf paths are what JAX's ``_flatten_with_paths`` prints: dict keys
  (sorted), NamedTuple fields as ``.name``, list indices, joined by
  ``::`` — so a port ``TrainState`` saved in JAX's layout
  (``train.train_step.train_state_to_jax``) reads back in JAX, and JAX's
  in the port.
* ``CheckpointManager`` adds retention and a SIGTERM emergency save.

Leaves may be tensors (copied to the host), numpy arrays or blocks;
restore returns numpy arrays on ``target``'s tree.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import tempfile
import threading
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

SEP = "::"


class Block(NamedTuple):
    """One rank's block of a sharded leaf: ``data`` (a tensor or array) at
    ``offsets`` in an array of ``shape``; ``write`` on the one rank that
    writes it (coordinate 0 on every mesh axis that replicates it)."""
    data: Any
    offsets: tuple
    shape: tuple
    write: bool


def _process() -> tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _flatten_with_paths(tree: Any, prefix: tuple = (),
                        is_leaf=lambda x: isinstance(x, Block)) -> list:
    """[(path string, leaf)] in JAX's leaf order (``is_leaf`` marks a
    leaf that is itself a tuple)."""
    if is_leaf(tree):
        return [(SEP.join(prefix), tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(SEP.join(prefix), tree)]
    return [kv for name, sub in items
            for kv in _flatten_with_paths(sub, prefix + (name,), is_leaf)]


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
    """Save ``tree`` (tensors, numpy arrays or :class:`Block`s) for
    ``step``; every rank of the world calls it."""
    ckpt_dir = os.path.join(directory, f"step_{step:010d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    pidx, pcount = _process()
    shards: dict[str, np.ndarray] = {}
    meta: dict[str, dict] = {}
    sharded = False
    for key, leaf in _flatten_with_paths(tree):
        if leaf is None:
            continue
        if isinstance(leaf, Block):
            sharded = True
            # the dtype from an empty slice: a replica is not copied out
            dtype = _host(leaf.data.reshape(-1)[:0]).dtype
            meta[key] = {"shape": list(leaf.shape), "dtype": str(dtype)}
            if leaf.write:
                shards[f"{key}@{','.join(map(str, leaf.offsets))}"] = \
                    _host(leaf.data)
            continue
        arr = _host(leaf)
        meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        if pidx == 0:
            shards[f"{key}@{','.join(['0'] * arr.ndim)}"] = arr
    _write_atomic(os.path.join(ckpt_dir, f"shards-{pidx:05d}.npz"),
                  lambda f: np.savez(f, **shards))
    if sharded:
        _barrier()     # every rank's shards land before the manifest
    if pidx == 0:
        manifest = {"step": step, "leaves": meta, "extra": extra or {},
                    "process_count": pcount}
        # the manifest lands last: the atomic commit
        _write_atomic(os.path.join(ckpt_dir, "manifest.json"),
                      lambda f: json.dump(manifest, f), mode="w")
    if sharded:
        _barrier()     # no rank returns before the commit
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


def _region(off: tuple, size: tuple, want: tuple):
    """(destination, source) index tuples of the overlap of a blob at
    ``off`` of ``size`` with the region ``want`` (slices), or None."""
    dst, src = [], []
    for o, s, w in zip(off, size, want):
        lo, hi = max(o, w.start), min(o + s, w.stop)
        if lo >= hi:
            return None
        dst.append(slice(lo - w.start, hi - w.start))
        src.append(slice(lo - o, hi - o))
    return tuple(dst), tuple(src)


def _blob_shape(z, key: str) -> tuple:
    """The shape of blob ``key`` of an open npz, from its ``.npy`` header
    alone (the blob's data is not read)."""
    with z.zip.open(key + ".npy") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return tuple(read(f)[0])


def restore_checkpoint(directory: str, step: int, target: Any,
                       blocks: Any = None) -> tuple[Any, dict]:
    """Restore onto ``target``'s tree structure (its leaves are not read)
    from every shard file, whatever the number of processes that wrote
    them. ``blocks``: an optional tree like ``target`` of tuples of
    slices, the region of each leaf to assemble (a rank's block on its
    mesh), else every leaf whole; a blob that does not overlap its
    leaf's region is not read. Returns (tree of numpy arrays,
    extra)."""
    ckpt_dir = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten_with_paths(target)
    region = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(w, slice) for w in x)
    wants = ([w for _, w in _flatten_with_paths(blocks, is_leaf=region)]
             if blocks is not None else [None] * len(flat))
    out: dict[str, np.ndarray] = {}
    regions: dict[str, tuple] = {}
    for (key, _), want in zip(flat, wants):
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key}")
        info = manifest["leaves"][key]
        shape = tuple(info["shape"])
        want = tuple(slice(0, n) for n in shape) if want is None else want
        regions[key] = want
        out[key] = np.zeros(tuple(w.stop - w.start for w in want),
                            dtype=np.dtype(info["dtype"]))
    for name in sorted(os.listdir(ckpt_dir)):
        if not (name.startswith("shards-") and name.endswith(".npz")):
            continue
        with np.load(os.path.join(ckpt_dir, name)) as z:
            for k in z.files:
                base, offs = k.rsplit("@", 1)
                if base not in regions:
                    continue
                off = tuple(int(o) for o in offs.split(",")) if offs else ()
                hit = _region(off, _blob_shape(z, k), regions[base])
                if hit is not None:
                    out[base][hit[0]] = z[k][hit[1]]
    leaves = [out[key] for key, _ in flat]
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

    def _gc(self):
        if _process()[0] != 0:
            return
        steps = sorted(
            int(m.group(1)) for name in os.listdir(self.directory)
            if (m := re.match(r"step_(\d+)$", name)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
