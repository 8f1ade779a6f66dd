"""Process meshes over a ``torch.distributed`` world (port of
``repro/launch/mesh.py``).

JAX lays a mesh over the devices of one program; here each mesh position
is one process (one rank of the ``torch.distributed`` world), laid out in
row-major order over ``shape`` as ``jax.make_mesh`` lays out devices. A
:class:`Mesh` has JAX's ``.shape`` (an ordered dict, axis -> size) and
``.axis_names``, so the pure spec resolvers of ``distributed/sharding.py``
take either package's mesh (or a test double with those two attributes).
It also carries what a rank needs to run collectives itself: its
coordinate on each axis, the global ranks of its line along each axis and
one process group per line (with, where the world's backend is not gloo,
a gloo twin for host-side agreement on CPU tensors; the ``fake``
backend of a dry run, which moves no data, is its own twin).

A mesh of one position needs no world: built before
``init_process_group`` it has no groups and every collective over it is
the identity. The world's process group gets its address, size, rank and a
timeout from :func:`init_world`, and every group :func:`make_mesh` creates
gets the same timeout; nothing here reads the environment (the launchers
hand :func:`launcher_world` theirs).

Axes:
  * ``pod``   — inter-pod axis; composes with ``data`` for data-parallel
                work.
  * ``data``  — intra-pod data-parallel axis.
  * ``model`` — tensor (head) parallel axis.

:func:`make_production_mesh` is JAX's 16 x 16 and 2 x 16 x 16 layouts;
it needs a world of 256 or 512 ranks (the dry run's ``fake`` world,
``launch/dryrun_lib.py``).
"""
from __future__ import annotations

import datetime
import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.utils import resolve_device

#: what ``python -m torch.distributed.run`` sets for each process it starts
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

#: the longest a collective may wait for its peers before the group
#: fails: ranks whose host decisions diverged issue mismatched
#: collectives, and a run must then fail rather than stall
DEFAULT_TIMEOUT_S = 60.0

#: the timeout :func:`init_world` gave the world; :func:`make_mesh` gives
#: it to every group it creates (``new_group`` without one would take the
#: backend's default, up to 30 min)
_world_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def launcher_world(environ) -> dict | None:
    """This process as the launcher started it — {"rank", "size",
    "local", "local_size"} from ``environ`` (``os.environ``) — or None
    where one of :data:`LAUNCHER_VARS` is missing."""
    if any(v not in environ for v in LAUNCHER_VARS):
        return None
    size = int(environ["WORLD_SIZE"])
    return {"rank": int(environ["RANK"]), "size": size,
            "local": int(environ.get("LOCAL_RANK", environ["RANK"])),
            "local_size": int(environ.get("LOCAL_WORLD_SIZE", size))}


def rank_device(device, world: dict | None) -> tuple[torch.device, str]:
    """(this rank's device, the world's backend): the named device, or the
    card — each rank its own when the node has a card for every local
    rank (NCCL), else the first for all (gloo)."""
    if device is not None or world is None:
        return resolve_device(device), "gloo"
    dev = resolve_device(None)
    if torch.cuda.device_count() >= world["local_size"]:
        return torch.device("cuda", world["local"]), "nccl"
    return dev, "gloo"


def init_world(rank: int, world_size: int, init_method: str, backend: str,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``init_process_group`` with an explicit address (``tcp://host:port``
    or ``file://path``), size, rank and timeout (at most 120 s)."""
    global _world_timeout
    if not 0 < timeout_s <= 120:
        raise ValueError(f"timeout_s must be in (0, 120], got {timeout_s}")
    _world_timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size, timeout=_world_timeout)


class Mesh:
    """This rank's view of a process mesh: ``shape`` (axis -> size, in
    axis order), ``axis_names``, ``coords`` (axis -> this rank's
    coordinate), ``lines`` (axis -> the global ranks along that axis
    through this rank, in coordinate order) and, in a world, ``groups``
    (axis -> the process group of that line) and ``host_groups`` (axis ->
    a gloo group over the same line, for CPU tensors)."""

    def __init__(self, shape: dict, coords: dict, lines: dict,
                 groups: dict | None = None,
                 host_groups: dict | None = None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.coords = dict(coords)
        self.lines = {a: tuple(r) for a, r in lines.items()}
        self.groups = groups or {}
        self.host_groups = host_groups or {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None
        outside a world: collectives over it are the identity)."""
        return self.groups.get(axis)

    def host_group(self, axis: str):
        """A gloo group over this rank's line along ``axis`` (None
        outside a world)."""
        return self.host_groups.get(axis)

    def backend(self, axis: str) -> str | None:
        """The backend of ``axis``'s group: ``"nccl"``, ``"gloo"``, or None
        outside a world."""
        g = self.group(axis)
        return None if g is None else str(dist.get_backend(g))

    def capturable(self, axis: str) -> bool:
        """Whether a CUDA graph can capture collectives over ``axis``:
        NCCL's can be captured, gloo's (which stage CUDA tensors through
        the host) cannot; outside a world there is no collective."""
        return self.backend(axis) in (None, "nccl")


def _line_ranks(shape: tuple[int, ...], coords: tuple[int, ...],
                ax: int) -> list[int]:
    """Row-major ranks of the line along axis ``ax`` through ``coords``."""
    out = []
    for i in range(shape[ax]):
        c = list(coords)
        c[ax] = i
        r = 0
        for size, ci in zip(shape, c):
            r = r * size + ci
        out.append(r)
    return out


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over ``axes``, rank ``r`` at the row-major
    position ``r`` (``jax.make_mesh``'s device order). In a world, the
    world size must be ``prod(shape)``, and every rank must call this with
    the same arguments in the same order: it creates one process group per
    line of every axis, as ``new_group`` requires of all ranks, each with
    the world's timeout from :func:`init_world`. Outside a
    world ``shape`` must hold one position."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    size = math.prod(shape)
    in_world = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if in_world else 1
    if size != world:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} holds {size} positions but the "
            f"world has {world} process(es)"
            + ("" if in_world else " (call init_world first)"))
    rank = dist.get_rank() if in_world else 0
    coords, r = [], rank
    for s in reversed(shape):
        coords.append(r % s)
        r //= s
    coords = tuple(reversed(coords))
    lines = {a: _line_ranks(shape, coords, i) for i, a in enumerate(axes)}
    groups, host_groups = {}, {}
    if in_world:
        # a fake world (the dry run) has no gloo twin; its groups move
        # no data, on the host or elsewhere
        gloo_world = dist.get_backend() in ("gloo", "fake")
        for i, a in enumerate(axes):
            rest = [range(s) for j, s in enumerate(shape) if j != i]
            for other in itertools.product(*rest):
                c = list(other)
                c.insert(i, 0)
                ranks = _line_ranks(shape, tuple(c), i)
                g = dist.new_group(ranks, timeout=_world_timeout)
                hg = g if gloo_world else dist.new_group(
                    ranks, backend="gloo", timeout=_world_timeout)
                if rank in ranks:
                    groups[a], host_groups[a] = g, hg
    return Mesh(dict(zip(axes, shape)), dict(zip(axes, coords)), lines,
                groups, host_groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production layouts: ``(data 16, model 16)``, or ``(pod 2,
    data 16, model 16)`` with ``multi_pod``. A world of 256 (512) ranks
    must be up (:func:`make_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over every rank of the world (one
    position outside a world), ``model_axis`` wide where the world allows."""
    n = dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1
    model_axis = min(model_axis, n)
    return make_mesh((n // model_axis, model_axis), ("data", "model"))


def data_axes(mesh) -> tuple[str, ...]:
    """Mesh axes forming the data-parallel dimension."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes a ``PartitionSpec`` entry names: none (None), one
    (a name) or several (a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def entry_index(mesh, entry) -> tuple[int, int]:
    """(index, count) of this rank's block along a dimension whose spec
    entry is ``entry``: the coordinates on its axes combined row-major,
    as JAX lays a tuple entry's devices, over the product of their
    sizes."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx, n = idx * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a]
    return idx, n


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)
