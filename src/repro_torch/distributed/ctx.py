"""Logical-axis sharding context (port of ``repro/distributed/ctx.py``).

The engine installs a mesh and a rule set mapping logical axis names to
mesh axes (``distributed/sharding.py``); the paged attention dispatch of
``distributed/serving.py`` reads them to run per head shard. Outside any
context (unit tests, single-process runs) nothing is sharded, so model
code stays mesh-agnostic.

JAX places arrays by annotation (``with_sharding_constraint``); the port
places nothing implicitly — each rank allocates its own block and runs
its own collectives — so :func:`shard` is a no-op kept for the model
code's annotations, and :func:`resolve` only names the spec.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

_state = threading.local()


class PartitionSpec(tuple):
    """A spec entry per array axis: a mesh axis name, a tuple of names, or
    None (replicated). A tuple, so it compares equal to JAX's
    ``PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def current_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: dict[str, object]):
    """rules: logical axis name -> mesh axis (str | tuple | None)."""
    prev = (current_mesh(), current_rules())
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def resolve(logical: Sequence[Optional[str]]) -> Optional[PartitionSpec]:
    rules = current_rules()
    if rules is None:
        return None
    return P(*[rules.get(name) if name else None for name in logical])


def shard(x, logical: Sequence[Optional[str]]):
    """No-op: placement is explicit in the port (see the module doc)."""
    return x
