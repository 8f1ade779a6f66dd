"""The hook through which the kernel wrappers and the port's collectives
report their work to the dry run's counter.

Neither shows at the aten level: a kernel is a ``ctypes`` launch on the
card (shape-only outputs on meta), and a collective is a
``torch.distributed`` call. So each reports itself here, and the counter
(``launch/op_cost.OpCounter``) sets :data:`ACTIVE` while it counts. With
no counter active, a report is a single global read.
"""
from __future__ import annotations

import contextlib

#: the counter of the step being counted, or None. It has
#: ``kernel(name, work)``, a context, and ``collective(kind, nbytes)``.
ACTIVE = None

#: wire bytes per payload byte (ring algorithms move ~1x a chip's
#: payload; an all-reduce is a reduce-scatter + an all-gather, 2x)
COLLECTIVE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                     "reduce-scatter": 1.0, "all-to-all": 1.0,
                     "broadcast": 1.0}

_NULL = contextlib.nullcontext()


def kernel_call(name: str, work_fn):
    """The context of one kernel wrapper's call: where a counter is
    active, counts ``work_fn()`` (a ``kernels/work.py`` ``Work``) and
    quiets the aten ops beneath; else nothing (``work_fn`` is not
    called)."""
    c = ACTIVE
    if c is None:
        return _NULL
    return c.kernel(name, work_fn())


def collective(kind: str, x) -> None:
    """Record one collective of ``kind`` over the tensor ``x``'s bytes
    where a counter is active."""
    c = ACTIVE
    if c is not None:
        c.collective(kind, x.numel() * x.element_size())
