"""A per-op cost model of one rank's step: the port's counterpart of
``repro/launch/hlo_cost.py``.

JAX's dry run walks the compiled HLO; the port has no compiled program,
so :class:`OpCounter` counts while the step runs. It is a
``TorchDispatchMode``: every aten op the step issues passes through it,
on any device (the dry run runs on ``meta`` tensors, which move no
data), and it counts per op, with ``hlo_cost``'s definitions:

* **flops** — matrix products ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm``
  2·|result|·|contracted| (kept apart as ``dot_flops``), convolutions
  2·|result|·(Cin/groups)·|kernel|; elementwise arithmetic |result|;
  reductions |input|; the softmax family 5 an element;
* **transcendentals** — exp, log, tanh, sin, cos, atan2, sqrt, rsqrt,
  sigmoid, erf ... (each also a flop);
* **bytes** — operands plus result of every op that materialises one
  (views and allocations move nothing; an indexed write counts twice the
  rows it writes): ``hlo_cost``'s *traffic proxy*, not a least-bytes
  bound;
* **peak live bytes** — the storages alive after each op (held through
  weak references), from which :meth:`OpCounter.memory` fills JAX's
  ``memory_analysis`` fields.

Two things do not show at the aten level, so each reports itself through
``repro_torch/cost_hook.py``, which the counter sets while it counts:

* **the kernels** (a ``ctypes`` launch on the card, shape-only outputs on
  meta): each wrapper reports its kernel's bytes and operations from
  ``kernels/work.py`` (``cost_hook.kernel_call``); on CPU tensors the plain
  version's aten ops are not counted again beneath it, so one call counts
  the same on CPU, meta and CUDA tensors;
* **the port's collectives** (``distributed/collectives.py``):
  ``cost_hook.collective`` records count and wire bytes by kind with
  JAX's factors (an all-reduce moves 2x its buffer).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import cost_hook

_DOTS = {"mm", "addmm", "bmm", "baddbmm", "addbmm", "_addmm_activation"}
_CONV = {"convolution", "_convolution", "convolution_backward"}
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "abs", "neg",
    "where", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "clamp", "clamp_min",
    "clamp_max", "floor", "ceil", "round", "trunc", "sign", "remainder",
    "fmod", "pow", "square", "reciprocal", "lerp", "addcmul", "addcdiv",
    "masked_fill", "relu", "threshold_backward", "floor_divide",
    "isfinite", "isnan", "isinf", "nan_to_num", "hardtanh",
}
_TRANSCENDENTAL = {"exp", "exp2", "log", "log2", "log1p", "expm1", "tanh",
                   "sin", "cos", "atan2", "atan", "sqrt", "rsqrt", "sigmoid",
                   "erf", "softplus", "gelu", "silu", "logit"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
           "prod", "var", "var_mean", "std", "norm", "linalg_vector_norm",
           "any", "all", "cumsum", "cumprod", "logsumexp", "topk", "sort",
           "nll_loss_forward"}
_SOFTMAX = {"_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data"}
#: writes of rows into a larger buffer: the traffic is the rows, twice
_INDEXED_WRITE = {"index_copy", "index_put", "index_add", "scatter",
                  "scatter_add", "masked_scatter", "slice_scatter",
                  "select_scatter"}
#: ops that move no data of their own, named as :func:`_name` gives them
#: (``set_`` and ``resize_`` lose their underscore there)
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "lift_fresh", "lift_fresh_copy",
               "_local_scalar_dense", "set", "resize", "detach", "alias"}


def _name(func) -> str:
    """``aten.add_.Tensor`` -> ``add`` (in-place and out forms too)."""
    n = func._schema.name.split("::")[-1]
    return n[:-1] if n.endswith("_") and not n.startswith("_") else n


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(name: str, args, out) -> float:
    """2·|result|·|contracted| of a matrix product."""
    if name in ("mm", "bmm"):
        a = args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("addmm", "baddbmm", "addbmm", "_addmm_activation"):
        a = args[1]
        return 2.0 * out.numel() * a.shape[-1]
    return 0.0


def _conv_flops(name: str, args, out) -> float:
    if name == "convolution_backward":
        grad, x, w = args[0], args[1], args[2]
        groups = args[-2] if isinstance(args[-2], int) else 1
        per = 2.0 * grad.numel() * (x.shape[1] // groups) \
            * w[0, 0].numel()
        return 2 * per          # the input and the weight gradients
    x, w = args[0], args[1]
    groups = args[-1] if isinstance(args[-1], int) else 1
    return 2.0 * out.numel() * (x.shape[1] // groups) * w[0, 0].numel()


class OpCounter(TorchDispatchMode):
    """Counts one step while active (``with OpCounter() as c:``). After
    it: ``flops``, ``dot_flops``, ``transcendentals``, ``bytes``,
    ``kernels`` {name: {"calls", "flops", "dot_flops", "bytes"}},
    ``collectives`` {kind: {"count", "bytes"}}, ``peak_bytes``; call
    :meth:`hold` on the step's arguments first so they count as live."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.ops = 0
        #: {aten op name: [calls, flops, bytes]}, to find where two counts
        #: part
        self.by_op: dict[str, list] = {}
        self.kernels: dict[str, dict] = {}
        self.collectives: dict[str, dict] = {}
        self._quiet = 0
        self._seen = WeakIdKeyDictionary()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._prev: Optional[OpCounter] = None

    # -- the hook's side ---------------------------------------------------
    def __enter__(self):
        self._prev, cost_hook.ACTIVE = cost_hook.ACTIVE, self
        return super().__enter__()

    def __exit__(self, *exc):
        cost_hook.ACTIVE = self._prev
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, name: str, work):
        """Count one kernel call's ``work`` (``kernels/work.py``); the aten
        ops beneath it (a plain version's, an output's allocation) are not
        counted."""
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "dot_flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work.flops
        k["dot_flops"] += work.dot
        k["bytes"] += work.nbytes
        self.flops += work.flops
        self.dot_flops += work.dot
        self.transcendentals += work.transcendentals
        self.bytes += work.nbytes
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def collective(self, kind: str, nbytes: int) -> None:
        c = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0})
        c["count"] += 1
        c["bytes"] += nbytes * cost_hook.COLLECTIVE_FACTOR[kind]

    # -- memory --------------------------------------------------------------
    def hold(self, *trees) -> None:
        """Track the storages of every tensor in ``trees`` (the step's
        arguments) as live."""
        for tree in trees:
            for t in _leaves(tree):
                self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live_bytes += n
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def memory(self, args, outputs) -> dict:
        """JAX's ``memory_analysis`` fields of the step that took ``args``
        and returned ``outputs``: the distinct storages of each, the
        outputs' that are arguments' (updated in place: JAX's donated
        aliases), the peak of the live bytes as ``peak_per_device`` and
        ``temp_bytes`` so that peak = argument + temp + output - alias,
        as JAX's record adds them."""
        arg = _storages(args)
        out = _storages(outputs)
        a_b = sum(arg.values())
        o_b = sum(out.values())
        alias = sum(n for k, n in out.items() if k in arg)
        peak = max(self.peak_bytes, a_b + o_b - alias)
        return {"argument_bytes": a_b, "output_bytes": o_b,
                "temp_bytes": peak - a_b - o_b + alias,
                "alias_bytes": alias, "peak_per_device": peak}

    # -- the aten ops --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            return out
        self.ops += 1
        if func.namespace == "aten":
            self._count(func, _name(func), args, out)
        for t in _tensors(out):
            self._track(t)
        for t in _tensors(args):
            self._track(t)
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
        return out

    def _count(self, func, name: str, args, out) -> None:
        res = list(_tensors(out))
        n_out = sum(t.numel() for t in res)
        flops = trans = 0.0
        if name in _DOTS:
            d = _dot_flops(name, args, res[0])
            self.dot_flops += d
            flops = d
            if name in ("addmm", "baddbmm", "addbmm"):
                flops += n_out          # the added term
        elif name in _CONV:
            d = _conv_flops(name, args, res[0])
            self.dot_flops += d
            flops = d
        elif name in _TRANSCENDENTAL or name.removesuffix("_backward") in \
                _TRANSCENDENTAL:
            flops = trans = float(n_out)
            if name.endswith("_backward"):
                flops = 2.0 * n_out
        elif name in _ELEMENTWISE:
            flops = float(n_out)
        elif name in _REDUCE:
            flops = float(sum(t.numel() for t in _tensors(args[:1])))
            if name == "logsumexp":
                trans = flops
        elif name in _SOFTMAX:
            flops = 5.0 * n_out
            trans = 0.0 if name.endswith("_data") else float(n_out)
        self.flops += flops
        self.transcendentals += trans
        nbytes = 0
        if func.is_view or name in _NO_TRAFFIC or not res:
            pass
        elif name in _INDEXED_WRITE:
            nbytes = 2 * max((_nbytes(t) for t in _tensors(args[1:])),
                             default=0)
        else:
            nbytes = sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in res)
        self.bytes += nbytes
        rec = self.by_op.setdefault(name, [0, 0.0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes

    # -- the record ----------------------------------------------------------
    def cost(self) -> dict:
        """JAX's ``cost`` keys (``bytes accessed`` is the traffic
        proxy)."""
        return {"flops": self.flops, "bytes accessed": self.bytes,
                "transcendentals": self.transcendentals}

    def census(self) -> dict:
        """JAX's ``collectives`` record: {kind: {"count", "bytes"}} and
        ``total_bytes``."""
        out = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        return out


def _leaves(tree):
    """Every tensor of a tree: tensors, dicts, lists, tuples (named too)
    and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def _storages(tree) -> dict:
    """{storage key: bytes} of the distinct storages of ``tree``'s tensors
    (a key is the storage's address on real devices, its Python object's
    identity on meta, where every address is 0; the tree keeps both
    alive while it is read)."""
    out = {}
    for t in _leaves(tree):
        st = t.untyped_storage()
        key = id(st) if t.device.type == "meta" else (t.device, st.data_ptr())
        out[key] = st.nbytes()
    return out

