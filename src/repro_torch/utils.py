"""Shape math and device resolution shared by the port."""
from __future__ import annotations

import dataclasses
import math

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pow2_bucket(n: int, multiple: int) -> int:
    """Smallest power-of-two multiple of ``multiple`` that is >= n."""
    b = multiple
    while b < n:
        b *= 2
    return b


def nearest_rank_pct(sorted_vals, p: float) -> float:
    """Nearest-rank percentile of pre-*sorted* values: the value at
    1-based rank ``ceil(p/100 * n)`` (clamped to [1, n]); 0.0 on empty."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    rank = min(max(math.ceil(p / 100 * n), 1), n)
    return sorted_vals[rank - 1]


def tree_bytes(tree) -> int:
    """Total bytes of every tensor in ``tree``: tensors, dataclasses (their
    fields), dicts, lists and tuples, nested; anything else counts 0."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


class NotPorted(ValueError):
    """A placement or option of the JAX package the port refuses by name
    (its message says which); the dry run records such a cell as
    refused."""


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """A leaf's shape and dtype without its values (``jax.ShapeDtypeStruct``
    for the spec resolvers and the dry run's inputs)."""
    shape: tuple
    dtype: torch.dtype


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (configs name dtypes as JAX
    does, by string)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another device. Raises when no card is present and none was
    named — the port never carries on on the CPU by itself."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
