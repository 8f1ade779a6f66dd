"""Build the hand-written CUDA kernels at first use and bind them through
ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, in ``kernels/_build/`` (listed
in ``.gitignore``), keyed by a hash of the sources and flags. No PyTorch
headers are involved, so a build takes seconds; :func:`build` starts one
``nvcc`` per missing library, all at once. Nothing here runs at import
time: the CPU-only test environment imports every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
KERNELS = ("polar_encode", "paged_decode", "flash_prefill", "paged_prefill",
           "polar_attention", "polar_qk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries of this process, by kernel name
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (PATH, then $CUDA_HOME, then the default
    toolkit location)."""
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's kernels build with the "
                       "CUDA toolkit on the machine with the card")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, dict]:
    """Compile every missing library among ``names`` in parallel (one
    ``nvcc`` each). Returns ``{name: {"seconds", "log", "cached"}}``;
    ``log`` holds ptxas' register and shared-memory report. Raises with
    the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    procs = {}
    t0 = time.monotonic()
    for name in names:
        path = lib_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, path)
        out[name] = {"seconds": time.monotonic() - t0, "log": log,
                     "cached": False}
    return out


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use);
    ``bind`` declares its functions' argtypes once, on load."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _LIBS[name] = lib
    return lib


def route(*tensors: torch.Tensor) -> str:
    """Where a wrapper's call goes: ``"cuda"`` for CUDA tensors (launch
    the kernel), ``"cpu"`` for CPU tensors (run the plain version),
    ``"meta"`` for meta tensors (outputs of the kernel's shapes, dtypes
    and aliasing, no values: the dry run's placeholders). Mixed or other
    devices raise."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) == 1 and next(iter(kinds)) in ("cuda", "cpu", "meta"):
        return next(iter(kinds))
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels take CUDA "
                     "tensors, their plain versions CPU tensors and their "
                     "shape-only forms meta tensors, each alone")


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error (launch refused, bad
    configuration)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


#: the C entries' value-row kinds
VALUE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}


def value_rows(values: torch.Tensor, vscale, vzero,
               shape: tuple) -> tuple[int, int | None, int | None]:
    """Check the value rows a decode or prefill kernel reads: fp32 or bf16
    rows of ``shape``, or uint8 mid-tread codes of ``shape`` (last dim a
    multiple of 16) with float32 ``vscale`` / ``vzero`` of ``shape[:-1] +
    (1,)``, all contiguous. Returns (kind for the C entry, vscale and
    vzero pointers or None)."""
    require(values.dtype in VALUE_KINDS and values.is_contiguous()
            and tuple(values.shape) == tuple(shape),
            f"values must be contiguous fp32, bf16 or uint8 {tuple(shape)}")
    kind = VALUE_KINDS[values.dtype]
    require((kind == 2) == (vscale is not None) == (vzero is not None),
            "uint8 values need vscale and vzero; fp values take neither")
    if kind != 2:
        return kind, None, None
    require(shape[-1] % 16 == 0, "uint8 value rows need head_dim % 16 == 0")
    for x in (vscale, vzero):
        require(x.dtype == torch.float32 and x.is_contiguous()
                and tuple(x.shape) == (*shape[:-1], 1),
                f"vscale/vzero must be contiguous float32 "
                f"{(*shape[:-1], 1)} (other scale dtypes have no kernel)")
    return kind, vscale.data_ptr(), vzero.data_ptr()


# argtypes shorthands: pointers and the stream MUST be c_void_p, or ctypes
# passes them as 32-bit ints and cuts them
VOIDP = ctypes.c_void_p
INT = ctypes.c_int
LLONG = ctypes.c_longlong
FLOAT = ctypes.c_float
