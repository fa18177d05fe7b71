"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library under ``build/`` at the repository
root, at first use, and loaded with ``ctypes``. A library is rebuilt when
its source (or a header beside it) is newer than the ``.so``. Nothing
here runs at import time: this module imports on machines without a GPU
or a CUDA toolkit, and only a call to :func:`library` needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# --split-compile=0: nvcc runs its optimisation passes on as many threads
# as the machine has (flash_decode has 60 instantiations, the longest
# build; PERF.md has the build times); -Xptxas -v: each kernel's registers,
# shared memory and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0",
              "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# the compiler's output of each library built by this process: ``ptxas``'s
# registers, shared memory and spills of every kernel (``-Xptxas -v``)
LOGS: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under PyTorch's ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = _so_path(name)
    if not so.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return max(p.stat().st_mtime for p in deps) > so.stat().st_mtime


def build(names: Iterable[str]) -> float:
    """Compile every stale library in ``names``, one ``nvcc`` each, all
    started together. Returns the wall seconds spent; raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _so_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            LOGS[name] = out
            os.replace(tmp, _so_path(name))     # atomic: no half-written .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_so_path(name)))
        _LIBS[name] = lib
    return lib


def bind(name: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point ``fn`` of library ``name``, with its argument types
    declared (pointers and the stream as ``c_void_p``) and an ``int``
    result: the launch's ``cudaGetLastError()``."""
    lib = library(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return f


def check(name: str, err: int, what: str) -> None:
    """Raise if a C entry point of library ``name`` returned an error."""
    if err != 0:
        msg = library(name).cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


# dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}
# 80: zamba2-2.7b's shared attention block; 160: stablelm-12b
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
# flash_attention's (q/k head dim, v head dim) pairs: one head dim for all
# three, or MLA's 192 (nope 128 + rope 64) for q/k with 128 for v
ATTENTION_DIMS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)


def scale_arg(scale: float | None) -> float:
    """The attention launchers' score scale: ``scale``, or 0 where the
    caller gives none, which each kernel reads as 1/sqrt(D)."""
    if scale is None:
        return 0.0
    if not scale > 0:
        raise ValueError(f"attention: score scale {scale} is not above 0")
    return float(scale)


def check_operands(what: str, **tensors) -> int:
    """Validate a kernel's tensor operands: CUDA tensors on one device, of
    one dtype the kernel takes, with a contiguous last dimension and
    16-byte aligned rows (the kernels load 16 bytes at a time). Shapes,
    head dims among them, are the caller's to check. Returns the dtype
    code."""
    first = next(iter(tensors.values()))
    dtype = str(first.dtype).removeprefix("torch.")
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {first.dtype} not supported "
                        f"(float32 or bfloat16)")
    for nm, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {nm} is on {t.device}; the kernel "
                             "runs on CUDA tensors only")
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{what}: {nm} is {t.dtype} on {t.device}, "
                             f"expected {first.dtype} on {first.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {nm} needs a contiguous last dim")
        item = t.element_size()
        outer = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
        if t.data_ptr() % 16 or any((s * item) % 16 for s in outer):
            raise ValueError(f"{what}: {nm} rows are not 16-byte aligned")
    return DTYPE_CODES[dtype]
