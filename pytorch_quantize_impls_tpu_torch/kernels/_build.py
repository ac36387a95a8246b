"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) at first use into ``csrc/build/``. The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. Several sources build
at once, one ``nvcc`` process each. Nothing here runs at import time: the CPU
tests import every module on a machine with no ``nvcc``.

Every C entry point takes the CUDA device index and stream last, launches on
that stream without synchronising, and returns ``cudaGetLastError()``;
:func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = (
    "xnor_gemm", "int8_matmul", "decode_attention", "dorefa_gemm", "int8_conv", "shift_gemm",
    "mxu_probe",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return str(path)


def library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every source in ``names`` that has no library for its current
    hash, all at once. Returns each compiled source's ptxas report (registers,
    shared memory, spills); raises with nvcc's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"{library_path(name).name}.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    reports, failures = {}, []
    for name, (proc, tmp) in procs.items():
        try:
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            failures.append(f"{name}: nvcc timed out after {BUILD_TIMEOUT_S} s\n{out}")
            continue
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        # rename is atomic: a concurrent loader sees no library or a whole one
        os.replace(tmp, library_path(name))
        reports[name] = out
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return reports


def library(name: str, **argtypes) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``argtypes`` maps each entry point to its argument types; every entry
    point returns a CUDA error code."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.qt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.qt_cuda_error_string.restype = ctypes.c_char_p
            for fn, types in argtypes.items():
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    if code != 0:
        msg = lib.qt_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code}: {msg}")


def ptr(t) -> ctypes.c_void_p:
    """Device address of a tensor, or NULL for ``None``."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch_args(t: torch.Tensor):
    """(device index, stream) of the CUDA tensor ``t``: the current stream."""
    stream = torch.cuda.current_stream(t.device).cuda_stream
    return ctypes.c_int(t.device.index), ctypes.c_void_p(stream)


def require(name: str, t, dtype: torch.dtype, shape, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what a kernel reads through a raw pointer)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
