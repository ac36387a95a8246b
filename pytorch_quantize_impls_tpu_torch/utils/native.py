"""Native host codec: ctypes bindings for ``csrc/qtpu_pack.cpp``.

Counterpart of ``pytorch_quantize_impls_tpu/utils/native.py``, for what
the port calls: the export path (:mod:`infer.host_export`) packs a training
checkpoint into the serving artifact on a host with no accelerator, and
this threaded C++ codec writes its planar words. It is a host-side speed
path, not a device kernel: :func:`pack_bitplanes` writes the words of
``ops.pack.pack_bitplanes``, and without a C++ toolchain, or with
``$QTPU_NO_NATIVE`` set, its numpy fallback writes the same words and
:func:`available` returns False. The source's lane codec and unpackers
have no caller in the port and are not bound.

The port builds its own copy of the source (``csrc/qtpu_pack.cpp`` of this
package) with g++ on first use into ``csrc/build/``. The library's name
carries a digest of the source, the flags and the host's CPU (the build
uses ``-march=native``), so an edited source is rebuilt and a library built
for another CPU is never loaded; it is written to a temporary file and
renamed, so processes that build at once each load a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SRC = _CSRC / "qtpu_pack.cpp"
_BUILD = _CSRC / "build"
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

GROUP_ROWS = 32
SUPPORTED_BITS = (1, 2, 4, 8)


def _cpu() -> str:
    """The host's CPU model and feature flags, which ``-march=native``
    compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
    except OSError:
        lines = []
    return platform.machine() + "".join(sorted(set(lines)))


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    digest.update(_cpu().encode())
    return _BUILD / f"libqtpu_pack-{digest.hexdigest()[:16]}.so"


def _compile(so: Path) -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return False
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        sys.stderr.write(f"qtpu native build failed:\n{r.stderr.decode(errors='replace')}\n")
        return False
    os.replace(tmp, so)  # atomic: a concurrent loader sees no library or a whole one
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("QTPU_NO_NATIVE"):
            return None
        so = library_path()
        if not so.exists() and not _compile(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.qtpu_pack_planar.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        lib.qtpu_pack_planar.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """True when the compiled codec is loadable (builds it on first call)."""
    return _load() is not None


def _check_bits(bits: int) -> None:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---- grouped-planar layout (ops.pack.pack_bitplanes) ------------------------


def planar_group_k(bits: int) -> int:
    return (32 // bits) * GROUP_ROWS


def _planar_out_rows(k: int, bits: int) -> int:
    return -(-k // planar_group_k(bits)) * GROUP_ROWS


def pack_bitplanes(codes: np.ndarray, bits: int) -> np.ndarray:
    """Unsigned codes [..., K, N] -> planar uint32 words [..., ceil(K /
    planar_group_k) * 32, N], K zero-padded."""
    _check_bits(bits)
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    if codes.ndim < 2:
        raise ValueError("planar packing needs >= 2 dims")
    *lead, k, n = codes.shape
    if lib is None:
        return _pack_bitplanes_np(codes, bits)
    c3 = codes.reshape(-1, k, n)
    out = np.empty((c3.shape[0], _planar_out_rows(k, bits), n), np.uint32)
    for b in range(c3.shape[0]):
        cb = np.ascontiguousarray(c3[b])
        ob = out[b]
        lib.qtpu_pack_planar(_ptr(cb, ctypes.c_int32), _ptr(ob, ctypes.c_uint32), k, n, bits)
    return out.reshape(*lead, out.shape[1], n)


# ---- numpy fallback -----------------------------------------------------------


def _pack_bitplanes_np(codes: np.ndarray, bits: int) -> np.ndarray:
    f = 32 // bits
    gk = planar_group_k(bits)
    *lead, k, n = codes.shape
    kp = -(-k // gk) * gk
    if kp != k:
        codes = np.pad(codes, [(0, 0)] * (codes.ndim - 2) + [(0, kp - k), (0, 0)])
    c = codes.astype(np.uint32)
    rows = []
    for g in range(kp // gk):
        word = np.zeros((*lead, GROUP_ROWS, n), np.uint32)
        base = g * gk
        for i in range(f):
            word |= (c[..., base + i * GROUP_ROWS:base + (i + 1) * GROUP_ROWS, :]
                     << np.uint32(bits * i))
        rows.append(word)
    return np.concatenate(rows, axis=-2)
