"""int8 GEMM with an int32 accumulator and a fused scale epilogue.

Counterpart of ``pytorch_quantize_impls_tpu/kernels/int8_matmul.py``. The
serving path for prepared (decoded ±1) binary weights, through
``xnor_gemm.binary_gemm_decoded``.

``int8_gemm`` launches the hand-written CUDA kernel in
``csrc/int8_matmul.cu`` for CUDA tensors and takes its plain PyTorch version
``int8_gemm_reference`` for CPU tensors. ``int8_gemm.launches`` counts the
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from pytorch_quantize_impls_tpu_torch.kernels import _build


def _lib() -> ctypes.CDLL:
    # (x, w, alpha, row_scale, out, M, N, K, device, stream)
    return _build.library(
        "int8_matmul",
        qt_int8_gemm=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )


def epilogue(
    acc: torch.Tensor,
    alpha: Optional[torch.Tensor],
    row_scale: Optional[torch.Tensor],
) -> torch.Tensor:
    """The kernels' epilogue on an exact accumulator: f32(acc), then
    ``* alpha[n]``, then ``* row_scale[m]``."""
    out = acc.to(torch.float32)
    if alpha is not None:
        out = out * alpha.to(torch.float32).reshape(1, -1)
    if row_scale is not None:
        out = out * row_scale.to(torch.float32).reshape(-1, 1)
    return out


def int8_gemm_reference(x_i8, w_i8, alpha=None, row_scale=None):
    """Plain PyTorch version of :func:`int8_gemm`. The product accumulates in
    float64, which is exact here (|sum| <= 127 * 127 * K << 2**53) and, unlike
    integer ``matmul``, runs on the card as well as on the CPU."""
    acc = x_i8.to(torch.float64) @ w_i8.to(torch.float64)
    return epilogue(acc, alpha, row_scale)


def int8_gemm(
    x_i8: torch.Tensor,
    w_i8: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(M,K) int8 @ (K,N) int8 -> (M,N) float32, int32 accumulate.

    ``alpha``: (N,) per-out-channel f32 scale; ``row_scale``: (M,) per-row f32
    scale, both applied in the epilogue.
    """
    m, k = x_i8.shape
    k2, n = w_i8.shape
    if k != k2:
        raise ValueError(f"inner dims differ: {k} vs {k2}")
    dev = x_i8.device
    if dev.type == "cpu":
        return int8_gemm_reference(x_i8, w_i8, alpha, row_scale)
    if dev.type != "cuda":
        raise ValueError(f"int8_gemm: unsupported device {dev}")
    _build.require("x_i8", x_i8, torch.int8, (m, k), dev)
    _build.require("w_i8", w_i8, torch.int8, (k, n), dev)
    if alpha is not None:
        _build.require("alpha", alpha, torch.float32, (n,), dev)
    if row_scale is not None:
        _build.require("row_scale", row_scale, torch.float32, (m,), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.qt_int8_gemm(
        _build.ptr(x_i8), _build.ptr(w_i8), _build.ptr(alpha),
        _build.ptr(row_scale), _build.ptr(out), m, n, k, *_build.launch_args(x_i8),
    )
    _build.check(lib, code, "int8_gemm")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0
