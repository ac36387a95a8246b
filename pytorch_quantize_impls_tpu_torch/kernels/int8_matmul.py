"""int8 GEMM with an int32 accumulator and a fused scale epilogue.

Counterpart of ``pytorch_quantize_impls_tpu/kernels/int8_matmul.py``. The
serving path for prepared (decoded ±1) binary weights, through
``xnor_gemm.binary_gemm_decoded``, and for decoded DoReFa codes.

``int8_gemm`` launches the hand-written CUDA kernel in
``csrc/int8_matmul.cu`` (int8 tensor cores on the streamed schedule of
``csrc/stream_tile.cuh``, launch plan ``common.stream_plan``) for CUDA
tensors and takes its plain PyTorch version ``int8_gemm_reference`` for CPU
tensors. ``int8_gemm.launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional

import torch

from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.kernels.common import stream_plan, stream_workspace_bytes

STAGE_K = 64  # k per shared-memory stage: 64 int8 values
# csrc/int8_matmul.cu Int8GemmArgs: (x, w, alpha, row_scale, out, workspace,
# stream) addresses, then (M, N, K, bm, splits, chunk, device)
_GEMM_ARGS = struct.Struct("=7Q7i")


@functools.lru_cache(maxsize=None)  # the argtypes list is built once
def _lib() -> ctypes.CDLL:
    # one packed Int8GemmArgs (_GEMM_ARGS)
    return _build.library("int8_matmul", qt_int8_gemm=[ctypes.c_char_p])


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
    scale, both applied in the epilogue, to the whole int32 sum. On the card
    K may be split (``common.stream_plan``); the int32 sum is exact, so the
    result is the same whatever the split.
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
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=dev)
    out = _launch_int8_gemm(x_i8, w_i8, alpha, row_scale, stream_plan(m, n, k, STAGE_K))
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def _launch_int8_gemm(x_i8, w_i8, alpha, row_scale, plan) -> torch.Tensor:
    """int8_gemm's launch on checked CUDA tensors under the launch plan (BM,
    splits, chunk)."""
    (m, k), n = x_i8.shape, w_i8.shape[1]
    bm, splits, chunk = plan
    index, stream = _build.launch_args(x_i8)
    ws = _build.scratch(stream_workspace_bytes(m, n, splits), index, stream) if splits > 1 else 0
    out = torch.empty((m, n), dtype=torch.float32, device=x_i8.device)
    lib = _lib()
    code = lib.qt_int8_gemm(_GEMM_ARGS.pack(
        x_i8.data_ptr(), w_i8.data_ptr(), 0 if alpha is None else alpha.data_ptr(),
        0 if row_scale is None else row_scale.data_ptr(), out.data_ptr(), ws, stream, m, n, k,
        bm, splits, chunk, index,
    ))
    _build.check(lib, code, "int8_gemm")
    return out
