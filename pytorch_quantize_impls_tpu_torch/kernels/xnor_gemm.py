"""1-bit packed weights: binary GEMM, one-pass decode, and the decoded GEMM.

Counterpart of ``pytorch_quantize_impls_tpu/kernels/xnor_gemm.py``. Weights
are stored grouped-planar (``ops.pack.pack_bitplanes``, 1 bit each, K padded
to the 1024-row group); activations are ±1 int8 (0 in padding).

``binary_gemm`` (K1), its weight-stationary variant ``binary_gemm_ws``
(K10) and ``decode_binary_weights`` (K2) launch the hand-written CUDA
kernels in ``csrc/xnor_gemm.cu`` for CUDA tensors and take their plain
PyTorch versions (``*_reference``) for CPU tensors. Each counts its kernel
launches in ``.launches``. K1 runs on the streamed int8 tensor-core schedule
(``csrc/stream_tile.cuh``, plan ``common.stream_plan``), K10 on the s8 path
of the Hopper ``wgmma`` tile (``csrc/packed_ws.cuh`` on ``csrc/wgmma_tile.cuh``,
``common.binary_ws_plan``).
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional

import torch

from pytorch_quantize_impls_tpu_torch.kernels import _build, int8_matmul
from pytorch_quantize_impls_tpu_torch.kernels.common import (
    int8_rows, pad_dim, stream_plan, stream_workspace_bytes, ws_m_tiles,
)
from pytorch_quantize_impls_tpu_torch.ops import pack as packlib

STAGE_K = 64  # k per shared-memory stage of binary_gemm: 64 int8 activations
# csrc/xnor_gemm.cu BinaryGemmArgs: (x, w_packed, alpha, row_scale, out,
# workspace, stream) addresses, then (M, N, K, R, bm, splits, chunk, device)
_GEMM_ARGS = struct.Struct("=7Q8i")


@functools.lru_cache(maxsize=None)  # the argtypes lists are built once
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.library(
        "xnor_gemm",
        # one packed BinaryGemmArgs (_GEMM_ARGS)
        qt_binary_gemm=[ctypes.c_char_p],
        # (x, w_packed, alpha, row_scale, out, M, N, K, pitch, R, m_tiles, device, stream)
        qt_binary_gemm_ws=[p] * 5 + [i] * 7 + [p],
        # (w_packed, out, R, N, device, stream)
        qt_decode_binary=[p, p, i, i, i, p],
    )


def binary_weight_codes(w: torch.Tensor) -> torch.Tensor:
    """±1-ish float weights -> int32 codes: 1 where ``w >= 0``
    (``ops.safe_sign``), else 0."""
    return (w >= 0).to(torch.int32)


def pack_binary_weights(w: torch.Tensor) -> torch.Tensor:
    """±1-ish float weights (K, N) -> planar 1-bit words (ceil(K/1024)*32, N)
    of :func:`binary_weight_codes`. K is zero-padded; padded rows decode to
    -1 but meet zero-padded activations.
    """
    return packlib.pack_bitplanes(binary_weight_codes(w), 1)


def binarize_to_int8(x: torch.Tensor) -> torch.Tensor:
    """Float activations -> ±1 int8 (the BNN activation binarization)."""
    return torch.where(x >= 0, 1, -1).to(torch.int8)


def _packed_rows(w_packed: torch.Tensor, k: int = 0) -> int:
    """Rows of a packed weight; raise unless they are whole 32-word groups
    covering K = ``k``."""
    r = w_packed.shape[0]
    if r % packlib.GROUP_ROWS or k > r * 32:
        raise ValueError(
            f"packed weight has {r} rows (K <= {r * 32}), x has K = {k}"
        )
    return r


def binary_gemm_reference(x_i8, w_packed, alpha=None, row_scale=None):
    """Plain PyTorch version of :func:`binary_gemm`: unpack to ±1, zero-pad
    x to the packed K, accumulate exactly in float64, same epilogue."""
    r = w_packed.shape[0]
    w = 2 * packlib.unpack_bitplanes(w_packed, 1, r * 32) - 1
    x = pad_dim(x_i8, 1, r * 32)
    return int8_matmul.int8_gemm_reference(x, w, alpha, row_scale)


def binary_gemm(
    x_i8: torch.Tensor,
    w_packed: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(M,K) int8 ±1 @ planar-1-bit (Kp/32,N) -> (M,N) float32.

    ``alpha``: (N,) per-out-channel scale; ``row_scale``: (M,) per-row scale.
    K may be less than the packed Kp: the missing columns of x count as 0.
    On the card K may be split (``common.stream_plan``); the int32 sum is
    exact, so the result is the same whatever the split.
    """
    m, k = x_i8.shape
    r = _packed_rows(w_packed, k)
    n = w_packed.shape[1]
    dev = x_i8.device
    if dev.type == "cpu":
        return binary_gemm_reference(x_i8, w_packed, alpha, row_scale)
    if dev.type != "cuda":
        raise ValueError(f"binary_gemm: unsupported device {dev}")
    _build.require("x_i8", x_i8, torch.int8, (m, k), dev)
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    if alpha is not None:
        _build.require("alpha", alpha, torch.float32, (n,), dev)
    if row_scale is not None:
        _build.require("row_scale", row_scale, torch.float32, (m,), dev)
    bm, splits, chunk = stream_plan(m, n, k, STAGE_K)
    index, stream = _build.launch_args(x_i8)
    ws = _build.scratch(stream_workspace_bytes(m, n, splits), index, stream) if splits > 1 else 0
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.qt_binary_gemm(_GEMM_ARGS.pack(
        x_i8.data_ptr(), w_packed.data_ptr(), 0 if alpha is None else alpha.data_ptr(),
        0 if row_scale is None else row_scale.data_ptr(), out.data_ptr(), ws, stream,
        m, n, k, r, bm, splits, chunk, index,
    ))
    _build.check(lib, code, "binary_gemm")
    binary_gemm.launches += 1
    return out


binary_gemm.launches = 0


def binary_gemm_ws_reference(x_i8, w_packed, alpha=None, row_scale=None):
    """Plain PyTorch version of :func:`binary_gemm_ws`: the function is
    :func:`binary_gemm`'s, so is its plain version."""
    return binary_gemm_reference(x_i8, w_packed, alpha, row_scale)


def binary_gemm_ws(
    x_i8: torch.Tensor,
    w_packed: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
    *,
    m_tiles: Optional[int] = None,
) -> torch.Tensor:
    """:func:`binary_gemm`'s contract, weight-stationary: each packed weight
    tile is unpacked once for ``m_tiles`` M-tiles of 64 rows (one of
    ``common.WS_M_TILES``; the JAX function's ``tiles=``) and the product
    runs on the int8 tensor cores (wgmma). Output float32, equal to
    :func:`binary_gemm` bit for bit. On the card x is read by TMA from rows
    of a multiple of 16 bytes (``common.int8_rows``); the kernel reads
    columns past K as zero."""
    r_tiles = ws_m_tiles(m_tiles, "binary_gemm_ws")
    m, k = x_i8.shape
    r = _packed_rows(w_packed, k)
    n = w_packed.shape[1]
    dev = x_i8.device
    if dev.type == "cpu":
        return binary_gemm_ws_reference(x_i8, w_packed, alpha, row_scale)
    if dev.type != "cuda":
        raise ValueError(f"binary_gemm_ws: unsupported device {dev}")
    _build.require("x_i8", x_i8, torch.int8, (m, k), dev)
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    if alpha is not None:
        _build.require("alpha", alpha, torch.float32, (n,), dev)
    if row_scale is not None:
        _build.require("row_scale", row_scale, torch.float32, (m,), dev)
    xq = int8_rows(x_i8)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.qt_binary_gemm_ws(
        _build.ptr(xq), _build.ptr(w_packed), _build.ptr(alpha),
        _build.ptr(row_scale), _build.ptr(out), m, n, k, xq.shape[1], r, r_tiles,
        *_build.launch_args(x_i8),
    )
    _build.check(lib, code, "binary_gemm_ws")
    binary_gemm_ws.launches += 1
    return out


binary_gemm_ws.launches = 0


def decode_binary_weights_reference(w_packed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_binary_weights`."""
    r = w_packed.shape[0]
    return (2 * packlib.unpack_bitplanes(w_packed, 1, r * 32) - 1).to(torch.int8)


def decode_binary_weights(w_packed: torch.Tensor) -> torch.Tensor:
    """Planar 1-bit (Kp/32, N) -> ±1 int8 (Kp, N): the one-pass decode.

    Every packed row decodes (K = 32 * rows); callers slice their true K.
    """
    r = _packed_rows(w_packed)
    n = w_packed.shape[1]
    dev = w_packed.device
    if dev.type == "cpu":
        return decode_binary_weights_reference(w_packed)
    if dev.type != "cuda":
        raise ValueError(f"decode_binary_weights: unsupported device {dev}")
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    out = torch.empty((r * 32, n), dtype=torch.int8, device=dev)
    lib = _lib()
    code = lib.qt_decode_binary(
        _build.ptr(w_packed), _build.ptr(out), r, n, *_build.launch_args(w_packed)
    )
    _build.check(lib, code, "decode_binary_weights")
    decode_binary_weights.launches += 1
    return out


decode_binary_weights.launches = 0


def binary_gemm_decoded(
    x_i8: torch.Tensor,
    w_i8: torch.Tensor,
    alpha: Optional[torch.Tensor] = None,
    row_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weight-stationary serving path: ±1 int8 weights decoded once
    (``decode_binary_weights``) through :func:`int8_matmul.int8_gemm`; x is
    zero-padded to the weights' K. Output float32."""
    x_i8 = pad_dim(x_i8, 1, w_i8.shape[0])
    return int8_matmul.int8_gemm(x_i8, w_i8, alpha, row_scale)
