"""DoReFa k-bit packed weights: the code GEMM, one-pass decode, and the
decoded GEMM.

Counterpart of ``pytorch_quantize_impls_tpu/kernels/packed_matmul.py``.
DoReFa weights lie on the grid ``(2 c_w - n_w) / n_w`` (codes ``c_w`` in
``[0, n_w]``, ``n_w = 2^w_bits - 1``) and activations on ``c_a / n_a``. With
the weights decoded to centered integers ``d = 2 c_w - n_w`` (odd, within
±15 for w_bits <= 4) the product is one integer GEMM and a scalar epilogue:

    y = (c_a . d) * f32(1 / (n_w n_a))

exact up to that one f32 rounding. Weight codes are planar-packed
(``ops.pack.pack_bitplanes``); activation codes are int8 (a_bits <= 7).

One-bit weights are ``E|W| sign(W)`` (eq. 8), not the grid ``+-1``: the
codes keep the sign only, so their scale ``alpha = E|W|`` rides the same
epilogue, ``y = (c_a . d) * f32(f32(1 / (n_w n_a)) * alpha)``
(:func:`epilogue_scale`; as a vector, ``inv * alpha`` on the device, the
same float32 product). The GEMMs take it as ``alpha``; without it they
compute the grid's product.

``dorefa_gemm`` (K6), its weight-stationary variant ``dorefa_gemm_ws``
(K11) and ``decode_dorefa_weights`` (K7) launch the hand-written CUDA
kernels in ``csrc/dorefa_gemm.cu`` for CUDA tensors and take their plain
PyTorch versions (``*_reference``) for CPU tensors; each counts its kernel
launches in ``.launches``. ``dorefa_gemm_decoded`` runs
``int8_matmul.int8_gemm`` (K3) with the epilogue scale as its alpha vector:
the same f32 value, so it equals ``dorefa_gemm`` and ``dorefa_gemm_ws`` bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional

import numpy as np
import torch

from pytorch_quantize_impls_tpu_torch.kernels import _build, int8_matmul
from pytorch_quantize_impls_tpu_torch.kernels.common import (
    int8_rows, packed_rows, pad_dim, stream_plan, stream_workspace_bytes, ws_m_tiles,
)
from pytorch_quantize_impls_tpu_torch.ops import pack as packlib

STAGE_K = 64  # k per shared-memory stage of dorefa_gemm: 64 int8 codes
# csrc/dorefa_gemm.cu DorefaGemmArgs: (x, w_packed, out, workspace, stream)
# addresses, then (M, N, K, R, bits), inv_scale, (bm, splits, chunk, device)
_GEMM_ARGS = struct.Struct("=5Q5if4i")


@functools.lru_cache(maxsize=None)  # the argtypes lists are built once
def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.library(
        "dorefa_gemm",
        # one packed DorefaGemmArgs (_GEMM_ARGS)
        qt_dorefa_gemm=[ctypes.c_char_p],
        # (x, w_packed, out, M, N, K, pitch, R, bits, inv_scale, m_tiles, device, stream)
        qt_dorefa_gemm_ws=[p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, p],
        # (w_packed, out, R, N, bits, device, stream)
        qt_decode_dorefa=[p, p, i, i, i, i, p],
    )


def _check_w_bits(bits: int) -> None:
    if bits >= 8:
        raise ValueError(
            f"w_bits={bits}: centered codes 2c-n_w span ±{2**bits - 1}, which "
            "overflows an int8 operand; use the float fake-quant path for "
            ">=8-bit weights"
        )


@functools.lru_cache(maxsize=None)
def inv_scale(w_bits: int, a_bits: int) -> float:
    """The epilogue scale ``1 / (n_w n_a)``, rounded to float32 as the JAX
    package's f32 multiply rounds it."""
    return float(np.float32(1.0 / ((2**w_bits - 1) * (2**a_bits - 1))))


def epilogue_scale(w_bits: int, a_bits: int, alpha: Optional[float] = None) -> float:
    """K6's scalar epilogue: :func:`inv_scale`, times the one-bit weights'
    ``alpha`` (a host float) in float32 where given."""
    inv = inv_scale(w_bits, a_bits)
    return inv if alpha is None else float(np.float32(inv) * np.float32(alpha))


def epilogue_vector(w_bits: int, a_bits: int, n: int, alpha: Optional[torch.Tensor],
                    device) -> torch.Tensor:
    """The epilogue scale as an (n,) float32 vector on ``device``: ``inv *
    alpha`` (alpha of shape (n,), on the device) or ``inv``; the products
    are :func:`epilogue_scale`'s bit for bit."""
    inv = torch.full((n,), inv_scale(w_bits, a_bits), dtype=torch.float32, device=device)
    return inv if alpha is None else inv * alpha.to(torch.float32)


def dorefa_weight_codes(wq: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa fake-quant weights (K, N), already on the grid of
    ``ops.dorefa_weight(., bits)`` -> their int32 codes, packed at ``bits``."""
    _check_w_bits(bits)
    return packlib.dorefa_weight_to_codes(wq, bits)


def pack_dorefa_weights(wq: torch.Tensor, bits: int) -> torch.Tensor:
    """:func:`dorefa_weight_codes` -> planar packed codes (int32 words)."""
    return packlib.pack_bitplanes(dorefa_weight_codes(wq, bits), bits)


def dorefa_act_to_int8(aq: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa fake-quant activations ([0, 1] grid) -> int8 codes; ``bits``
    <= 7 so that the codes fit a signed int8."""
    if bits > 7:
        raise ValueError(
            f"a_bits={bits} overflows int8 activation codes (max 7); use the "
            "float fake-quant path for 8-bit activations"
        )
    return packlib.dorefa_act_to_codes(aq, bits).to(torch.int8)


def _centered(w_packed: torch.Tensor, w_bits: int) -> torch.Tensor:
    r = w_packed.shape[0]
    c = packlib.unpack_bitplanes(w_packed, w_bits, r * packlib.pack_factor(w_bits))
    return 2 * c - (2**w_bits - 1)


def dorefa_gemm_reference(a_codes, w_packed, *, w_bits: int, a_bits: int,
                          alpha: Optional[float] = None):
    """Plain PyTorch version of :func:`dorefa_gemm`: centered codes, exact
    float64 accumulation, the same f32 epilogue."""
    d = _centered(w_packed, w_bits)
    a = pad_dim(a_codes, 1, d.shape[0])
    acc = a.to(torch.float64) @ d.to(torch.float64)
    scale = epilogue_scale(w_bits, a_bits, alpha)
    return acc.to(torch.float32) * torch.tensor(scale, device=acc.device)


def dorefa_gemm(
    a_codes: torch.Tensor, w_packed: torch.Tensor, *, w_bits: int, a_bits: int,
    alpha: Optional[float] = None,
) -> torch.Tensor:
    """(M, K) int8 activation codes @ planar w codes -> (M, N) float32, equal
    to ``dorefa_activation(x) @ dorefa_weight(w)`` up to f32 rounding, where a
    one-bit weight's ``alpha = E|W|`` (a host float) is given; without it,
    the product with the grid. K may be less than the packed K: the missing
    columns of x count as 0. On the card K may be split
    (``common.stream_plan``); the int32 sum is exact, so the result is the
    same whatever the split."""
    _check_w_bits(w_bits)
    m, k = a_codes.shape
    r = packed_rows(w_packed, w_bits, k)
    n = w_packed.shape[1]
    dev = a_codes.device
    if dev.type == "cpu":
        return dorefa_gemm_reference(a_codes, w_packed, w_bits=w_bits, a_bits=a_bits,
                                     alpha=alpha)
    if dev.type != "cuda":
        raise ValueError(f"dorefa_gemm: unsupported device {dev}")
    _build.require("a_codes", a_codes, torch.int8, (m, k), dev)
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    out = _launch_dorefa_gemm(a_codes, w_packed, w_bits, epilogue_scale(w_bits, a_bits, alpha),
                              stream_plan(m, n, k, STAGE_K))
    dorefa_gemm.launches += 1
    return out


dorefa_gemm.launches = 0


def _launch_dorefa_gemm(a_codes, w_packed, w_bits: int, scale: float, plan) -> torch.Tensor:
    """dorefa_gemm's launch on checked CUDA tensors under the launch plan
    (BM, splits, chunk); ``bench/stream_sweep.py`` times other plans
    through it."""
    (m, k), (r, n) = a_codes.shape, w_packed.shape
    bm, splits, chunk = plan
    index, stream = _build.launch_args(a_codes)
    ws = _build.scratch(stream_workspace_bytes(m, n, splits), index, stream) if splits > 1 else 0
    out = torch.empty((m, n), dtype=torch.float32, device=a_codes.device)
    lib = _lib()
    code = lib.qt_dorefa_gemm(_GEMM_ARGS.pack(
        a_codes.data_ptr(), w_packed.data_ptr(), out.data_ptr(), ws, stream, m, n, k, r, w_bits,
        scale, bm, splits, chunk, index,
    ))
    _build.check(lib, code, "dorefa_gemm")
    return out


def dorefa_gemm_ws_reference(a_codes, w_packed, *, w_bits: int, a_bits: int):
    """Plain PyTorch version of :func:`dorefa_gemm_ws`: the function is
    :func:`dorefa_gemm`'s, so is its plain version."""
    return dorefa_gemm_reference(a_codes, w_packed, w_bits=w_bits, a_bits=a_bits)


def dorefa_gemm_ws(
    a_codes: torch.Tensor, w_packed: torch.Tensor, *, w_bits: int, a_bits: int,
    m_tiles=None,
) -> torch.Tensor:
    """:func:`dorefa_gemm`'s contract, weight-stationary: each packed weight
    tile is decoded once for ``m_tiles`` M-tiles of 64 rows (one of
    ``common.WS_M_TILES``) and the product runs on the int8 tensor cores
    (wgmma, ``csrc/packed_ws.cuh``, ``common.packed_ws_plan``). Output
    float32, equal to :func:`dorefa_gemm` bit for bit. On the card x is read
    by TMA from rows of a multiple of 16 bytes (``common.int8_rows``); the
    kernel reads columns past K as zero."""
    _check_w_bits(w_bits)
    r_tiles = ws_m_tiles(m_tiles, "dorefa_gemm_ws")
    m, k = a_codes.shape
    r = packed_rows(w_packed, w_bits, k)
    n = w_packed.shape[1]
    dev = a_codes.device
    if dev.type == "cpu":
        return dorefa_gemm_ws_reference(a_codes, w_packed, w_bits=w_bits, a_bits=a_bits)
    if dev.type != "cuda":
        raise ValueError(f"dorefa_gemm_ws: unsupported device {dev}")
    _build.require("a_codes", a_codes, torch.int8, (m, k), dev)
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    xq = int8_rows(a_codes)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.qt_dorefa_gemm_ws(
        _build.ptr(xq), _build.ptr(w_packed), _build.ptr(out), m, n, k, xq.shape[1], r,
        w_bits, inv_scale(w_bits, a_bits), r_tiles, *_build.launch_args(a_codes),
    )
    _build.check(lib, code, "dorefa_gemm_ws")
    dorefa_gemm_ws.launches += 1
    return out


dorefa_gemm_ws.launches = 0


def decode_dorefa_weights_reference(w_packed: torch.Tensor, *, w_bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_dorefa_weights`."""
    return _centered(w_packed, w_bits).to(torch.int8)


def decode_dorefa_weights(w_packed: torch.Tensor, *, w_bits: int) -> torch.Tensor:
    """Planar packed codes (Kp/f, N) -> centered int8 codes ``2c - n_w``
    (Kp, N): the one-pass decode. Every packed row decodes; callers slice
    their true K."""
    _check_w_bits(w_bits)
    r = packed_rows(w_packed, w_bits)
    n = w_packed.shape[1]
    dev = w_packed.device
    if dev.type == "cpu":
        return decode_dorefa_weights_reference(w_packed, w_bits=w_bits)
    if dev.type != "cuda":
        raise ValueError(f"decode_dorefa_weights: unsupported device {dev}")
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    out = torch.empty((r * packlib.pack_factor(w_bits), n), dtype=torch.int8, device=dev)
    lib = _lib()
    code = lib.qt_decode_dorefa(
        _build.ptr(w_packed), _build.ptr(out), r, n, w_bits, *_build.launch_args(w_packed)
    )
    _build.check(lib, code, "decode_dorefa_weights")
    decode_dorefa_weights.launches += 1
    return out


decode_dorefa_weights.launches = 0


def dorefa_gemm_decoded(
    a_codes: torch.Tensor, w_i8: torch.Tensor, *, w_bits: int, a_bits: int,
    alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weight-stationary serving path: centered int8 codes decoded once
    (``decode_dorefa_weights``) through ``int8_gemm`` (K3), the dequant
    ``1/(n_w n_a)``, times a one-bit weight's ``alpha`` ((N,) on the device)
    where given, riding its alpha epilogue; x is zero-padded to the weights'
    K. Output float32."""
    k, n = w_i8.shape
    a_codes = pad_dim(a_codes, 1, k)
    return int8_matmul.int8_gemm(a_codes, w_i8,
                                 epilogue_vector(w_bits, a_bits, n, alpha, w_i8.device))
