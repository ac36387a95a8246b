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

``dorefa_gemm`` (K6) and ``decode_dorefa_weights`` (K7) launch the
hand-written CUDA kernels in ``csrc/dorefa_gemm.cu`` for CUDA tensors and
take their plain PyTorch versions (``*_reference``) for CPU tensors; each
counts its kernel launches in ``.launches``. ``dorefa_gemm_decoded`` runs
``int8_matmul.int8_gemm`` (K3) with ``alpha = 1/(n_w n_a)``: the same f32
value, so it equals ``dorefa_gemm`` bit for bit. The weight-stationary
variant ``dorefa_gemm_ws`` is not ported yet (ROADMAP).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pytorch_quantize_impls_tpu_torch.kernels import _build, int8_matmul
from pytorch_quantize_impls_tpu_torch.kernels.common import packed_rows, pad_dim
from pytorch_quantize_impls_tpu_torch.ops import pack as packlib


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.library(
        "dorefa_gemm",
        # (x, w_packed, out, M, N, K, R, bits, inv_scale, device, stream)
        qt_dorefa_gemm=[p, p, p, i, i, i, i, i, ctypes.c_float, i, p],
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


def inv_scale(w_bits: int, a_bits: int) -> float:
    """The epilogue scale ``1 / (n_w n_a)``, rounded to float32 as the JAX
    package's f32 multiply rounds it."""
    return float(np.float32(1.0 / ((2**w_bits - 1) * (2**a_bits - 1))))


def pack_dorefa_weights(wq: torch.Tensor, bits: int) -> torch.Tensor:
    """DoReFa fake-quant weights (K, N), already on the grid of
    ``ops.dorefa_weight(., bits)`` -> planar packed codes (int32 words)."""
    _check_w_bits(bits)
    return packlib.pack_bitplanes(packlib.dorefa_weight_to_codes(wq, bits), bits)


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


def dorefa_gemm_reference(a_codes, w_packed, *, w_bits: int, a_bits: int):
    """Plain PyTorch version of :func:`dorefa_gemm`: centered codes, exact
    float64 accumulation, the same f32 epilogue."""
    d = _centered(w_packed, w_bits)
    a = pad_dim(a_codes, 1, d.shape[0])
    acc = a.to(torch.float64) @ d.to(torch.float64)
    return acc.to(torch.float32) * torch.tensor(inv_scale(w_bits, a_bits), device=acc.device)


def dorefa_gemm(
    a_codes: torch.Tensor, w_packed: torch.Tensor, *, w_bits: int, a_bits: int
) -> torch.Tensor:
    """(M, K) int8 activation codes @ planar w codes -> (M, N) float32, equal
    to ``dorefa_activation(x) @ dorefa_weight(w)`` up to f32 rounding. K may
    be less than the packed K: the missing columns of x count as 0."""
    _check_w_bits(w_bits)
    m, k = a_codes.shape
    r = packed_rows(w_packed, w_bits, k)
    n = w_packed.shape[1]
    dev = a_codes.device
    if dev.type == "cpu":
        return dorefa_gemm_reference(a_codes, w_packed, w_bits=w_bits, a_bits=a_bits)
    if dev.type != "cuda":
        raise ValueError(f"dorefa_gemm: unsupported device {dev}")
    _build.require("a_codes", a_codes, torch.int8, (m, k), dev)
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.qt_dorefa_gemm(
        _build.ptr(a_codes), _build.ptr(w_packed), _build.ptr(out), m, n, k, r, w_bits,
        inv_scale(w_bits, a_bits), *_build.launch_args(a_codes),
    )
    _build.check(lib, code, "dorefa_gemm")
    dorefa_gemm.launches += 1
    return out


dorefa_gemm.launches = 0


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
    a_codes: torch.Tensor, w_i8: torch.Tensor, *, w_bits: int, a_bits: int
) -> torch.Tensor:
    """Weight-stationary serving path: centered int8 codes decoded once
    (``decode_dorefa_weights``) through ``int8_gemm`` (K3), the dequant
    ``1/(n_w n_a)`` riding its alpha epilogue; x is zero-padded to the
    weights' K. Output float32."""
    k, n = w_i8.shape
    a_codes = pad_dim(a_codes, 1, k)
    alpha = torch.full((n,), inv_scale(w_bits, a_bits), dtype=torch.float32, device=w_i8.device)
    return int8_matmul.int8_gemm(a_codes, w_i8, alpha)
