"""Log-quant (power-of-2) packed weights: the shift GEMM, one-pass decode,
and the decoded GEMM.

Counterpart of ``pytorch_quantize_impls_tpu/kernels/shift_matmul.py``.
Log-quantized weights are ``±2^e`` (``ops.log_quant``); their packed form is
the 8-bit (sign, exponent index) code of ``ops.pack.log_to_codes``, 4 codes
per 32-bit word, grouped-planar. A code assembles the bf16 bit pattern of its
weight directly,

    bf16(±2^e) = neg << 15 | (e + 127) << 7        (mantissa 0, exact)

with ``e = idx + lo`` and ``lo = int(fsr) - 2^bits``, the kernels' integer
level (``ops.log_quant`` takes the float ``fsr - 2^bits``; the two agree for
an integer ``fsr``). Code 0 is ``-2^lo``, not 0: K-padding rows decode to
that level and cancel only against zero activations.

``shift_gemm`` (K8) and ``decode_log_weights`` (K9) launch the hand-written
CUDA kernels in ``csrc/shift_gemm.cu`` for CUDA tensors and take their plain
PyTorch versions (``*_reference``) for CPU tensors; each counts its kernel
launches in ``.launches``. ``shift_gemm_decoded`` is the JAX package's plain
matmul of bf16 x with pre-decoded bf16 weights: here a float32 matmul of the
same values (bf16 products are exact in float32). The
weight-stationary variant ``shift_gemm_ws`` is not ported yet (ROADMAP).
"""

from __future__ import annotations

import ctypes

import torch

from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.kernels.common import packed_rows, pad_dim
from pytorch_quantize_impls_tpu_torch.ops import log_lin
from pytorch_quantize_impls_tpu_torch.ops import pack as packlib

CODE_BITS = 8  # sign + (bits+1)-bit exponent index; bits <= 6


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.library(
        "shift_gemm",
        # (x, w_packed, out, M, N, K, R, bits, lo, device, stream)
        qt_shift_gemm=[p, p, p, i, i, i, i, i, i, i, p],
        # (w_packed, out, R, N, bits, lo, device, stream)
        qt_decode_log=[p, p, i, i, i, i, i, p],
    )


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= CODE_BITS - 2:
        raise ValueError(
            f"bits={bits}: a log code holds a sign and a (bits+1)-bit exponent "
            f"index in {CODE_BITS} bits, so 1 <= bits <= {CODE_BITS - 2}"
        )


def _lo(fsr: float, bits: int) -> int:
    """The kernels' lowest exponent, ``int(fsr) - 2^bits``."""
    return int(fsr) - 2**bits


def pack_log_weights(w: torch.Tensor, fsr: float, bits: int) -> torch.Tensor:
    """Float weights (K, N) -> planar 8-bit (sign, exponent index) codes
    (int32 words, (ceil(K/128)*32, N))."""
    _check_bits(bits)
    sign, idx = log_lin.log_quant_exponent(w, fsr, bits)
    return packlib.pack_bitplanes(packlib.log_to_codes(sign, idx, bits), CODE_BITS)


def decode_log_weights_reference(w_packed: torch.Tensor, *, fsr: float, bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_log_weights`: the bf16 bit
    pattern assembled from each code, as the kernel does."""
    codes = packlib.unpack_bitplanes(w_packed, CODE_BITS, 4 * w_packed.shape[0])
    sign, idx = packlib.codes_to_log(codes, bits)
    u = ((sign < 0).to(torch.int32) << 15) | ((idx + _lo(fsr, bits) + 127) << 7)
    u = u & 0xFFFF
    return torch.where(u >= 2**15, u - 2**16, u).to(torch.int16).view(torch.bfloat16)


def decode_log_weights(w_packed: torch.Tensor, *, fsr: float, bits: int) -> torch.Tensor:
    """Packed log codes (Kp/4, N) -> bf16 ``±2^e`` weights (Kp, N): the
    one-pass decode. Every packed row decodes; callers slice their true K."""
    _check_bits(bits)
    r = packed_rows(w_packed, CODE_BITS)
    n = w_packed.shape[1]
    dev = w_packed.device
    if dev.type == "cpu":
        return decode_log_weights_reference(w_packed, fsr=fsr, bits=bits)
    if dev.type != "cuda":
        raise ValueError(f"decode_log_weights: unsupported device {dev}")
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    out = torch.empty((4 * r, n), dtype=torch.bfloat16, device=dev)
    lib = _lib()
    code = lib.qt_decode_log(
        _build.ptr(w_packed), _build.ptr(out), r, n, bits, _lo(fsr, bits),
        *_build.launch_args(w_packed),
    )
    _build.check(lib, code, "decode_log_weights")
    decode_log_weights.launches += 1
    return out


decode_log_weights.launches = 0


def shift_gemm_reference(x: torch.Tensor, w_packed: torch.Tensor, *, fsr: float, bits: int):
    """Plain PyTorch version of :func:`shift_gemm`: bf16(x) times the decoded
    weights, summed exactly in float64 and rounded once to float32."""
    w = decode_log_weights_reference(w_packed, fsr=fsr, bits=bits)
    xb = pad_dim(x.to(torch.bfloat16), 1, w.shape[0])
    return (xb.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)


def shift_gemm(x: torch.Tensor, w_packed: torch.Tensor, *, fsr: float, bits: int) -> torch.Tensor:
    """(M, K) float x @ packed log weights -> (M, N) float32, with x rounded
    to bf16 first: ``bf16(x) @ log_quant(w)`` with a float32 sum. K may be
    less than the packed K: the missing columns of x count as 0."""
    _check_bits(bits)
    m, k = x.shape
    r = packed_rows(w_packed, CODE_BITS, k)
    n = w_packed.shape[1]
    dev = x.device
    if dev.type == "cpu":
        return shift_gemm_reference(x, w_packed, fsr=fsr, bits=bits)
    if dev.type != "cuda":
        raise ValueError(f"shift_gemm: unsupported device {dev}")
    # the kernel rounds float32 to bf16 as it loads; bf16 x is exact in float32
    x = x.to(torch.float32).contiguous()
    _build.require("w_packed", w_packed, torch.int32, (r, n), dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _lib()
    code = lib.qt_shift_gemm(
        _build.ptr(x), _build.ptr(w_packed), _build.ptr(out), m, n, k, r, bits,
        _lo(fsr, bits), *_build.launch_args(x),
    )
    _build.check(lib, code, "shift_gemm")
    shift_gemm.launches += 1
    return out


shift_gemm.launches = 0


def shift_gemm_decoded(x: torch.Tensor, w_bf16: torch.Tensor) -> torch.Tensor:
    """Pre-decoded bf16 ``±2^e`` weights (Kp, N) through a plain matmul:
    bf16(x), zero-padded to Kp, times the weights with a float32 sum (a
    float32 matmul, which PyTorch runs without TF32 unless told otherwise)."""
    xb = pad_dim(x.to(torch.bfloat16), 1, w_bf16.shape[0])
    return xb.to(torch.float32) @ w_bf16.to(torch.float32)
