"""Packed 2-D convolution over bit-packed weights (binary, xnor, dorefa, log).

Counterpart of ``pytorch_quantize_impls_tpu/kernels/conv.py``. Two modes:

``direct`` (default): decode the packed weight planes on every call, as the
JAX package does. binary/xnor/dorefa decode to int8 codes
(``decode_binary_weights`` K2 or ``decode_dorefa_weights`` K7) and run the
int8 convolution K5 (``kernels.int8_conv``) with an int32 accumulator and a
scale epilogue, where the JAX package runs XLA's int8 conv. log decodes to
bf16 ``±2^e`` (``decode_log_weights`` K9) and runs a float conv of bf16(x)
on them with a float32 result (``conv2d_nhwc`` on the values upcast to
float32, TF32 off), where the JAX package runs XLA's bf16 conv.

``im2col``: patches (``F.unfold``, features in (cin, kh, kw) order) through
the packed GEMM, ``binary_gemm`` K1, ``dorefa_gemm`` K6 or ``shift_gemm``
K8: the cross-check path. Binary inputs are binarized before padding, so
padding stays 0.

Layouts follow the JAX package: x is NHWC, and the packed weight is the HWIO
kernel flattened to (cin * kh * kw, cout) in (cin, kh, kw) order, which is
PyTorch's OIHW ``weight.reshape(cout, -1).T``. Padding is JAX's: ``"SAME"``
pads ``total = max((ceil(n / s) - 1) * s + k - n, 0)`` with ``total // 2``
before and the rest after (asymmetric at stride 2: a 3x3 conv of a 32-wide
input pads (0, 1)), ``"VALID"`` none, or explicit ``(lo, hi)`` pairs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as sm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg
from pytorch_quantize_impls_tpu_torch.kernels.int8_conv import Pads, int8_conv2d

Padding = Union[str, Sequence[Tuple[int, int]]]
SCHEMES = ("binary", "xnor", "dorefa", "log")


class PackedConv(NamedTuple):
    """Frozen packed conv weights + metadata (inference export unit)."""

    scheme: str  # 'binary' | 'xnor' | 'dorefa' | 'log'
    packed: torch.Tensor
    kernel_size: Tuple[int, int]
    cin: int
    cout: int
    alpha: Optional[torch.Tensor] = None  # xnor per-out-channel scale
    w_bits: int = 1
    a_bits: int = 32
    fsr: float = 0.0


def _check_scheme(scheme: str) -> None:
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}")


def pack_conv_weights(
    w_oihw: torch.Tensor, scheme: str, *, w_bits: int = 1, a_bits: int = 32, fsr: float = 0.0
) -> PackedConv:
    """Pack OIHW conv weights for ``scheme`` (weights already on the DoReFa
    grid for 'dorefa'; raw float for 'binary'/'xnor'/'log')."""
    _check_scheme(scheme)
    cout, cin, kh, kw = w_oihw.shape
    flat = w_oihw.reshape(cout, -1).T
    alpha = None
    if scheme == "dorefa":
        packed = pm.pack_dorefa_weights(flat, w_bits)
    elif scheme == "log":
        packed = sm.pack_log_weights(flat, fsr, w_bits)
    else:
        packed = bg.pack_binary_weights(flat)
        if scheme == "xnor":
            alpha = w_oihw.abs().mean(dim=(1, 2, 3))
    return PackedConv(scheme, packed, (kh, kw), cin, cout, alpha, w_bits, a_bits, fsr)


def decode_conv_weights(pw: PackedConv) -> torch.Tensor:
    """Packed planes -> flat (cin * kh * kw, cout) weights: the int8 codes K5
    takes, ±1 for binary/xnor and centered ``2c - n_w`` for dorefa; exact
    bf16 ``±2^e`` for log."""
    _check_scheme(pw.scheme)
    kh, kw = pw.kernel_size
    k = pw.cin * kh * kw
    if pw.scheme == "dorefa":
        return pm.decode_dorefa_weights(pw.packed, w_bits=pw.w_bits)[:k]
    if pw.scheme == "log":
        return sm.decode_log_weights(pw.packed, fsr=pw.fsr, bits=pw.w_bits)[:k]
    return bg.decode_binary_weights(pw.packed)[:k]


def conv_pads(padding: Padding, in_hw, kernel_size, strides) -> Pads:
    """JAX's padding rule -> ((top, bottom), (left, right))."""
    if not isinstance(padding, str):
        (t, b), (lo, r) = padding
        return (int(t), int(b)), (int(lo), int(r))
    mode = padding.upper()
    if mode == "VALID":
        return (0, 0), (0, 0)
    if mode != "SAME":
        raise ValueError(f"unknown padding {padding!r}")
    pads = []
    for n, k, s in zip(in_hw, kernel_size, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def conv2d_nhwc(x, w_oihw, strides, padding: Padding) -> torch.Tensor:
    """NHWC x, OIHW weights -> NHWC float conv with JAX's padding, without
    TF32: cuDNN's default TF32 would round real-valued inputs to 10 mantissa
    bits."""
    (pt, pb), (pl, pr) = conv_pads(padding, x.shape[1:3], w_oihw.shape[2:], strides)
    xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xp, w_oihw, stride=tuple(strides))
    return y.permute(0, 2, 3, 1)


def _input_codes(x: torch.Tensor, pw: PackedConv) -> torch.Tensor:
    """int8 conv input codes: ±1 for binary/xnor, DoReFa codes (``x`` on
    the fake-quant grid) for dorefa."""
    if pw.scheme == "dorefa":
        return pm.dorefa_act_to_int8(x, pw.a_bits)
    return bg.binarize_to_int8(x)


def _scale(pw: PackedConv, device) -> Optional[torch.Tensor]:
    if pw.scheme == "dorefa":
        inv = pm.inv_scale(pw.w_bits, pw.a_bits)
        return torch.full((pw.cout,), inv, dtype=torch.float32, device=device)
    return pw.alpha


def packed_conv2d(
    x: torch.Tensor,
    pw: PackedConv,
    *,
    strides: Tuple[int, int] = (1, 1),
    padding: Padding = "SAME",
    mode: str = "direct",
) -> torch.Tensor:
    """NHWC packed conv. 'binary'/'xnor': x is sign-binarized (full-binary
    conv); 'dorefa': x is fake-quant [0, 1] activations (``a_bits``); 'log':
    x is rounded to bf16. Output float32 NHWC."""
    _check_scheme(pw.scheme)
    kh, kw = pw.kernel_size
    pads = conv_pads(padding, x.shape[1:3], (kh, kw), strides)
    if mode == "direct" and pw.scheme == "log":
        w = decode_conv_weights(pw).to(torch.float32).T.reshape(pw.cout, pw.cin, kh, kw)
        return conv2d_nhwc(x.to(torch.bfloat16).to(torch.float32), w, strides, pads)
    if mode == "direct":
        return int8_conv2d(
            _input_codes(x, pw), decode_conv_weights(pw), (kh, kw), tuple(strides), pads,
            "scale", _scale(pw, x.device),
        )
    if mode != "im2col":
        raise ValueError(f"unknown packed conv mode {mode!r}")
    b, h, w, _ = x.shape
    if pw.scheme in ("binary", "xnor"):
        # binarize BEFORE padding so the padding zeros stay 0
        x = torch.where(x >= 0, 1.0, -1.0)
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x.to(torch.float32).permute(0, 3, 1, 2), (pl, pr, pt, pb))
    patches = F.unfold(xp, (kh, kw), stride=tuple(strides))  # (b, cin*kh*kw, L), (cin, kh, kw)
    ho = (h + pt + pb - kh) // strides[0] + 1
    wo = (w + pl + pr - kw) // strides[1] + 1
    flat = patches.transpose(1, 2).reshape(b * ho * wo, -1)
    if pw.scheme == "dorefa":
        out = pm.dorefa_gemm(
            pm.dorefa_act_to_int8(flat, pw.a_bits), pw.packed, w_bits=pw.w_bits, a_bits=pw.a_bits
        )
    elif pw.scheme == "log":
        out = sm.shift_gemm(flat, pw.packed, fsr=pw.fsr, bits=pw.w_bits)
    else:
        out = bg.binary_gemm(flat.to(torch.int8), pw.packed, pw.alpha)  # exact {-1, 0, +1}
    return out.reshape(b, ho, wo, pw.cout)
