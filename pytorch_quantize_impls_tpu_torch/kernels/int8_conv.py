"""int8 2-D convolution with an int32 accumulator and fused epilogues (K5).

The JAX package leaves its int8 convolutions to XLA
(``conv_general_dilated(..., preferred_element_type=int32)`` in
``kernels/conv.py`` direct mode and ``infer/fused_chain.py``). PyTorch has
no int8 convolution on CUDA, so ``int8_conv2d`` launches the hand-written
implicit-GEMM kernel in ``csrc/int8_conv.cu`` for CUDA tensors and takes its
plain PyTorch version ``int8_conv2d_reference`` for CPU tensors;
``int8_conv2d.launches`` counts the kernel launches.

Layouts are the JAX package's: x is NHWC int8 codes, the weight is the HWIO
kernel flattened to ``(cin * kh * kw, cout)`` in (cin, kh, kw) order, which
is what ``decode_binary_weights`` and ``decode_dorefa_weights`` emit (sliced
to their true K). Padding is explicit: ``pads = ((top, bottom), (left,
right))``, filled with the code 0.

Epilogues on the exact accumulator ``f = f32(acc)``, each product and sum
rounded on its own:

* ``scale``: ``f * scale[n]`` (or ``f``) -> float32;
* ``codes``: ``clip(round(a[n] * f + b[n]), 0, n_a)`` -> int8 (round half
  to even);
* ``affine``: ``a[n] * f + b[n]`` -> float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_quantize_impls_tpu_torch.kernels import _build

EPILOGUES = ("scale", "codes", "affine")
Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _lib() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.library(
        "int8_conv",
        # (x, w, shape[13], epilogue, a, b, n_a, out, device, stream)
        qt_int8_conv2d=[p, p, ctypes.POINTER(ctypes.c_int), i, p, p, i, p, i, p],
    )


def out_size(n: int, k: int, stride: int, pad: Tuple[int, int]) -> int:
    return (n + pad[0] + pad[1] - k) // stride + 1


def _epilogue(acc, epilogue, a, b, n_a):
    f = acc.to(torch.float32)
    if epilogue == "scale":
        return f if a is None else f * a
    y = a * f + b
    if epilogue == "affine":
        return y
    return torch.clamp(torch.round(y), 0, n_a).to(torch.int8)


def int8_conv2d_reference(
    x_i8: torch.Tensor,
    w_i8: torch.Tensor,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    pads: Pads,
    epilogue: str = "scale",
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    n_a: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_conv2d`: the convolution in
    float64, which is exact for int8 operands (every partial sum is an
    integer far below 2**53), then the same f32 epilogue."""
    kh, kw = kernel_size
    cout = w_i8.shape[1]
    cin = x_i8.shape[-1]
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x_i8.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    w = w_i8.T.reshape(cout, cin, kh, kw).to(torch.float64)
    acc = F.conv2d(xp, w, stride=tuple(strides)).permute(0, 2, 3, 1)
    return _epilogue(acc, epilogue, a, b, n_a)


def int8_conv2d(
    x_i8: torch.Tensor,
    w_i8: torch.Tensor,
    kernel_size: Tuple[int, int],
    strides: Tuple[int, int],
    pads: Pads,
    epilogue: str = "scale",
    a: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    n_a: int = 0,
) -> torch.Tensor:
    """NHWC int8 x (B, H, W, C) * flat int8 weights (C*KH*KW, N) -> NHWC
    (B, HO, WO, N), float32 (``scale``, ``affine``) or int8 (``codes``).

    ``a`` is the per-channel scale for ``scale`` (optional) and the affine
    factor for ``codes``/``affine``; ``b`` the affine offset; ``n_a`` the
    top code of ``codes``."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if epilogue != "scale" and (a is None or b is None):
        raise ValueError(f"epilogue {epilogue!r} needs a and b")
    bsz, h, w, c = x_i8.shape
    kh, kw = kernel_size
    n = w_i8.shape[1]
    if w_i8.shape[0] != c * kh * kw:
        raise ValueError(f"weight rows {w_i8.shape[0]} != cin * kh * kw = {c * kh * kw}")
    sh, sw = strides
    ho, wo = out_size(h, kh, sh, pads[0]), out_size(w, kw, sw, pads[1])
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output {ho} x {wo}")
    dev = x_i8.device
    if dev.type == "cpu":
        return int8_conv2d_reference(x_i8, w_i8, kernel_size, strides, pads, epilogue, a, b, n_a)
    if dev.type != "cuda":
        raise ValueError(f"int8_conv2d: unsupported device {dev}")
    _build.require("x_i8", x_i8, torch.int8, (bsz, h, w, c), dev)
    _build.require("w_i8", w_i8, torch.int8, (c * kh * kw, n), dev)
    for name, t in (("a", a), ("b", b)):
        if t is not None:
            _build.require(name, t, torch.float32, (n,), dev)
    out = torch.empty(
        (bsz, ho, wo, n), dtype=torch.int8 if epilogue == "codes" else torch.float32, device=dev
    )
    shape = (ctypes.c_int * 13)(bsz, h, w, c, kh, kw, ho, wo, n, sh, sw, pads[0][0], pads[1][0])
    lib = _lib()
    code = lib.qt_int8_conv2d(
        _build.ptr(x_i8), _build.ptr(w_i8), shape, EPILOGUES.index(epilogue),
        _build.ptr(a), _build.ptr(b), n_a, _build.ptr(out), *_build.launch_args(x_i8),
    )
    _build.check(lib, code, "int8_conv2d")
    int8_conv2d.launches += 1
    return out


int8_conv2d.launches = 0
