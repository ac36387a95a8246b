"""int8 2-D convolution with an int32 accumulator and fused epilogues (K5).

The JAX package leaves its int8 convolutions to XLA
(``conv_general_dilated(..., preferred_element_type=int32)`` in
``kernels/conv.py`` direct mode and ``infer/fused_chain.py``, where the
binary chains follow it with ``where(y >= thr, hi, lo)``). PyTorch has
no int8 convolution on CUDA, so ``int8_conv2d`` launches the hand-written
implicit-GEMM kernel in ``csrc/int8_conv.cu`` (int8 tensor cores on the
streamed schedule of ``csrc/stream_tile.cuh``, tiles from
``common.conv_plan``) for CUDA tensors and takes its plain PyTorch version
``int8_conv2d_reference`` for CPU tensors; ``int8_conv2d.launches`` counts
the kernel launches.

With ``w_bits`` (1, 2 or 4) the weight is the packed conv weight itself,
grouped-planar words (``ops.pack``) of centered codes ``2c - (2^w_bits -
1)``: binary/xnor at one bit (what ``decode_binary_weights`` K2 expands),
DoReFa at 1, 2 or 4 (``decode_dorefa_weights`` K7). The kernel then decodes
them in its own weight stage (``int8_conv_kernel_packed``: K walked by
channel block, the packed groups of a block's taps staged once; plan
``common.conv_slab_plan``), one launch where decode + conv took two;
``int8_conv2d.packed_launches`` counts those launches (``launches`` counts
every launch). Its plain version decodes with
``decode_dorefa_weights_reference`` (which is K2's at one bit) and runs
``int8_conv2d_reference``.

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
* ``affine``: ``a[n] * f + b[n]`` -> float32;
* ``threshold``: ``f >= a[n] ? b[0, n] : b[1, n]`` -> int8, with ``b`` the
  (2, N) float32 codes (hi, lo): the binary fused chains' BatchNorm and next
  sign folded into a threshold on the raw sum. A tie gives hi, and
  ``a[n] = -inf`` always hi (a constant code).

``int8_conv2d.epilogue_launches`` counts the launches by epilogue.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from pytorch_quantize_impls_tpu_torch.kernels import _build
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as pm
from pytorch_quantize_impls_tpu_torch.kernels.common import conv_plan, conv_slab_plan
from pytorch_quantize_impls_tpu_torch.ops import pack as packlib

EPILOGUES = ("scale", "codes", "affine", "threshold")
CODE_EPILOGUES = ("codes", "threshold")  # int8 out
PACKED_BITS = (1, 2, 4)
Pads = Tuple[Tuple[int, int], Tuple[int, int]]
# csrc/int8_conv.cu Int8ConvArgs: (x, w, a, b, out, stream) addresses, the
# shape (B, H, W, C, KH, KW, HO, WO, N, SH, SW, pad_top, pad_left), then
# (epilogue, n_a, bn, device, bits, groups, rows)
_CONV_ARGS = struct.Struct("=6Q20i")


@functools.lru_cache(maxsize=None)  # the argtypes list is built once
def _lib() -> ctypes.CDLL:
    # one packed Int8ConvArgs (_CONV_ARGS)
    return _build.library("int8_conv", qt_int8_conv2d=[ctypes.c_char_p])


def out_size(n: int, k: int, stride: int, pad: Tuple[int, int]) -> int:
    return (n + pad[0] + pad[1] - k) // stride + 1


def threshold_codes(f: torch.Tensor, thr: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """int8 ``codes[0]`` where ``f >= thr``, ``codes[1]`` elsewhere, per
    channel (the last axis): the ``threshold`` epilogue on a float32 sum."""
    return torch.where(f >= thr, codes[0], codes[1]).to(torch.int8)


def _epilogue(acc, epilogue, a, b, n_a):
    f = acc.to(torch.float32)
    if epilogue == "scale":
        return f if a is None else f * a
    if epilogue == "threshold":
        return threshold_codes(f, a, b)
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
    w_bits: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_conv2d`: packed words decoded
    first (``w_bits``), then the convolution in float64, which is exact for
    int8 operands (every partial sum is an integer far below 2**53), then
    the same f32 epilogue."""
    kh, kw = kernel_size
    if w_bits:
        w_i8 = pm.decode_dorefa_weights_reference(w_i8, w_bits=w_bits)[: x_i8.shape[-1] * kh * kw]
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
    w_bits: int = 0,
) -> torch.Tensor:
    """NHWC int8 x (B, H, W, C) * flat int8 weights (C*KH*KW, N) -> NHWC
    (B, HO, WO, N), float32 (``scale``, ``affine``) or int8 (``codes``,
    ``threshold``).

    ``a`` is the per-channel scale for ``scale`` (optional), the affine
    factor for ``codes``/``affine`` and the threshold for ``threshold``;
    ``b`` the affine offset, or for ``threshold`` the (2, N) codes (hi, lo)
    as float32; ``n_a`` the top code of ``codes``. ``w_bits`` in PACKED_BITS: the weight is packed
    int32 words (R, N) of centered ``w_bits``-bit codes covering C*KH*KW
    rows, decoded in the kernel's weight stage."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if epilogue != "scale" and (a is None or b is None):
        raise ValueError(f"epilogue {epilogue!r} needs a and b")
    bsz, h, w, c = x_i8.shape
    kh, kw = kernel_size
    n = w_i8.shape[1]
    if w_bits:
        if w_bits not in PACKED_BITS:
            raise ValueError(f"w_bits={w_bits!r}: the packed stage decodes {PACKED_BITS} bits")
        rows = w_i8.shape[0]
        if rows % packlib.GROUP_ROWS or c * kh * kw > rows * packlib.pack_factor(w_bits):
            raise ValueError(f"packed weight has {rows} rows, cin * kh * kw = {c * kh * kw}")
    elif w_i8.shape[0] != c * kh * kw:
        raise ValueError(f"weight rows {w_i8.shape[0]} != cin * kh * kw = {c * kh * kw}")
    sh, sw = strides
    ho, wo = out_size(h, kh, sh, pads[0]), out_size(w, kw, sw, pads[1])
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output {ho} x {wo}")
    dev = x_i8.device
    if dev.type == "cpu":
        return int8_conv2d_reference(
            x_i8, w_i8, kernel_size, strides, pads, epilogue, a, b, n_a, w_bits)
    if dev.type != "cuda":
        raise ValueError(f"int8_conv2d: unsupported device {dev}")
    _build.require("x_i8", x_i8, torch.int8, (bsz, h, w, c), dev)
    if w_bits:
        _build.require("w_packed", w_i8, torch.int32, (rows, n), dev)
        plan = conv_slab_plan(c, kh * kw, w_bits)
        if not plan["fits"]:
            raise ValueError(f"int8_conv2d: a slab of {plan['groups']} packed groups needs "
                             f"{plan['smem']} bytes of shared memory")
        bn, groups = plan["bn"], plan["groups"]
    else:
        _build.require("w_i8", w_i8, torch.int8, (c * kh * kw, n), dev)
        bn, rows, groups = conv_plan(bsz * ho * wo, n)["bn"], 0, 0
    b_shape = (2, n) if epilogue == "threshold" else (n,)
    for name, t, shape in (("a", a, (n,)), ("b", b, b_shape)):
        if t is not None:
            _build.require(name, t, torch.float32, shape, dev)
    out = torch.empty((bsz, ho, wo, n), device=dev,
                      dtype=torch.int8 if epilogue in CODE_EPILOGUES else torch.float32)
    index, stream = _build.launch_args(x_i8)
    lib = _lib()
    code = lib.qt_int8_conv2d(_CONV_ARGS.pack(
        x_i8.data_ptr(), w_i8.data_ptr(), 0 if a is None else a.data_ptr(),
        0 if b is None else b.data_ptr(), out.data_ptr(), stream,
        bsz, h, w, c, kh, kw, ho, wo, n, sh, sw, pads[0][0], pads[1][0],
        EPILOGUES.index(epilogue), n_a, bn, index, w_bits, groups, rows,
    ))
    _build.check(lib, code, "int8_conv2d")
    int8_conv2d.launches += 1
    int8_conv2d.epilogue_launches[epilogue] += 1
    if w_bits:
        int8_conv2d.packed_launches += 1
    return out


int8_conv2d.launches = 0
int8_conv2d.packed_launches = 0
int8_conv2d.epilogue_launches = dict.fromkeys(EPILOGUES, 0)
