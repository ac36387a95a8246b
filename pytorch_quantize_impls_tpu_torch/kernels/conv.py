"""Packed 2-D convolution over 1-bit weights (binary / xnor schemes).

Counterpart of ``pytorch_quantize_impls_tpu/kernels/conv.py`` in its
``direct`` mode: decode the packed weight planes (``decode_binary_weights``,
a kernel on the card) and run the framework's own convolution. The JAX
package runs XLA's int8 conv with an int32 accumulator; here the conv runs in
float32 on ±1 values, which is exact: every product is ±1 and every partial
sum an integer of magnitude <= cin * kh * kw (3200 for BNN LeNet's conv2)
< 2**24. The ``im2col`` mode, the dorefa and log schemes, and a hand-written
int8 conv (ROADMAP K5) are not ported yet.

Layouts follow the JAX package: x is NHWC, and the packed weight is the HWIO
kernel flattened to (cin * kh * kw, cout) in (cin, kh, kw) order, which is
PyTorch's OIHW ``weight.reshape(cout, -1).T``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as bg


class PackedConv(NamedTuple):
    """Frozen packed conv weights + metadata (inference export unit)."""

    scheme: str  # 'binary' | 'xnor'
    packed: torch.Tensor
    kernel_size: Tuple[int, int]
    cin: int
    cout: int
    alpha: Optional[torch.Tensor] = None  # xnor per-out-channel scale


def decode_conv_weights(pw: PackedConv) -> torch.Tensor:
    """Packed flat planes -> OIHW ±1 int8 weights for the direct conv."""
    if pw.scheme not in ("binary", "xnor"):
        raise NotImplementedError(
            f"packed conv scheme {pw.scheme!r} is not ported yet (ROADMAP K5-K9)"
        )
    kh, kw = pw.kernel_size
    k = pw.cin * kh * kw
    flat = bg.decode_binary_weights(pw.packed)[:k]
    return flat.T.reshape(pw.cout, pw.cin, kh, kw)


def _torch_padding(padding: Union[str, Sequence[Tuple[int, int]]]) -> str:
    """JAX's 'SAME'/'VALID' as PyTorch's conv padding. Explicit pad pairs are
    not ported yet; PyTorch refuses 'same' with strides > 1, as it should."""
    if not isinstance(padding, str):
        raise NotImplementedError(f"explicit conv padding {padding!r} is not ported yet")
    return padding.lower()


def conv2d_nhwc(x, w_oihw, strides, padding) -> torch.Tensor:
    """NHWC x, OIHW weights -> NHWC float conv, without TF32: cuDNN's default
    TF32 would round the real-valued first-layer inputs to 10 mantissa bits."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(
            x.permute(0, 3, 1, 2), w_oihw, stride=tuple(strides),
            padding=_torch_padding(padding),
        )
    return y.permute(0, 2, 3, 1)


def packed_conv2d(
    x: torch.Tensor,
    pw: PackedConv,
    *,
    strides: Tuple[int, int] = (1, 1),
    padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
    mode: str = "direct",
) -> torch.Tensor:
    """NHWC packed conv with sign-binarized inputs (full-binary conv).

    The weights are decoded from ``pw.packed`` on every call, as in the JAX
    package. SAME-padding zeros stay 0, as in the fake-quant conv.
    """
    if mode != "direct":
        raise NotImplementedError(f"packed conv mode {mode!r} is not ported yet (ROADMAP K5)")
    w = decode_conv_weights(pw).to(torch.float32)
    xb = torch.where(x >= 0, 1.0, -1.0).to(torch.float32)
    # The exact sum is an integer; rounding removes any error a transform-based
    # convolution algorithm (Winograd, FFT) might add, so the result is the
    # integer the JAX package's int32 conv gives.
    y = conv2d_nhwc(xb, w, strides, padding).round()
    if pw.alpha is not None:
        y = y * pw.alpha
    return y
