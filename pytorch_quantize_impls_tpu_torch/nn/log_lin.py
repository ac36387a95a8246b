"""Log and linear FSR-quantized layers.

Counterpart of ``pytorch_quantize_impls_tpu/nn/log_lin.py``: dense and conv
wrappers taking ``fsr`` and ``bits`` (the reference spells the weight bits
``bitwight``, which overrides ``bits``), quantizing weights (and, with
``quantize_input=True``, inputs) with ``ops.log_quant`` or
``ops.lin_quant``. Each wraps its ``QuantDense``/``QuantConv`` as a child
named ``dense``/``conv``, so module paths match the flax ones
(``("head", "dense")``). ``clip_bound = 2^fsr`` is the clamp domain of the
master weight, metadata for training.

The log layers are the ones ``infer.pack_model`` lowers to the shift
kernels (``kernels.shift_matmul``). ``quantize_input=True`` sets
``a_bits = w_bits``, which ``infer.pack_model`` refuses: the JAX package's
packed paths ignore the input quantizer (ROADMAP section 3).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple, Union

from torch import nn

from pytorch_quantize_impls_tpu_torch.nn.base import QuantConv, QuantDense
from pytorch_quantize_impls_tpu_torch.ops.log_lin import lin_quant, log_quant


def _quant_kwargs(scheme, fsr, bits, bitwight, quantize_input, lin_back):
    """(clip bound, the Quant layer's quantizers and metadata)."""
    w_bits = bits if bitwight is None else bitwight
    if scheme == "log":
        q = partial(log_quant, fsr=fsr, bits=w_bits, lin_back=lin_back)
    else:
        q = partial(lin_quant, fsr=fsr, bits=w_bits)
    kw = dict(
        weight_quant=q,
        input_quant=q if quantize_input else None,
        scheme=scheme,
        w_bits=w_bits,
        a_bits=w_bits if quantize_input else 0,
        fsr=fsr,
    )
    return 2.0**fsr, kw


class _LogLinDense(nn.Module):
    scheme = "log"

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        fsr: float = 0.0,
        bits: int = 4,
        bitwight: Optional[int] = None,
        quantize_input: bool = False,
        lin_back: bool = True,
        use_bias: bool = True,
    ):
        super().__init__()
        self.clip_bound, kw = _quant_kwargs(
            self.scheme, fsr, bits, bitwight, quantize_input, lin_back
        )
        self.dense = QuantDense(in_features, features, use_bias=use_bias, **kw)

    def forward(self, x):
        return self.dense(x)


class _LogLinConv(nn.Module):
    scheme = "log"

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        fsr: float = 0.0,
        bits: int = 4,
        bitwight: Optional[int] = None,
        quantize_input: bool = False,
        lin_back: bool = True,
        use_bias: bool = True,
    ):
        super().__init__()
        self.clip_bound, kw = _quant_kwargs(
            self.scheme, fsr, bits, bitwight, quantize_input, lin_back
        )
        self.conv = QuantConv(
            in_channels, features, kernel_size, strides=strides, padding=padding,
            use_bias=use_bias, **kw,
        )

    def forward(self, x):
        return self.conv(x)


class LinearQuantLog(_LogLinDense):
    """Dense layer with power-of-2 weights; clamp domain ±2^fsr."""


class LinearQuantLin(_LogLinDense):
    """Dense layer with uniform-FSR-grid weights."""

    scheme = "lin"


class ConvQuantLog(_LogLinConv):
    """Conv layer (NHWC) with power-of-2 weights."""


class ConvQuantLin(_LogLinConv):
    """Conv layer (NHWC) with uniform-FSR-grid weights."""

    scheme = "lin"
