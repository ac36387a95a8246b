"""Generic quantized Dense/Conv modules.

Counterpart of ``pytorch_quantize_impls_tpu/nn/base.py``. ``QuantDense`` and
``QuantConv`` hold a float32 master ``weight`` and apply a weight quantizer
(and optionally an input quantizer) on every forward call: the fake-quant
forward. They carry the ``scheme/w_bits/a_bits/fsr`` metadata that
``infer.pack_model`` reads.

Layouts follow the JAX package at the module boundary: ``QuantDense`` takes
(..., in) and ``QuantConv`` NHWC. Weights use PyTorch's layouts, (out, in)
and OIHW (``utils.bridge`` converts).

:func:`intercept_quant_layers` is the counterpart of flax's
``intercept_methods`` for these two classes: while it is active in a thread,
each of their forward calls goes to the interceptor instead, which is how
``infer.packed_apply`` runs a model on its packed weights.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc

Quantizer = Callable[[torch.Tensor], torch.Tensor]
# (module, x, fake_quant_forward) -> y
Interceptor = Callable[[nn.Module, torch.Tensor, Callable], torch.Tensor]

_interceptor: contextvars.ContextVar[Optional[Interceptor]] = contextvars.ContextVar(
    "quant_layer_interceptor", default=None
)


@contextlib.contextmanager
def intercept_quant_layers(fn: Interceptor):
    """Route every ``QuantDense``/``QuantConv`` forward in this thread to
    ``fn(module, x, fake_quant_forward)`` until the block exits."""
    token = _interceptor.set(fn)
    try:
        yield
    finally:
        _interceptor.reset(token)


class _QuantLayer(nn.Module):
    def __init__(self, weight_quant, input_quant, scheme, w_bits, a_bits, fsr):
        super().__init__()
        self.weight_quant = weight_quant
        self.input_quant = input_quant
        self.scheme = scheme  # none|binary|xnor|dorefa|log|lin|ternary
        self.w_bits = w_bits
        self.a_bits = a_bits  # 0 = inputs not quantized
        self.fsr = fsr

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = _interceptor.get()
        if fn is not None:
            return fn(self, x, self.fake_quant_forward)
        return self.fake_quant_forward(x)

    def _quantized(self, x):
        if self.input_quant is not None:
            x = self.input_quant(x)
        w = self.weight if self.weight_quant is None else self.weight_quant(self.weight)
        return x, w


class QuantDense(_QuantLayer):
    """Dense layer with quantized weights (and optionally inputs)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        weight_quant: Optional[Quantizer] = None,
        input_quant: Optional[Quantizer] = None,
        use_bias: bool = True,
        scheme: str = "none",
        w_bits: int = 1,
        a_bits: int = 0,
        fsr: float = 0.0,
    ):
        super().__init__(weight_quant, input_quant, scheme, w_bits, a_bits, fsr)
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.xavier_normal_(self.weight)

    def fake_quant_forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = self._quantized(x)
        y = x @ w.T
        if self.bias is not None:
            y = y + self.bias
        return y


class QuantConv(_QuantLayer):
    """2-D conv (NHWC input, OIHW weight) with quantized weights (and
    optionally inputs)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        weight_quant: Optional[Quantizer] = None,
        input_quant: Optional[Quantizer] = None,
        use_bias: bool = True,
        scheme: str = "none",
        w_bits: int = 1,
        a_bits: int = 0,
        fsr: float = 0.0,
    ):
        super().__init__(weight_quant, input_quant, scheme, w_bits, a_bits, fsr)
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(features, in_channels, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.xavier_normal_(self.weight)

    def fake_quant_forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = self._quantized(x)
        y = conv2d_nhwc(x, w, self.strides, self.padding)
        if self.bias is not None:
            y = y + self.bias
        return y
