"""The XNOR-Net convnet and the log-quant VGG-small for CIFAR-10 (BASELINE
configs 3 and 5).

Counterpart of ``pytorch_quantize_impls_tpu/models/convnets.py``.

``XNORConvNet``: a VGG-like stack of 3x3 ``XNORConv`` stages without bias,
each followed by BatchNorm and, after every second one, a 2x2 max pool; the
head is an ``XNORLinear`` with a bias. The first conv sees real pixels; in
full-XNOR mode (``binarize_inputs=True``, the default) every later conv
sign-binarizes its input and multiplies its output by the K map
(``use_input_scale_map``). The nonlinearity rule is the JAX model's: a ReLU
follows every BatchNorm (after the pool) unless the model is quantized and
binarizes its inputs, where the next layer's sign is the nonlinearity (ReLU
first would make every code +1). ``fp32_first_last=True`` keeps the first
conv and the head float32. ``image_shape`` is the NHWC input without the
batch, CIFAR's ``(32, 32, 3)`` by default: the first conv's channels and the
head's fan-in follow from it, as flax infers them (the digits configs take
``(8, 8, 1)``). ``quantized=False`` is the float32 twin of the
Δ-accuracy runs: every conv and the head are flax ``nn.Conv``/``nn.Dense``
(``Conv``/``Dense``), which hold ``weight`` themselves (``conv0``, ``head``),
as ``fp32_first_last`` does for those two. Module names match the flax ones
(``conv0.conv``, ``bn0``, ..., ``head.dense``; the twin's ``conv0``, ...,
``head``), so ``utils.bridge`` loads the JAX variables directly.

``LogQuantVGGSmall``: VGG-small with
power-of-2 weights (arXiv:1603.01025) and float activations. Each stage is a
3x3 ``ConvQuantLog`` without bias, BatchNorm and ReLU, with a 2x2 max pool
after every second conv; the head is a ``LinearQuantLog`` with a bias;
``quantized=False`` is its float32 twin (plain ``Conv``/``Dense``). Input
is NHWC ``(B, 32, 32, 3)``, as in the JAX package, and activations stay NHWC,
so the head sees the (h, w, c) flattening the JAX model gives it. Module
names match the flax ones (``conv0.conv``, ``bn0``, ..., ``head.dense``), so
``utils.bridge`` loads the JAX variables directly.

``dtype`` (``None`` or ``torch.bfloat16``) is both models' compute dtype:
every conv, BatchNorm and head computes at it, ``fp32_first_last``'s plain
first conv and head included (their weights are the unquantized float32
masters), as in the JAX models.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.models.lenet import BatchNorm, max_pool_nhwc
from pytorch_quantize_impls_tpu_torch.nn.base import Conv, Dense
from pytorch_quantize_impls_tpu_torch.nn.log_lin import ConvQuantLog, LinearQuantLog
from pytorch_quantize_impls_tpu_torch.nn.xnor import XNORConv, XNORLinear


IMAGE_SHAPE = (32, 32, 3)  # CIFAR-10, NHWC without the batch


class XNORConvNet(nn.Module):
    def __init__(
        self,
        classes: int = 10,
        widths: Tuple[int, ...] = (128, 128, 256, 256, 512, 512),
        quantized: bool = True,
        binarize_inputs: bool = True,
        fp32_first_last: bool = False,
        use_input_scale_map: bool = True,
        dtype: Optional[Any] = None,
        image_shape: Tuple[int, int, int] = IMAGE_SHAPE,
    ):
        super().__init__()
        self.widths = tuple(widths)
        self.quantized = quantized
        self.binarize_inputs = binarize_inputs
        self.fp32_first_last = fp32_first_last
        self.use_input_scale_map = use_input_scale_map
        self.image_shape = tuple(image_shape)
        height, width, cin = self.image_shape
        for i, w in enumerate(self.widths):
            if not quantized or (fp32_first_last and i == 0):
                conv = Conv(cin, w, (3, 3), use_bias=False, dtype=dtype)
            else:
                # the first conv sees real pixels in either mode
                conv = XNORConv(cin, w, (3, 3), binarize_input=binarize_inputs and i > 0,
                                use_input_scale_map=use_input_scale_map, use_bias=False,
                                dtype=dtype)
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", BatchNorm(w, dtype=dtype))
            cin = w
        pools = 2 ** (len(self.widths) // 2)
        features = (height // pools) * (width // pools) * cin
        self.head = (XNORLinear(features, classes, dtype=dtype)
                     if quantized and not fp32_first_last
                     else Dense(features, classes, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        relu = not (self.quantized and self.binarize_inputs)
        for i in range(len(self.widths)):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            if i % 2 == 1:
                x = max_pool_nhwc(x)
            if relu:
                x = torch.relu(x)
        return self.head(x.reshape(x.shape[0], -1))


class LogQuantVGGSmall(nn.Module):
    def __init__(
        self,
        classes: int = 10,
        widths: Tuple[int, ...] = (128, 128, 256, 256, 512, 512),
        bits: int = 4,
        fsr: float = 1.0,
        quantized: bool = True,
        dtype: Optional[Any] = None,
    ):
        super().__init__()
        self.widths = tuple(widths)
        cin = IMAGE_SHAPE[2]
        for i, w in enumerate(self.widths):
            self.add_module(f"conv{i}", ConvQuantLog(cin, w, (3, 3), fsr=fsr, bits=bits,
                                                     use_bias=False, dtype=dtype) if quantized
                            else Conv(cin, w, (3, 3), use_bias=False, dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(w, dtype=dtype))
            cin = w
        side = IMAGE_SHAPE[0] // 2 ** (len(self.widths) // 2)
        features = side * side * cin
        self.head = (LinearQuantLog(features, classes, fsr=fsr, bits=bits, dtype=dtype)
                     if quantized else Dense(features, classes, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.widths)):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            if i % 2 == 1:
                x = max_pool_nhwc(x)
        return self.head(x.reshape(x.shape[0], -1))
