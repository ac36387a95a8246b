"""Log-quant VGG-small for CIFAR-10 (BASELINE config 5).

Counterpart of ``LogQuantVGGSmall`` in
``pytorch_quantize_impls_tpu/models/convnets.py``: VGG-small with
power-of-2 weights (arXiv:1603.01025) and float activations. Each stage is a
3x3 ``ConvQuantLog`` without bias, BatchNorm and ReLU, with a 2x2 max pool
after every second conv; the head is a ``LinearQuantLog`` with a bias. Input
is NHWC ``(B, 32, 32, 3)``, as in the JAX package, and activations stay NHWC,
so the head sees the (h, w, c) flattening the JAX model gives it. Module
names match the flax ones (``conv0.conv``, ``bn0``, ..., ``head.dense``), so
``utils.bridge`` loads the JAX variables directly.

Only the eval forward of the quantized model is ported; the JAX model's
``quantized=False`` twin and ``dtype`` serve training.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.models.lenet import BatchNorm, max_pool_nhwc
from pytorch_quantize_impls_tpu_torch.nn.log_lin import ConvQuantLog, LinearQuantLog


IMAGE_SHAPE = (32, 32, 3)  # CIFAR-10, NHWC without the batch


class LogQuantVGGSmall(nn.Module):
    def __init__(
        self,
        classes: int = 10,
        widths: Tuple[int, ...] = (128, 128, 256, 256, 512, 512),
        bits: int = 4,
        fsr: float = 1.0,
    ):
        super().__init__()
        self.widths = tuple(widths)
        cin = IMAGE_SHAPE[2]
        for i, w in enumerate(self.widths):
            self.add_module(f"conv{i}", ConvQuantLog(cin, w, (3, 3), fsr=fsr, bits=bits,
                                                     use_bias=False))
            self.add_module(f"bn{i}", BatchNorm(w))
            cin = w
        side = IMAGE_SHAPE[0] // 2 ** (len(self.widths) // 2)
        self.head = LinearQuantLog(side * side * cin, classes, fsr=fsr, bits=bits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.widths)):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
            if i % 2 == 1:
                x = max_pool_nhwc(x)
        return self.head(x.reshape(x.shape[0], -1))
