"""DoReFa ResNet-20 for CIFAR-10 (BASELINE config 4: W4A4).

Counterpart of ``pytorch_quantize_impls_tpu/models/resnet.py``: the CIFAR
ResNet-20 (3 stages x 3 basic blocks, widths w/2w/4w) with DoReFa k-bit
weights and k-bit inputs to every block conv. The stem conv, the 1x1
projection shortcuts and the classifier stay float32; the residual stream
stays real-valued. Input is NHWC ``(B, 32, 32, 3)``, as in the JAX package,
and module names match the flax ones (``stem``, ``bn_stem``,
``stage1_block0.conv1.conv``, ``.conv1.act``, ``.bn1``, ``.proj``,
``.bn_proj``, ``head``), so ``utils.bridge`` loads the JAX variables
directly.

Only the eval forward is ported, with quantized block convs (the JAX
model's ``quantized=False`` twin, ``dtype`` and ``remat`` serve training).
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.kernels.conv import conv2d_nhwc
from pytorch_quantize_impls_tpu_torch.models.lenet import BatchNorm
from pytorch_quantize_impls_tpu_torch.nn.dorefa import DorefaConv


class Conv(nn.Module):
    """Float32 NHWC conv without bias (flax ``nn.Conv(use_bias=False)``),
    with JAX's SAME padding."""

    def __init__(self, in_channels: int, features: int, kernel_size, strides=(1, 1)):
        super().__init__()
        self.strides = tuple(strides)
        self.weight = nn.Parameter(torch.empty(features, in_channels, *kernel_size))
        nn.init.xavier_normal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x, self.weight, self.strides, "SAME")


class BasicBlock(nn.Module):
    """conv1 (stride s) -> bn1 -> relu -> conv2 -> bn2, plus the identity or
    a 1x1 projection (+ BN) shortcut, then relu. Each block conv quantizes
    its own input (``a_bits``), so the residual stream stays real."""

    def __init__(self, in_channels, features, strides=1, *, w_bits=4, a_bits=4, a_quant="fixed"):
        super().__init__()
        conv = dict(bits=w_bits, a_bits=a_bits or None, a_quant=a_quant, use_bias=False)
        self.conv1 = DorefaConv(in_channels, features, strides=(strides, strides), **conv)
        self.bn1 = BatchNorm(features)
        self.conv2 = DorefaConv(features, features, **conv)
        self.bn2 = BatchNorm(features)
        self.proj = self.bn_proj = None
        if strides != 1 or in_channels != features:
            self.proj = Conv(in_channels, features, (1, 1), (strides, strides))
            self.bn_proj = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.proj is None else self.bn_proj(self.proj(x))
        return torch.relu(y + residual)


class DorefaResNet20(nn.Module):
    def __init__(self, classes: int = 10, w_bits: int = 4, a_bits: int = 4,
                 a_quant: str = "fixed", width: int = 16):
        super().__init__()
        self.w_bits, self.a_bits, self.a_quant, self.width = w_bits, a_bits, a_quant, width
        w = width
        self.stem = Conv(3, w, (3, 3))
        self.bn_stem = BatchNorm(w)
        cin = w
        for stage, (f, s) in enumerate([(w, 1), (2 * w, 2), (4 * w, 2)]):
            for block in range(3):
                self.add_module(f"stage{stage}_block{block}", BasicBlock(
                    cin, f, s if block == 0 else 1, w_bits=w_bits, a_bits=a_bits, a_quant=a_quant,
                ))
                cin = f
        self.head = nn.Linear(4 * w, classes)

    def blocks(self):
        return [getattr(self, f"stage{s}_block{b}") for s in range(3) for b in range(3)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn_stem(self.stem(x)))
        for blk in self.blocks():
            x = blk(x)
        return self.head(x.mean(dim=(1, 2)))
