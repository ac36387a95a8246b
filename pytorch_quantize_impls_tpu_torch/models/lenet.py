"""BNN LeNet-style conv net for MNIST (BASELINE config 2).

Counterpart of ``pytorch_quantize_impls_tpu/models/lenet.py``: binarized
weights AND activations (BNN, arXiv:1602.02830). The first conv takes the
real-valued image; every later layer sign-binarizes its input. Input is NHWC
``(B, 28, 28, 1)``, as in the JAX package, and activations stay NHWC between
layers, so ``fc1`` sees the (h, w, c) flattening the JAX model gives it.
Module names match the flax ones (``conv1.conv``, ``bn1``, ..., ``head.dense``).

Only the eval forward is ported; training (batch statistics, the fp32 twin)
waits for its ROADMAP item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_quantize_impls_tpu_torch.nn.binary import BinConv, LinearBin


class BatchNorm(nn.Module):
    """Channels-last BatchNorm in eval mode, with flax's arithmetic order
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``: the sign taken right
    after it should see the same float rounding as the JAX model's."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "BatchNorm training (batch statistics) is not ported yet; call .eval()"
            )
        mul = torch.rsqrt(self.running_var + self.epsilon) * self.weight
        return (x - self.running_mean) * mul + self.bias


def max_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID, on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class BNNLeNet(nn.Module):
    """conv1 5x5 1->w, bn1, pool, conv2 5x5 w->2w (binary input), bn2, pool,
    fc1 16*2w->8w, bn3, head 8w->classes; no biases."""

    def __init__(self, classes: int = 10, width: int = 32):
        super().__init__()
        w = width
        self.conv1 = BinConv(1, w, (5, 5), padding="VALID", use_bias=False)
        self.bn1 = BatchNorm(w)
        self.conv2 = BinConv(
            w, 2 * w, (5, 5), padding="VALID", binarize_input=True, use_bias=False
        )
        self.bn2 = BatchNorm(2 * w)
        self.fc1 = LinearBin(4 * 4 * 2 * w, 8 * w, binarize_input=True, use_bias=False)
        self.bn3 = BatchNorm(8 * w)
        self.head = LinearBin(8 * w, classes, binarize_input=True, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_nhwc(self.bn1(self.conv1(x)))
        x = max_pool_nhwc(self.bn2(self.conv2(x)))
        x = x.reshape(x.shape[0], -1)
        return self.head(self.bn3(self.fc1(x)))
