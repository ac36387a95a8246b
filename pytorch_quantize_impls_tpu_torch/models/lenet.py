"""BNN LeNet-style conv net for MNIST (BASELINE config 2).

Counterpart of ``pytorch_quantize_impls_tpu/models/lenet.py``: binarized
weights AND activations (BNN, arXiv:1602.02830). The first conv takes the
real-valued image; every later layer sign-binarizes its input. Input is NHWC
``(B, 28, 28, 1)``, as in the JAX package, and activations stay NHWC between
layers, so ``fc1`` sees the (h, w, c) flattening the JAX model gives it.
Module names match the flax ones (``conv1.conv``, ``bn1``, ..., ``head.dense``;
the ``quantized=False`` twin's plain layers are ``conv1``, ..., ``head``).

``dtype`` (``None`` or ``torch.bfloat16``) is the compute dtype of every
layer and BatchNorm, as in the JAX model; the master weights, BatchNorm's
scale, bias and running statistics stay float32.

``BatchNorm`` is flax's in both modes: in training it normalizes by the
batch statistics and moves the running ones, with flax's arithmetic. Inside
:func:`recomputing` (the backward's second forward of a checkpointed block,
``DorefaResNet20(remat=True)``) it leaves the running statistics alone, so
they move once per step, as under JAX's ``remat``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_quantize_impls_tpu_torch.nn.base import Conv, Dense, mesh_context
from pytorch_quantize_impls_tpu_torch.nn.binary import BinConv, LinearBin


_recomputing: contextvars.ContextVar[bool] = contextvars.ContextVar("recomputing",
                                                                    default=False)


@contextlib.contextmanager
def recomputing():
    """While active in a thread, a BatchNorm in training mode does not move
    its running statistics."""
    token = _recomputing.set(True)
    try:
        yield
    finally:
        _recomputing.reset(token)


class BatchNorm(nn.Module):
    """Channels-last BatchNorm (``flax.linen.BatchNorm``), statistics over
    every axis but the last. The normalization keeps flax's order
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, so the sign taken
    right after it sees the same float rounding as the JAX model's. In
    training mode it uses the batch mean and flax's fast variance
    ``max(0, mean(x^2) - mean(x)^2)`` (biased; the same value goes into
    ``running_var``) and moves the running statistics as
    ``momentum * running + (1 - momentum) * batch``. Under a sharded step
    (``nn.base.sharded_step``) the batch mean and ``mean(x^2)`` are the
    whole batch's, each data rank's averaged over the data group with their
    gradient, as GSPMD computes them. As flax 0.12's, it reduces and
    normalizes in float32 (or x's dtype where it is wider), then casts the
    output to ``dtype`` where one is given."""

    def __init__(self, features: int, epsilon: float = 1e-5, momentum: float = 0.99,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(axes)
            context = mesh_context()
            if context is None:
                var = torch.maximum(x.new_zeros(()), (x * x).mean(axes) - mean * mean)
            else:
                mean, mean_sq = context.data_mean(torch.stack([mean, (x * x).mean(axes)])).unbind(0)
                var = torch.maximum(x.new_zeros(()), mean_sq - mean * mean)
            if not _recomputing.get():
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (x - mean) * mul + self.bias
        return y if self.dtype is None else y.to(self.dtype)


def max_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID (an odd last row or column is dropped),
    on NHWC floats or int8 codes (the fused chains'): two elementwise
    maxima of strided views. ``F.max_pool2d`` has no int8 kernel on CUDA
    (it raises NotImplementedError for 'Char' on the H100); on floats the
    two maxima take the same device time as it in LeNet's forward. Where a
    gradient is taken it is ``F.max_pool2d``, whose gradient goes to the
    first maximum of a window, as JAX's does; the two maxima would split it
    over ties, and the sums of +-1 terms that feed LeNet's pools tie often."""
    if torch.is_grad_enabled() and x.requires_grad:
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = torch.maximum(x[:, 0:h:2], x[:, 1:h:2])
    return torch.maximum(x[:, :, 0:w:2], x[:, :, 1:w:2])


class BNNLeNet(nn.Module):
    """conv1 5x5 1->w, bn1, pool, conv2 5x5 w->2w (binary input), bn2, pool,
    fc1 16*2w->8w, bn3, head 8w->classes; no biases. ``quantized=False`` is
    the float32 twin (flax ``nn.Conv``/``nn.Dense`` layers, same names).
    ``act_scale=True`` (config ``bnn_lenet_as``) gives every binarized input
    its learnable per-channel scale: ``conv2``, ``fc1`` and ``head`` hold an
    ``act_scale`` and ``conv1``, which sees real pixels, none. ``dtype``: the
    compute dtype of every layer and BatchNorm."""

    def __init__(self, classes: int = 10, width: int = 32, quantized: bool = True,
                 act_scale: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        w = width

        def conv(cin, cout, binarize_input):
            if quantized:
                return BinConv(cin, cout, (5, 5), padding="VALID",
                               binarize_input=binarize_input, act_scale=act_scale,
                               use_bias=False, dtype=dtype)
            return Conv(cin, cout, (5, 5), padding="VALID", use_bias=False, dtype=dtype)

        def dense(fin, fout):
            if quantized:
                return LinearBin(fin, fout, binarize_input=True, act_scale=act_scale,
                                 use_bias=False, dtype=dtype)
            return Dense(fin, fout, use_bias=False, dtype=dtype)

        self.conv1 = conv(1, w, binarize_input=False)  # real-valued input
        self.bn1 = BatchNorm(w, dtype=dtype)
        self.conv2 = conv(w, 2 * w, binarize_input=True)
        self.bn2 = BatchNorm(2 * w, dtype=dtype)
        self.fc1 = dense(4 * 4 * 2 * w, 8 * w)
        self.bn3 = BatchNorm(8 * w, dtype=dtype)
        self.head = dense(8 * w, classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_nhwc(self.bn1(self.conv1(x)))
        x = max_pool_nhwc(self.bn2(self.conv2(x)))
        x = x.reshape(x.shape[0], -1)
        return self.head(self.bn3(self.fc1(x)))
