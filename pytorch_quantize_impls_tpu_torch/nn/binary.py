"""BinaryConnect / BNN layers and the BNN paper's shift-based BatchNorm.

Counterpart of ``pytorch_quantize_impls_tpu/nn/binary.py``: ``LinearBin`` and
``BinConv`` binarize the float32 master weight per forward, by sign
(``deterministic=True``) or stochastically (``deterministic=False``: a
fresh Bernoulli draw per training forward; at eval the clipped master
``clip(w, -1, 1)``, BinaryConnect §2.4); full-BNN mode
(``binarize_input=True``) also sign-binarizes the incoming activation with
the hard-tanh STE. Each wraps its ``QuantDense``/``QuantConv`` as a child
named ``dense``/``conv``, so module paths match the flax ones
(``("fc1", "dense")``).

``act_scale=True`` with ``binarize_input=True`` adds a learnable
per-input-channel scale ``g`` (init 1) on the binarized input, which becomes
``binary_tanh(x) * g``. It lives on the wrapper as ``act_scale``, as the flax
parameter ``("fc1", "act_scale")`` does; without ``binarize_input`` no scale
is made, as in the JAX package. The packed paths refuse such a layer
(``infer.pack_model``): the JAX package's pack and export drop g. ``dtype``
is the inner layer's compute dtype (``nn.base``); g is cast to the
activation's dtype.

``ShiftNormBatch`` is the BNN paper's shift-based BatchNorm (§2.3): the
scale ``gamma * rsqrt(var + eps)`` is rounded to the nearest power of two,
with an identity STE. Under a sharded step its batch mean and variance are
the whole batch's (each data rank's averaged over the data group).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.nn.base import (
    QuantConv,
    QuantDense,
    clipped_master,
    mesh_context,
    stochastic,
)


def _binary_weight_quant(deterministic: bool, ste_mode: str):
    if deterministic:
        return partial(ops.binary_connect_det, ste_mode=ste_mode)
    # E[W_b] = 2 hard_sigmoid(w) - 1 = clip(w): the clipped master is the
    # ensemble-average network; evaluating with sign(w) is another net
    return stochastic(partial(ops.binary_connect_stoch, ste_mode=ste_mode), eval_fn=clipped_master)


class _BinaryWrapper(nn.Module):
    """The input binarizer of ``LinearBin`` and ``BinConv``."""

    def _input_quant(self, channels: int, binarize_input: bool, act_scale: bool):
        """The inner layer's input quantizer: None, ``binary_tanh``, or, with
        ``act_scale``, this module's bound :meth:`_scaled_binarize` (a bound
        method, so a deep copy of the model scales by the copy's g)."""
        self.act_scale = None
        if not binarize_input:
            return None
        if not act_scale:
            return ops.binary_tanh
        self.act_scale = nn.Parameter(torch.ones(channels))
        return self._scaled_binarize

    def _scaled_binarize(self, x: torch.Tensor) -> torch.Tensor:
        return ops.binary_tanh(x) * self.act_scale.to(x.dtype)


class LinearBin(_BinaryWrapper):
    """Binary-weight dense layer; ``binarize_input=True`` is full-BNN mode
    (with ``act_scale``, its learnable input scale), ``deterministic=False``
    stochastic binarization."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        deterministic: bool = True,
        binarize_input: bool = False,
        act_scale: bool = False,
        ste_mode: str = "clip",
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        input_quant = self._input_quant(in_features, binarize_input, act_scale)
        self.dense = QuantDense(
            in_features,
            features,
            weight_quant=_binary_weight_quant(deterministic, ste_mode),
            input_quant=input_quant,
            use_bias=use_bias,
            scheme="binary",
            a_bits=1 if binarize_input else 0,
            act_scale=self.act_scale is not None,
            dtype=dtype,
        )

    def forward(self, x):
        return self.dense(x)


class BinConv(_BinaryWrapper):
    """Binary-weight conv layer (NHWC)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        deterministic: bool = True,
        binarize_input: bool = False,
        act_scale: bool = False,
        ste_mode: str = "clip",
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        input_quant = self._input_quant(in_channels, binarize_input, act_scale)
        self.conv = QuantConv(
            in_channels,
            features,
            kernel_size,
            strides=strides,
            padding=padding,
            weight_quant=_binary_weight_quant(deterministic, ste_mode),
            input_quant=input_quant,
            use_bias=use_bias,
            scheme="binary",
            a_bits=1 if binarize_input else 0,
            act_scale=self.act_scale is not None,
            dtype=dtype,
        )

    def forward(self, x):
        return self.conv(x)


def _ap2(s: torch.Tensor) -> torch.Tensor:
    """The nearest power of two, ``sign(s) 2^round(log2|s|)`` (0 at 0)."""
    mag = s.abs()
    e = torch.round(torch.log2(torch.where(mag == 0, torch.full_like(mag, 1e-30), mag)))
    return torch.sign(s) * torch.exp2(e)


_ap2_ste = ops.ste_identity(_ap2)


class ShiftNormBatch(nn.Module):
    """BatchNorm over every axis but the last whose scale
    ``gamma * rsqrt(var + eps)`` is rounded to a power of two (AP2, identity
    STE), so inference multiplies become shifts. In training it normalizes
    by the batch mean and biased variance and moves the running statistics
    as ``momentum * running + (1 - momentum) * batch`` (momentum 0.9, not
    BatchNorm's 0.99); in eval it reads them. State names as the port's
    BatchNorm (``weight``, ``bias``, ``running_mean``, ``running_var``), so
    ``utils.bridge`` maps them to flax's ``scale``, ``bias``, ``mean``,
    ``var``."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.ndim - 1))
            context = mesh_context()
            mean = x.mean(axes)
            if context is not None:
                mean = context.data_mean(mean)
            var = ((x - mean) ** 2).mean(axes)  # jnp.var: biased
            if context is not None:
                var = context.data_mean(var)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.epsilon)
        return (x - mean) * _ap2_ste(scale) + self.bias
