"""DoReFa layers: ``LinearDorefa`` and ``DorefaConv``.

Counterpart of ``pytorch_quantize_impls_tpu/nn/dorefa.py``. Weights are
DoReFa-quantized per forward from the float32 master; ``a_bits`` quantizes
the layer input. ``a_quant="fixed"`` is DoReFa's clip to [0, 1], applied
inside the ``QuantDense``/``QuantConv`` (metadata ``a_bits``, so the packed
path runs integer codes). ``a_quant="pact"`` puts a ``PACT`` child named
``act`` in front, with its learnable clip, and writes ``a_bits=0`` into the
metadata as the JAX package does: the packed path then treats the inputs as
real. Children are named as the flax ones (``conv``, ``dense``, ``act``).

``g_bits`` quantizes the gradient of the layer's input (paper eq. 12,
``ops.dorefa_gradient``) in training mode only, before PACT or the input
quantizer, drawing its noise from the train step's generator
(``nn.base.current_generator``; outside a train step it raises). In eval
mode it draws nothing. Under a sharded step it draws the whole batch's
noise and keeps this data rank's rows (``nn.base.batch_generator``), and
its ``max|g|`` is the whole batch's (``MeshContext.data_max``). ``dtype``
is the inner layer's compute dtype (``nn.base``); PACT computes at float32
or wider, as in the JAX package.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.nn.base import (
    QuantConv,
    QuantDense,
    batch_generator,
    mesh_context,
)
from pytorch_quantize_impls_tpu_torch.nn.pact import PACT
from pytorch_quantize_impls_tpu_torch.ops.dorefa import (
    dorefa_activation,
    dorefa_gradient,
    dorefa_weight,
)

A_QUANTS = ("fixed", "pact")


def _quant_kwargs(bits: int, a_bits: Optional[int], a_quant: str, dtype):
    """(PACT child or None, the Quant layer's quantizers and metadata)."""
    if a_quant not in A_QUANTS:
        raise ValueError(f"a_quant must be one of {A_QUANTS}, got {a_quant!r}")
    pact_input = bool(a_bits) and a_quant == "pact"
    act = PACT(bits=a_bits) if pact_input else None
    kw = dict(
        weight_quant=partial(dorefa_weight, bits=bits),
        input_quant=(
            partial(dorefa_activation, bits=a_bits) if a_bits and not pact_input else None
        ),
        scheme="dorefa",
        w_bits=bits,
        a_bits=0 if pact_input else (a_bits or 0),
        dtype=dtype,
    )
    return act, kw


def _input_path(layer: nn.Module, x):
    """The gradient quantizer (training only), then PACT where there is one."""
    if layer.g_bits and layer.training:
        context = mesh_context()
        x = dorefa_gradient(x, batch_generator(x), layer.g_bits,
                            max_over=None if context is None else context.data_max)
    return layer.act(x) if layer.act is not None else x


class LinearDorefa(nn.Module):
    """Dense layer with DoReFa k-bit weights (and optional k-bit inputs)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        bits: int = 4,
        a_bits: Optional[int] = None,
        g_bits: Optional[int] = None,
        a_quant: str = "fixed",
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.g_bits = g_bits
        self.act, kw = _quant_kwargs(bits, a_bits, a_quant, dtype)
        self.dense = QuantDense(in_features, features, use_bias=use_bias, **kw)

    def forward(self, x):
        return self.dense(_input_path(self, x))


class DorefaConv(nn.Module):
    """Conv layer (NHWC) with DoReFa k-bit weights (and optional k-bit inputs)."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        bits: int = 4,
        a_bits: Optional[int] = None,
        g_bits: Optional[int] = None,
        a_quant: str = "fixed",
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.g_bits = g_bits
        self.act, kw = _quant_kwargs(bits, a_bits, a_quant, dtype)
        self.conv = QuantConv(
            in_channels, features, kernel_size, strides=strides, padding=padding,
            use_bias=use_bias, **kw,
        )

    def forward(self, x):
        return self.conv(_input_path(self, x))
