"""DoReFa layers: ``LinearDorefa`` and ``DorefaConv``.

Counterpart of ``pytorch_quantize_impls_tpu/nn/dorefa.py``. Weights are
DoReFa-quantized per forward from the float32 master; ``a_bits`` quantizes
the layer input. ``a_quant="fixed"`` is DoReFa's clip to [0, 1], applied
inside the ``QuantDense``/``QuantConv`` (metadata ``a_bits``, so the packed
path runs integer codes). ``a_quant="pact"`` puts a ``PACT`` child named
``act`` in front, with its learnable clip, and writes ``a_bits=0`` into the
metadata as the JAX package does: the packed path then treats the inputs as
real. Children are named as the flax ones (``conv``, ``dense``, ``act``).

Not ported yet: the gradient quantizer (``g_bits``), which acts in training.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple, Union

from torch import nn

from pytorch_quantize_impls_tpu_torch.nn.base import QuantConv, QuantDense
from pytorch_quantize_impls_tpu_torch.nn.pact import PACT
from pytorch_quantize_impls_tpu_torch.ops.dorefa import dorefa_activation, dorefa_weight

A_QUANTS = ("fixed", "pact")


def _quant_kwargs(bits: int, a_bits: Optional[int], a_quant: str):
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
    )
    return act, kw


class LinearDorefa(nn.Module):
    """Dense layer with DoReFa k-bit weights (and optional k-bit inputs)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        bits: int = 4,
        a_bits: Optional[int] = None,
        a_quant: str = "fixed",
        use_bias: bool = True,
    ):
        super().__init__()
        self.act, kw = _quant_kwargs(bits, a_bits, a_quant)
        self.dense = QuantDense(in_features, features, use_bias=use_bias, **kw)

    def forward(self, x):
        if self.act is not None:
            x = self.act(x)
        return self.dense(x)


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
        a_quant: str = "fixed",
        use_bias: bool = True,
    ):
        super().__init__()
        self.act, kw = _quant_kwargs(bits, a_bits, a_quant)
        self.conv = QuantConv(
            in_channels, features, kernel_size, strides=strides, padding=padding,
            use_bias=use_bias, **kw,
        )

    def forward(self, x):
        if self.act is not None:
            x = self.act(x)
        return self.conv(x)
