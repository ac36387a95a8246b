"""TernaryConnect layers: the binary-layer pattern over the {-1, 0, +1}
quantizer.

Counterpart of ``pytorch_quantize_impls_tpu/nn/ternary.py``: ``LinearTer``
and ``TerConv`` (``scheme="ternary"``, ``w_bits=2``, children ``dense`` and
``conv`` as in flax) with the uniform(-1, 1) master init of
:func:`ternary_spread_init`. ``deterministic=False`` draws the stochastic
ternarization per training forward and evaluates with the clipped master
``clip(w, -1, 1)`` (E[T(w)] = clip(w)), as stochastic BinaryConnect does.
``dtype`` is the inner layer's compute dtype (``nn.base``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.nn.base import (
    QuantConv,
    QuantDense,
    clipped_master,
    stochastic,
)


def ternary_spread_init(weight: torch.Tensor,
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``weight`` with uniform(-1, 1) in place: TernaryConnect's weight
    domain, so masters straddle the +-0.5 thresholds from the start (a
    fan-in-scaled init puts every weight in the dead zone |w| < 0.5 and the
    whole net quantizes to 0). Draws from ``generator`` where given."""
    with torch.no_grad():
        return weight.uniform_(-1.0, 1.0, generator=generator)


def _ternary_quant(deterministic: bool):
    if deterministic:
        return ops.ternary_connect_det
    return stochastic(ops.ternary_connect_stoch, eval_fn=clipped_master)


class LinearTer(nn.Module):
    def __init__(self, in_features: int, features: int, *, deterministic: bool = True,
                 use_bias: bool = True, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = QuantDense(
            in_features, features, weight_quant=_ternary_quant(deterministic),
            use_bias=use_bias, scheme="ternary", w_bits=2, dtype=dtype,
        )
        self.dense.kernel_init = "uniform"
        ternary_spread_init(self.dense.weight, generator)

    def forward(self, x):
        return self.dense(x)


class TerConv(nn.Module):
    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        deterministic: bool = True,
        use_bias: bool = True,
        generator: Optional[torch.Generator] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.conv = QuantConv(
            in_channels, features, kernel_size, strides=strides, padding=padding,
            weight_quant=_ternary_quant(deterministic), use_bias=use_bias,
            scheme="ternary", w_bits=2, dtype=dtype,
        )
        self.conv.kernel_init = "uniform"
        ternary_spread_init(self.conv.weight, generator)

    def forward(self, x):
        return self.conv(x)
