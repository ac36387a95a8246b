"""Elastic-quantization layers: ``ElasticLinear`` and ``ElasticConv``.

Counterpart of ``pytorch_quantize_impls_tpu/nn/elastic.py``: float32 layers
whose weight carries a grid penalty (``ops.elastic``) for the training loss,
in place of a quantizer in the forward. The JAX layers sow the penalty into
the ``losses`` collection; here ``penalty()`` returns it, and
``nn.collect_elastic_losses`` sums it into the loss the train step weighs
(``make_train_step(elastic_weight=)``). The weights are drawn by
``glorot_normal`` (``init_like_flax``), as flax's layers draw theirs, and sit
directly in the layer (flax path ``['layer0']['kernel']``, no ``dense``
child), so the clamp after each step clips them as the JAX package's does.
``ElasticConv`` pads as JAX does (``kernels.conv.conv_pads``). A column
shard's penalty (``nn.base.sharded_step``) is the whole kernel's, its mean
over the model group. Grids:
``"binary"`` (+-1), ``"lin"`` and ``"log"`` (FSR grids). ``dtype`` is the
compute dtype (``nn.base``): with bf16 the output stays bf16, the bias cast
to it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from pytorch_quantize_impls_tpu_torch.nn.base import QuantConv, QuantDense, column_context
from pytorch_quantize_impls_tpu_torch.ops.elastic import elastic_loss

GRIDS = ("binary", "lin", "log")


def _check_grid(grid: str) -> None:
    if grid not in GRIDS:
        raise ValueError(f"unknown elastic grid {grid!r}")


def _penalty(layer) -> torch.Tensor:
    p = elastic_loss(layer.grid, layer.weight, fsr=layer.grid_fsr, bits=layer.grid_bits)
    tp = column_context(layer)
    return p if tp is None else tp.penalty_mean(p)


class ElasticLinear(QuantDense):
    """Float32 dense layer with a grid penalty on its weight."""

    def __init__(self, in_features: int, features: int, *, grid: str = "binary",
                 fsr: float = 0.0, bits: int = 4, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        _check_grid(grid)
        super().__init__(in_features, features, use_bias=use_bias, dtype=dtype)
        self.grid, self.grid_fsr, self.grid_bits = grid, fsr, bits

    def penalty(self) -> torch.Tensor:
        return _penalty(self)


class ElasticConv(QuantConv):
    """Float32 NHWC conv with a grid penalty on its weight."""

    def __init__(self, in_channels: int, features: int, kernel_size: Tuple[int, int] = (3, 3),
                 *, strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME", grid: str = "binary",
                 fsr: float = 0.0, bits: int = 4, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        _check_grid(grid)
        super().__init__(in_channels, features, kernel_size, strides=strides, padding=padding,
                         use_bias=use_bias, dtype=dtype)
        self.grid, self.grid_fsr, self.grid_bits = grid, fsr, bits

    def penalty(self) -> torch.Tensor:
        return _penalty(self)
