"""BinaryConnect / BNN layers.

Counterpart of ``pytorch_quantize_impls_tpu/nn/binary.py``: ``LinearBin`` and
``BinConv`` binarize the float32 master weight per forward, by sign
(``deterministic=True``) or stochastically (``deterministic=False``: a
fresh Bernoulli draw per training forward; at eval the clipped master
``clip(w, -1, 1)``, BinaryConnect §2.4); full-BNN mode
(``binarize_input=True``) also sign-binarizes the incoming activation with
the hard-tanh STE. Each wraps its ``QuantDense``/``QuantConv`` as a child
named ``dense``/``conv``, so module paths match the flax ones
(``("fc1", "dense")``).

Not ported yet: the learnable activation scale (``act_scale=True``, config
``bnn_lenet_as``) and ``ShiftNormBatch``.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple, Union

from torch import nn

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.nn.base import (
    QuantConv,
    QuantDense,
    clipped_master,
    stochastic,
)


def _no_act_scale(act_scale: bool) -> None:
    if act_scale:
        raise NotImplementedError(
            "act_scale (config bnn_lenet_as) is not ported yet (ROADMAP queue 1, item 4); "
            "the JAX package's pack/export paths drop it"
        )


def _binary_weight_quant(deterministic: bool, ste_mode: str):
    if deterministic:
        return partial(ops.binary_connect_det, ste_mode=ste_mode)
    # E[W_b] = 2 hard_sigmoid(w) - 1 = clip(w): the clipped master is the
    # ensemble-average network; evaluating with sign(w) is another net
    return stochastic(partial(ops.binary_connect_stoch, ste_mode=ste_mode), eval_fn=clipped_master)


class LinearBin(nn.Module):
    """Binary-weight dense layer; ``binarize_input=True`` is full-BNN mode,
    ``deterministic=False`` stochastic binarization."""

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
    ):
        super().__init__()
        _no_act_scale(act_scale)
        self.dense = QuantDense(
            in_features,
            features,
            weight_quant=_binary_weight_quant(deterministic, ste_mode),
            input_quant=ops.binary_tanh if binarize_input else None,
            use_bias=use_bias,
            scheme="binary",
            a_bits=1 if binarize_input else 0,
        )

    def forward(self, x):
        return self.dense(x)


class BinConv(nn.Module):
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
    ):
        super().__init__()
        _no_act_scale(act_scale)
        self.conv = QuantConv(
            in_channels,
            features,
            kernel_size,
            strides=strides,
            padding=padding,
            weight_quant=_binary_weight_quant(deterministic, ste_mode),
            input_quant=ops.binary_tanh if binarize_input else None,
            use_bias=use_bias,
            scheme="binary",
            a_bits=1 if binarize_input else 0,
        )

    def forward(self, x):
        return self.conv(x)
