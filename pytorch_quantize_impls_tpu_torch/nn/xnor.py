"""XNOR-Net layers (arXiv:1603.05279).

Counterpart of ``pytorch_quantize_impls_tpu/nn/xnor.py``. Every forward
recomputes ``alpha_c = mean|W_c|`` from the float32 master weight, runs the
op on ``sign(W)`` (clipped STE) and scales the output by alpha
(``out_scale``, after the op and before the bias); ``binarize_input=True``
(full XNOR) also sign-binarizes the input with the hard-tanh STE, and
``XNORConv`` then multiplies its output by the input scale map K. K is
computed from the layer's real input outside the inner ``QuantConv``, so the
packed path (``infer.packed_apply``, which intercepts the ``QuantConv``)
keeps it; it is sliced ``[::s0, ::s1]`` at a stride > 1 and applied only
where padding is ``"SAME"``, as in the JAX package, at the output's dtype.
``dtype`` is the inner layer's compute dtype (``nn.base``). Children are
named as the flax ones (``dense``, ``conv``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch import ops
from pytorch_quantize_impls_tpu_torch.nn.base import QuantConv, QuantDense


class XNORLinear(nn.Module):
    """Dense layer with ``alpha_c sign(W)`` weights, alpha per out-feature."""

    def __init__(self, in_features: int, features: int, *, binarize_input: bool = False,
                 use_bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dense = QuantDense(
            in_features,
            features,
            weight_quant=ops.sign_ste_clip,
            input_quant=ops.binary_tanh if binarize_input else None,
            out_scale=ops.out_channel_alpha,
            use_bias=use_bias,
            scheme="xnor",
            a_bits=1 if binarize_input else 0,
            dtype=dtype,
        )

    def forward(self, x):
        return self.dense(x)


class XNORConv(nn.Module):
    """Conv layer (NHWC) with per-out-channel alpha; ``binarize_input=True``
    is full-XNOR mode, with the K input scale map unless
    ``use_input_scale_map=False``."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: Tuple[int, int] = (3, 3),
        *,
        strides: Tuple[int, int] = (1, 1),
        padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
        binarize_input: bool = False,
        use_input_scale_map: bool = True,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.k_map = binarize_input and use_input_scale_map
        self.conv = QuantConv(
            in_channels,
            features,
            kernel_size,
            strides=strides,
            padding=padding,
            weight_quant=ops.sign_ste_clip,
            input_quant=ops.binary_tanh if binarize_input else None,
            out_scale=ops.out_channel_alpha,
            use_bias=use_bias,
            scheme="xnor",
            a_bits=1 if binarize_input else 0,
            dtype=dtype,
        )

    def forward(self, x):
        k_map = None
        if self.k_map:
            k_map = ops.xnor_input_scale_map(x, self.kernel_size)
            if self.strides != (1, 1):
                k_map = k_map[:, :: self.strides[0], :: self.strides[1], :]
        y = self.conv(x)
        if k_map is not None and self.padding == "SAME":
            y = y * k_map.to(y.dtype)
        return y
