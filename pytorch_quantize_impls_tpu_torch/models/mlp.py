"""MLPs for MNIST (BASELINE config 1: 784-512-512-10).

Counterpart of ``pytorch_quantize_impls_tpu/models/mlp.py``. ``MLP`` is
[Dense -> BatchNorm -> ReLU]* -> Dense over the flattened input, each
Dense of the chosen kind; ``BinaryConnectMLP`` binarizes the weights only
(BinaryConnect, arXiv:1511.00363), and its ``quantized=False`` twin is the
float32 net of the Δ-accuracy runs. Module names match the flax ones:
``layer{i}.dense``, ``bn{i}``, ``head.dense`` (``layer{i}`` and ``head`` in
the float32 twin and the elastic MLP, whose ``ElasticLinear`` holds its
weight itself). ``g_bits`` is DoReFa's gradient quantizer (W{bits}A{a_bits}
G{g_bits}), which draws from the train step's generator in training;
``elastic_grid`` is the elastic layers' grid. ``dtype`` is the compute
dtype of every layer and BatchNorm (float32 masters), as in the JAX model.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch import nn as qnn
from pytorch_quantize_impls_tpu_torch.models.lenet import BatchNorm

# a stochastically re-drawn head emits noise logits of std ~sqrt(fan_in)
# that swamp the loss, so a stochastic body gets the deterministic head
_DETERMINISTIC_HEAD = {"bin_stoch": "bin", "ternary_stoch": "ternary"}


class MLP(nn.Module):
    """Generic quantized MLP. ``layer``: bin | bin_stoch | ternary |
    ternary_stoch | dorefa | log | lin | elastic | fp32; ``head_layer`` None
    takes ``layer`` (a stochastic one its deterministic twin)."""

    def __init__(
        self,
        in_features: int,
        features: Sequence[int] = (512, 512, 10),
        *,
        layer: str = "bin",
        bits: int = 4,
        a_bits: int = 0,
        g_bits: int = 0,
        a_quant: str = "fixed",
        fsr: float = 1.0,
        elastic_grid: str = "binary",
        use_batchnorm: bool = True,
        head_layer: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.bits, self.a_bits, self.g_bits, self.a_quant = bits, a_bits, g_bits, a_quant
        self.fsr, self.elastic_grid, self.dtype = fsr, elastic_grid, dtype
        self.layer = layer
        fin = in_features
        self.hidden = len(features) - 1
        for i, f in enumerate(features[:-1]):
            setattr(self, f"layer{i}", self._dense(layer, fin, f))
            if use_batchnorm:
                setattr(self, f"bn{i}", BatchNorm(f, dtype=dtype))
            fin = f
        self.use_batchnorm = use_batchnorm
        head = head_layer or _DETERMINISTIC_HEAD.get(layer, layer)
        self.head = self._dense(head, fin, features[-1])

    def _dense(self, kind: str, fin: int, f: int) -> nn.Module:
        dt = dict(dtype=self.dtype)
        if kind in ("bin", "bin_stoch"):
            return qnn.LinearBin(fin, f, deterministic=kind == "bin", **dt)
        if kind in ("ternary", "ternary_stoch"):
            return qnn.LinearTer(fin, f, deterministic=kind == "ternary", **dt)
        if kind == "dorefa":
            return qnn.LinearDorefa(fin, f, bits=self.bits, a_bits=self.a_bits or None,
                                    g_bits=self.g_bits or None, a_quant=self.a_quant, **dt)
        if kind == "elastic":
            return qnn.ElasticLinear(fin, f, grid=self.elastic_grid, fsr=self.fsr, bits=self.bits,
                                     **dt)
        if kind == "log":
            return qnn.LinearQuantLog(fin, f, fsr=self.fsr, bits=self.bits, **dt)
        if kind == "lin":
            return qnn.LinearQuantLin(fin, f, fsr=self.fsr, bits=self.bits, **dt)
        if kind == "fp32":
            return qnn.Dense(fin, f, **dt)
        raise ValueError(f"unknown layer kind {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.hidden):
            x = getattr(self, f"layer{i}")(x)
            if self.use_batchnorm:
                x = getattr(self, f"bn{i}")(x)
            x = torch.relu(x)
        return self.head(x)


def BinaryConnectMLP(
    in_features: int = 28 * 28, hidden: int = 512, classes: int = 10, *,
    deterministic: bool = True, quantized: bool = True, dtype: Optional[torch.dtype] = None,
) -> MLP:
    """BASELINE config 1: the BinaryConnect MLP 784-512-512-10; ``dtype`` is
    the returned ``MLP``'s compute dtype."""
    kind = "fp32" if not quantized else ("bin" if deterministic else "bin_stoch")
    return MLP(in_features, (hidden, hidden, classes), layer=kind, dtype=dtype)
