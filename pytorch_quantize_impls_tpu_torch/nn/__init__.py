"""Quantized layers as ``torch.nn.Module``s: fake-quant happens per forward
call from the float32 master weight; the packed path is ``infer``."""

from pytorch_quantize_impls_tpu_torch.nn.base import (  # noqa: F401
    QuantConv,
    QuantDense,
    intercept_quant_layers,
)
from pytorch_quantize_impls_tpu_torch.nn.binary import BinConv, LinearBin  # noqa: F401
from pytorch_quantize_impls_tpu_torch.nn.dorefa import DorefaConv, LinearDorefa  # noqa: F401
from pytorch_quantize_impls_tpu_torch.nn.log_lin import (  # noqa: F401
    ConvQuantLin,
    ConvQuantLog,
    LinearQuantLin,
    LinearQuantLog,
)
from pytorch_quantize_impls_tpu_torch.nn.pact import PACT  # noqa: F401
