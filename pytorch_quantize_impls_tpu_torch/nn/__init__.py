"""Quantized layers as ``torch.nn.Module``s: fake-quant happens per forward
call from the float32 master weight; the packed path is ``infer``."""

from pytorch_quantize_impls_tpu_torch.nn.base import (  # noqa: F401
    Conv,
    Dense,
    QuantConv,
    QuantDense,
    collect_elastic_losses,
    current_generator,
    init_like_flax,
    intercept_quant_layers,
    quant_generator,
    sharded_step,
    stochastic,
)
from pytorch_quantize_impls_tpu_torch.nn.binary import (  # noqa: F401
    BinConv,
    LinearBin,
    ShiftNormBatch,
)
from pytorch_quantize_impls_tpu_torch.nn.dorefa import DorefaConv, LinearDorefa  # noqa: F401
from pytorch_quantize_impls_tpu_torch.nn.elastic import ElasticConv, ElasticLinear  # noqa: F401
from pytorch_quantize_impls_tpu_torch.nn.moe import QuantMoE  # noqa: F401
from pytorch_quantize_impls_tpu_torch.nn.log_lin import (  # noqa: F401
    ConvQuantLin,
    ConvQuantLog,
    LinearQuantLin,
    LinearQuantLog,
)
from pytorch_quantize_impls_tpu_torch.nn.pact import PACT  # noqa: F401
from pytorch_quantize_impls_tpu_torch.nn.ternary import (  # noqa: F401
    LinearTer,
    TerConv,
    ternary_spread_init,
)
from pytorch_quantize_impls_tpu_torch.nn.xnor import XNORConv, XNORLinear  # noqa: F401
