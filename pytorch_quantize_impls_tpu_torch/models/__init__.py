"""Model zoo; so far ``BNNLeNet`` (BASELINE config 2), ``DorefaResNet20``
(BASELINE config 4), ``LogQuantVGGSmall`` (BASELINE config 5) and the
quantized transformer LM with its decode mode."""

from pytorch_quantize_impls_tpu_torch.models.convnets import LogQuantVGGSmall  # noqa: F401
from pytorch_quantize_impls_tpu_torch.models.lenet import BNNLeNet  # noqa: F401
from pytorch_quantize_impls_tpu_torch.models.resnet import DorefaResNet20  # noqa: F401
from pytorch_quantize_impls_tpu_torch.models.transformer import (  # noqa: F401
    LayerNorm,
    QuantAttention,
    QuantTransformerBlock,
    QuantTransformerLM,
)
