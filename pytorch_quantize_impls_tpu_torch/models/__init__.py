"""Model zoo; so far ``MLP`` and ``BinaryConnectMLP`` (BASELINE config 1),
``BNNLeNet`` (BASELINE config 2), ``XNORConvNet``
(BASELINE config 3), ``DorefaResNet20`` (BASELINE config 4),
``LogQuantVGGSmall`` (BASELINE config 5) and the quantized transformer LM
with its decode mode."""

from pytorch_quantize_impls_tpu_torch.models.convnets import (  # noqa: F401
    LogQuantVGGSmall,
    XNORConvNet,
)
from pytorch_quantize_impls_tpu_torch.models.lenet import BNNLeNet  # noqa: F401
from pytorch_quantize_impls_tpu_torch.models.mlp import MLP, BinaryConnectMLP  # noqa: F401
from pytorch_quantize_impls_tpu_torch.models.resnet import DorefaResNet20  # noqa: F401
from pytorch_quantize_impls_tpu_torch.models.transformer import (  # noqa: F401
    LayerNorm,
    QuantAttention,
    QuantTransformerBlock,
    QuantTransformerLM,
)
