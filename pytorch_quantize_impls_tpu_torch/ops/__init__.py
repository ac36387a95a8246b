"""Quantizer math core: STE quantizers as ``torch.autograd.Function``s, and
the grouped-planar bit packing (``ops.pack``)."""

from pytorch_quantize_impls_tpu_torch.ops.common import (  # noqa: F401
    flush_subnormal,
    safe_sign,
    ste,
)
from pytorch_quantize_impls_tpu_torch.ops.binary import (  # noqa: F401
    binary_connect_det,
    binary_tanh,
)
from pytorch_quantize_impls_tpu_torch.ops.dorefa import (  # noqa: F401
    dorefa_activation,
    dorefa_weight,
    quantize_k,
)
from pytorch_quantize_impls_tpu_torch.ops.log_lin import (  # noqa: F401
    lin_quant,
    log_quant,
    log_quant_exponent,
    log_quant_from_exponent,
)
from pytorch_quantize_impls_tpu_torch.ops.pact import pact  # noqa: F401
from pytorch_quantize_impls_tpu_torch.ops.kv_cache import (  # noqa: F401
    dequantize_kv,
    quantize_kv,
)
from pytorch_quantize_impls_tpu_torch.ops import pack  # noqa: F401
