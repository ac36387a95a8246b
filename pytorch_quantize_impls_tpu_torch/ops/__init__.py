"""Quantizer math core: STE quantizers as ``torch.autograd.Function``s, the
grouped-planar bit packing (``ops.pack``) and the registry
(``get_quantizer``: a scheme name and its knobs -> a quantizer)."""

from pytorch_quantize_impls_tpu_torch.ops.common import (  # noqa: F401
    flush_subnormal,
    hard_sigmoid,
    round_ste,
    safe_sign,
    ste,
    ste_clip,
    ste_identity,
)
from pytorch_quantize_impls_tpu_torch.ops.binary import (  # noqa: F401
    binary_connect,
    binary_connect_det,
    binary_connect_stoch,
    binary_tanh,
)
from pytorch_quantize_impls_tpu_torch.ops.dorefa import (  # noqa: F401
    dorefa_activation,
    dorefa_grad_prim,
    dorefa_gradient,
    dorefa_quantizers,
    dorefa_weight,
    quantize_k,
)
from pytorch_quantize_impls_tpu_torch.ops.elastic import (  # noqa: F401
    binary_elastic_loss,
    elastic_loss,
    lin_elastic_loss,
    log_elastic_loss,
)
from pytorch_quantize_impls_tpu_torch.ops.log_lin import (  # noqa: F401
    lin_quant,
    log_quant,
    log_quant_exponent,
    log_quant_from_exponent,
)
from pytorch_quantize_impls_tpu_torch.ops.pact import pact, pact_alpha_penalty  # noqa: F401
from pytorch_quantize_impls_tpu_torch.ops.ternary import (  # noqa: F401
    ternary_connect,
    ternary_connect_det,
    ternary_connect_stoch,
)
from pytorch_quantize_impls_tpu_torch.ops.xnor import (  # noqa: F401
    out_channel_alpha,
    sign_ste_clip,
    xnor_alpha,
    xnor_input_scale_map,
    xnor_quantize,
)
from pytorch_quantize_impls_tpu_torch.ops.kv_cache import (  # noqa: F401
    dequantize_kv,
    quantize_kv,
)
from pytorch_quantize_impls_tpu_torch.ops.registry import (  # noqa: F401
    SCHEMES,
    STOCHASTIC_SCHEMES,
    get_quantizer,
)
from pytorch_quantize_impls_tpu_torch.ops import pack  # noqa: F401
