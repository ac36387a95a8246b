"""Continuous-batching inference service, and autoregressive decode."""

from pytorch_quantize_impls_tpu_torch.serve.engine import (  # noqa: F401
    EngineStats,
    InferenceEngine,
)
from pytorch_quantize_impls_tpu_torch.serve.generate import (  # noqa: F401
    decode_model,
    generate,
    prefill,
)
from pytorch_quantize_impls_tpu_torch.serve.decode_engine import (  # noqa: F401
    DecodeEngine,
    DecodeStats,
)
