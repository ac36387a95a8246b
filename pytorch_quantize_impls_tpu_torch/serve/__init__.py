"""Continuous-batching inference service."""

from pytorch_quantize_impls_tpu_torch.serve.engine import (  # noqa: F401
    EngineStats,
    InferenceEngine,
)
