"""Model zoo; so far ``BNNLeNet`` (BASELINE config 2)."""

from pytorch_quantize_impls_tpu_torch.models.lenet import BNNLeNet  # noqa: F401
