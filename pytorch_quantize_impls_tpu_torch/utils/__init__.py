"""Run configs, the bridge from the JAX package's variables, and the device
rule of the port's entry points."""

from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device  # noqa: F401
from pytorch_quantize_impls_tpu_torch.utils.bridge import (  # noqa: F401
    flax_paths,
    flax_state_dict,
    flax_variables,
    load_flax_variables,
)
from pytorch_quantize_impls_tpu_torch.utils.config import (  # noqa: F401
    SCHEME_CONFIGS,
    RunConfig,
    build_model,
)
