"""Run configs, the bridge from the JAX package's variables, the device
rule of the port's entry points, checkpoints, metrics, profiling and the
host codec (``utils.native``)."""

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
from pytorch_quantize_impls_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: F401
from pytorch_quantize_impls_tpu_torch.utils.metrics import MetricsWriter  # noqa: F401
from pytorch_quantize_impls_tpu_torch.utils.profiling import StepTimer, trace  # noqa: F401
from pytorch_quantize_impls_tpu_torch.utils import native  # noqa: F401
