"""Training: STE fake-quant steps with Adam and clamp-after-step.

Counterpart of ``pytorch_quantize_impls_tpu/train``: ``clip_quantized_weights``
(the clamp after each optimizer step), ``QuantTrainState`` (model, Adam,
clamp, step and the step's generator) and ``make_train_step`` /
``make_eval_step``. ``python -m pytorch_quantize_impls_tpu_torch.train.run``
trains a named config; ``python -m
pytorch_quantize_impls_tpu_torch.train.accuracy_sweep`` trains a config's
float32 twin and its quantized model (warm-started from the twin where the
config says so) and reports the accuracy gap. Not ported yet: the 8-bit
Adam (ROADMAP queue 1, item 5) and the sharded steps (item 6).
"""

from pytorch_quantize_impls_tpu_torch.train.clipping import (  # noqa: F401
    clip_params,
    clip_quantized_weights,
    default_clip_filter,
)
from pytorch_quantize_impls_tpu_torch.train.state import (  # noqa: F401
    QuantTrainState,
    cosine_decay_schedule,
)
from pytorch_quantize_impls_tpu_torch.train.steps import (  # noqa: F401
    cross_entropy,
    make_eval_step,
    make_train_step,
)
