"""Training: STE fake-quant steps with Adam and clamp-after-step.

Counterpart of ``pytorch_quantize_impls_tpu/train``: ``clip_quantized_weights``
(the clamp after each optimizer step), ``QuantTrainState`` (model, optimizer,
clamp, step and the step's generator), ``make_train_step`` /
``make_eval_step``, and ``QuantizedAdam``, the 8-bit log-coded Adam
(``create_for(model, optimizer=QuantizedAdam(model.parameters(), lr=...))``).
``python -m pytorch_quantize_impls_tpu_torch.train.run`` trains a named
config, with checkpoints and resume, a metrics stream and a profile;
``python -m pytorch_quantize_impls_tpu_torch.train.accuracy_sweep`` trains a
config's float32 twin and its quantized model (warm-started from the twin
where the config says so) and reports the accuracy gap. Not ported yet:
the sharded train and eval steps (ROADMAP queue 1, item 6 (b2)).
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
from pytorch_quantize_impls_tpu_torch.train.quantized_optim import (  # noqa: F401
    QuantizedAdam,
    optimizer_state_bytes,
)
