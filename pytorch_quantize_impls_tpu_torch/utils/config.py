"""Run configs: the named configurations and the model each one builds.

Counterpart of ``pytorch_quantize_impls_tpu/utils/config.py``. Only
``bnn_lenet`` (BASELINE config 2) is ported; ``RunConfig`` holds the fields
its entry sets. The training fields (lr, batch size, mesh, checkpointing) and
the other configs arrive with their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class RunConfig:
    config: str = "bnn_lenet"  # one of SCHEME_CONFIGS
    w_bits: int = 1
    a_bits: int = 0
    # model capacity (None = model default)
    width: Optional[int] = None
    steps: int = 2000


# BASELINE.json evaluation configs, as in the JAX package
SCHEME_CONFIGS = {
    "bnn_lenet": dict(config="bnn_lenet", w_bits=1, a_bits=1, width=128, steps=12000),
}


def build_model(cfg: RunConfig):
    """Config -> (model, input_shape, dataset_name)."""
    from pytorch_quantize_impls_tpu_torch import models

    if cfg.config == "bnn_lenet":
        return models.BNNLeNet(width=cfg.width or 32), (28, 28, 1), "mnist"
    raise ValueError(
        f"config {cfg.config!r} is not ported; pick from {sorted(SCHEME_CONFIGS)}"
    )
