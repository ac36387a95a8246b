"""Run configs: the named configurations and the model each one builds.

Counterpart of ``pytorch_quantize_impls_tpu/utils/config.py``. Only
``bnn_lenet`` (BASELINE config 2) is ported; ``RunConfig`` holds the fields
its entry sets. The training fields (lr, batch size, mesh, checkpointing) and
the other configs arrive with their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device


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


def build_model(cfg: RunConfig, device="cuda"):
    """Config -> (model on ``device``, input_shape, dataset_name). The model
    is built on the card unless ``device="cpu"``; raises without a GPU."""
    from pytorch_quantize_impls_tpu_torch import models

    device = resolve_device(device)
    if cfg.config == "bnn_lenet":
        model = models.BNNLeNet(width=cfg.width or 32).to(device)
        return model, (28, 28, 1), "mnist"
    raise ValueError(
        f"config {cfg.config!r} is not ported; pick from {sorted(SCHEME_CONFIGS)}"
    )
