"""Run configs: the named configurations and the model each one builds.

Counterpart of ``pytorch_quantize_impls_tpu/utils/config.py``. Ported:
``bnn_lenet`` (BASELINE config 2), ``xnor_cifar`` (BASELINE config 3, the
full-XNOR convnet with the K map), ``dorefa_resnet20`` (BASELINE config 4,
W4A4 with PACT), ``dorefa_resnet20_w4`` (weights only) and ``logquant_vgg``
(BASELINE config 5, W4 log weights). ``RunConfig``
holds the fields their entries set; the training fields (lr, batch size,
mesh, checkpointing, warm start, elastic weight) and the other configs
arrive with their ROADMAP items.
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
    # activation quantizer of the DoReFa configs: "fixed" clip [0, 1] or
    # "pact" learnable per-layer clip (arXiv:1805.06085)
    a_quant: str = "fixed"
    # log/lin full-scale range: levels up to 2^fsr
    fsr: float = 1.0
    # model capacity (None = model default)
    width: Optional[int] = None
    steps: int = 2000


# BASELINE.json evaluation configs, as in the JAX package
SCHEME_CONFIGS = {
    "bnn_lenet": dict(config="bnn_lenet", w_bits=1, a_bits=1, width=128, steps=12000),
    "xnor_cifar": dict(config="xnor_cifar", w_bits=1, a_bits=1, steps=12000),
    "dorefa_resnet20": dict(config="dorefa_resnet20", w_bits=4, a_bits=4, a_quant="pact",
                            steps=6000),
    "dorefa_resnet20_w4": dict(config="dorefa_resnet20_w4", w_bits=4, a_bits=0),
    "logquant_vgg": dict(config="logquant_vgg", w_bits=4, fsr=1.0),
}


def build_model(cfg: RunConfig, device="cuda"):
    """Config -> (model on ``device``, input_shape, dataset_name). The model
    is built on the card unless ``device="cpu"``; raises without a GPU."""
    from pytorch_quantize_impls_tpu_torch import models

    device = resolve_device(device)
    if cfg.config == "bnn_lenet":
        model = models.BNNLeNet(width=cfg.width or 32).to(device)
        return model, (28, 28, 1), "mnist"
    if cfg.config == "xnor_cifar":
        return models.XNORConvNet().to(device), (32, 32, 3), "cifar10"
    if cfg.config in ("dorefa_resnet20", "dorefa_resnet20_w4"):
        a_bits = cfg.a_bits if cfg.config == "dorefa_resnet20" else 0
        model = models.DorefaResNet20(
            w_bits=cfg.w_bits, a_bits=a_bits, a_quant=cfg.a_quant, width=cfg.width or 16
        ).to(device)
        return model, (32, 32, 3), "cifar10"
    if cfg.config == "logquant_vgg":
        model = models.LogQuantVGGSmall(bits=cfg.w_bits, fsr=cfg.fsr).to(device)
        return model, (32, 32, 3), "cifar10"
    raise ValueError(
        f"config {cfg.config!r} is not ported; pick from {sorted(SCHEME_CONFIGS)}"
    )
