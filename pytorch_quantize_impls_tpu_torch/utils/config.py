"""Run configs: the named configurations and the model each one builds.

Counterpart of ``pytorch_quantize_impls_tpu/utils/config.py``: all fifteen
of its entries, with their values, each with its float32 twin
(``fp32=True``): ``binaryconnect_mlp`` (BASELINE config 1), ``bnn_lenet``
(BASELINE config 2) and ``bnn_lenet_as`` (with the learnable activation
scale), ``xnor_cifar`` (BASELINE config 3), ``dorefa_resnet20`` (BASELINE
config 4, W4A4 with PACT and its alpha penalty), ``dorefa_resnet20_w4``,
``logquant_vgg`` (BASELINE config 5), the digits MLPs
``binaryconnect_digits(_stoch)``, ``ternary_digits(_stoch)``,
``elastic_digits`` (the binary grid's penalty under a ramped weight, hard
projected after training by ``train.accuracy_sweep.project_elastic``) and
``dorefa_digits_g6`` (DoReFa W1A2G6), and the XNOR digits convnets
``xnor_digits`` (binary-weight mode, widths 32, 64) and ``xnor_digits_a1``
(full XNOR, widths 128, 128) on 8x8x1 images.
``RunConfig`` holds the fields their entries set and the training fields the
port reads: batch size, lr, seed, the data directory, the elastic weight and
its ramp (``train.accuracy_sweep``), ``warm_start``, the QAT warm start
from the trained twin that ``train.accuracy_sweep`` applies, and the io
fields ``train.run`` reads (checkpoint directory, metrics file), and the
JAX config's ``mesh_shape``, the ``(data, model)`` mesh that ``train.run
--mesh`` sets and trains over. The JAX config's ``profile_dir``,
which nothing reads there, is left out (a trace is ``utils.trace``). Neither package's config has a compute dtype: it is the
models' ``dtype`` argument."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from pytorch_quantize_impls_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class RunConfig:
    config: str = "bnn_lenet"  # one of SCHEME_CONFIGS
    deterministic: bool = True  # det vs stoch quantization
    w_bits: int = 1
    a_bits: int = 0
    # DoReFa gradient quantization bits (0 = off), paper eq. 12
    g_bits: int = 0
    # activation quantizer of the DoReFa configs: "fixed" clip [0, 1] or
    # "pact" learnable per-layer clip (arXiv:1805.06085)
    a_quant: str = "fixed"
    # QAT warm start from the trained fp32 twin (train.accuracy_sweep)
    warm_start: bool = False
    # log/lin full-scale range: levels up to 2^fsr
    fsr: float = 1.0
    # model capacity (None = model default)
    width: Optional[int] = None
    # training
    batch_size: int = 128
    steps: int = 2000
    lr: float = 3e-3
    # weight of the model's training penalties (PACT's alpha L2) in the loss
    elastic_weight: float = 0.0
    # ramp the weight 0 -> elastic_weight over the first 60% of the run
    elastic_ramp: bool = False
    seed: int = 0
    # (data, model) ranks of the run's mesh; None: every rank on data
    mesh_shape: Optional[Tuple[int, int]] = None
    # io
    checkpoint_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    data_dir: Optional[str] = None  # the data loaders'; overrides $QTPU_DATA_DIR


def _mk(config, **kw):
    return dict(config=config, **kw)


# BASELINE.json evaluation configs and the digits MLPs, as in the JAX package
SCHEME_CONFIGS = {
    "binaryconnect_mlp": _mk("binaryconnect_mlp", w_bits=1, steps=6000, warm_start=True),
    "bnn_lenet": _mk("bnn_lenet", w_bits=1, a_bits=1, width=128, steps=12000),
    # bnn_lenet with a learnable per-input-channel scale on every binarized
    # activation (the JAX package's ablation config)
    "bnn_lenet_as": _mk("bnn_lenet_as", w_bits=1, a_bits=1, width=128, steps=12000),
    "xnor_cifar": _mk("xnor_cifar", w_bits=1, a_bits=1, steps=12000, warm_start=True),
    "dorefa_resnet20": _mk("dorefa_resnet20", w_bits=4, a_bits=4, a_quant="pact",
                           warm_start=True, elastic_weight=2e-4, steps=6000),
    "dorefa_resnet20_w4": _mk("dorefa_resnet20_w4", w_bits=4, a_bits=0),
    "logquant_vgg": _mk("logquant_vgg", w_bits=4, fsr=1.0),
    "binaryconnect_digits": _mk("binaryconnect_digits", w_bits=1, batch_size=64, steps=1600),
    # the XNOR conv on the 8x8 digits: binary-weight (BWN) mode, and full
    # XNOR (binarized activations) at widths (128, 128)
    "xnor_digits": _mk("xnor_digits", w_bits=1, a_bits=0, batch_size=64, steps=1600),
    "xnor_digits_a1": _mk("xnor_digits_a1", w_bits=1, a_bits=1, batch_size=64, steps=1600),
    "binaryconnect_digits_stoch": _mk("binaryconnect_digits_stoch", w_bits=1,
                                      deterministic=False, batch_size=64, steps=4800, lr=2e-2),
    "ternary_digits": _mk("ternary_digits", w_bits=2, batch_size=64, steps=3200),
    "ternary_digits_stoch": _mk("ternary_digits_stoch", w_bits=2, deterministic=False,
                                batch_size=64, steps=3200),
    # the binary grid's penalty, lambda ramped 0 -> 100 over 60% of the run
    "elastic_digits": _mk("elastic_digits", w_bits=1, elastic_weight=100.0, elastic_ramp=True,
                          batch_size=64, steps=3200),
    # DoReFa W1A2G6 (arXiv:1606.06160 table 2's headline config)
    "dorefa_digits_g6": _mk("dorefa_digits_g6", w_bits=1, a_bits=2, g_bits=6,
                            deterministic=False, batch_size=64, steps=1600),
}


def _build(cfg: RunConfig, fp32: bool):
    from pytorch_quantize_impls_tpu_torch import models

    q = not fp32
    if cfg.config == "binaryconnect_mlp":
        return models.BinaryConnectMLP(28 * 28, deterministic=cfg.deterministic,
                                       quantized=q), (28 * 28,), "mnist"
    if cfg.config in ("binaryconnect_digits", "binaryconnect_digits_stoch"):
        det = cfg.deterministic and cfg.config == "binaryconnect_digits"
        return models.BinaryConnectMLP(8 * 8, 512, deterministic=det,
                                       quantized=q), (8 * 8,), "digits"
    if cfg.config in ("ternary_digits", "ternary_digits_stoch"):
        kind = "fp32" if fp32 else ("ternary" if cfg.deterministic else "ternary_stoch")
        return models.MLP(8 * 8, (512, 512, 10), layer=kind), (8 * 8,), "digits"
    if cfg.config == "elastic_digits":
        kind = "fp32" if fp32 else "elastic"
        return (models.MLP(8 * 8, (512, 512, 10), layer=kind, elastic_grid="binary"), (8 * 8,),
                "digits")
    if cfg.config == "dorefa_digits_g6":
        model = models.MLP(8 * 8, (512, 512, 10), layer="fp32" if fp32 else "dorefa",
                           bits=cfg.w_bits, a_bits=cfg.a_bits, g_bits=cfg.g_bits,
                           a_quant=cfg.a_quant)
        return model, (8 * 8,), "digits"
    if cfg.config in ("xnor_digits", "xnor_digits_a1"):
        if cfg.config == "xnor_digits":
            widths, binarize = (32, 64), cfg.a_bits >= 1
        else:
            widths, binarize = (cfg.width or 128,) * 2, True
        model = models.XNORConvNet(widths=widths, quantized=q, binarize_inputs=binarize,
                                   fp32_first_last=True, image_shape=(8, 8, 1))
        return model, (8, 8, 1), "digits"
    if cfg.config in ("bnn_lenet", "bnn_lenet_as"):
        return (models.BNNLeNet(width=cfg.width or 32, quantized=q,
                                act_scale=cfg.config.endswith("_as")), (28, 28, 1), "mnist")
    if cfg.config == "xnor_cifar":
        return models.XNORConvNet(quantized=q), (32, 32, 3), "cifar10"
    if cfg.config in ("dorefa_resnet20", "dorefa_resnet20_w4"):
        a_bits = cfg.a_bits if cfg.config == "dorefa_resnet20" else 0
        model = models.DorefaResNet20(
            w_bits=cfg.w_bits, a_bits=a_bits, a_quant=cfg.a_quant, width=cfg.width or 16,
            quantized=q,
        )
        return model, (32, 32, 3), "cifar10"
    if cfg.config == "logquant_vgg":
        return (models.LogQuantVGGSmall(bits=cfg.w_bits, fsr=cfg.fsr, quantized=q), (32, 32, 3),
                "cifar10")
    raise ValueError(f"unknown config {cfg.config!r}; pick from {sorted(SCHEME_CONFIGS)}")


def build_model(cfg: RunConfig, fp32: bool = False, device="cuda"):
    """Config -> (model on ``device``, input_shape, dataset_name), its
    weights drawn as flax's initializers draw them from ``cfg.seed``
    (``nn.init_like_flax``). ``fp32=True`` builds the float32 twin of the
    Δ-accuracy runs. The model is built on the card unless ``device="cpu"``;
    raises without a GPU."""
    from pytorch_quantize_impls_tpu_torch.nn import init_like_flax

    device = resolve_device(device)
    model, input_shape, dataset = _build(cfg, fp32)
    return init_like_flax(model, cfg.seed).to(device), input_shape, dataset
