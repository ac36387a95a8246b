"""Train and eval steps.

Counterpart of ``pytorch_quantize_impls_tpu/train/steps.py``: fake-quant
forward -> float32 cross-entropy over every leading position (+ the weighted
penalties of ``nn.collect_elastic_losses``: PACT's alpha L2, the elastic
grid penalty, the MoE's aux loss) -> STE backward -> Adam -> clamp, with
BatchNorm in training mode. The JAX package jits this into one
XLA program; here it is eager PyTorch (``torch.matmul``, cuDNN convs, the
STEs' ``autograd.Function``s), and launches none of the port's kernels.

The forward and the backward run inside one set of cuDNN flags: no TF32
(the JAX package computes float32) and the deterministic algorithms, so two
runs on the card give the same bits. :func:`make_compute_loss` is the
forward and loss that every step flavour shares, this local step and the
sharded one (``parallel.make_sharded_train_step``), as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_quantize_impls_tpu_torch.nn.base import collect_elastic_losses, quant_generator
from pytorch_quantize_impls_tpu_torch.train.state import QuantTrainState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy on float32 logits ``(..., V)`` and integer
    labels ``(...)``, over every leading position (optax's integer-label
    cross-entropy, then the mean): a classifier's ``(b, V)`` or an LM's
    ``(b, s, V)``."""
    logits = logits.to(torch.float32)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).to(torch.int64))


def fp32_cudnn():
    """cuDNN without TF32, deterministic algorithms, no autotuning."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False, deterministic=True,
                                      benchmark=False)


def _on_device(batch, device):
    """Every array of ``batch`` (numpy or tensors) as a tensor on ``device``."""
    return tuple((torch.from_numpy(b) if isinstance(b, np.ndarray) else b)
                 .to(device, non_blocking=True) for b in batch)


ElasticWeight = Union[float, Callable[[int], float]]


def make_compute_loss(state: QuantTrainState, x: torch.Tensor, y: torch.Tensor, *,
                      elastic_weight: ElasticWeight = 0.0, loss_fn: Callable = cross_entropy):
    """``() -> (loss, logits)``: the fake-quant forward of ``state.model``
    on ``x`` under :func:`fp32_cudnn` and the step's generator, and the
    loss on ``y`` plus the model's penalties weighed by ``elastic_weight``
    (a constant, or a schedule called with the step before its update).
    The forward and loss that every train-step flavour shares."""

    def compute_loss():
        weight = float(elastic_weight(state.step) if callable(elastic_weight) else elastic_weight)
        with fp32_cudnn(), quant_generator(state.step_generator()):
            logits = state.model(x)
            loss = loss_fn(logits, y)
            if weight:
                loss = loss + weight * collect_elastic_losses(state.model)
        return loss, logits

    return compute_loss


def make_train_step(*, elastic_weight: ElasticWeight = 0.0, loss_fn: Callable = cross_entropy):
    """``(state, (inputs, integer labels)) -> (state, {"loss", "accuracy"})``:
    one update of ``state`` in place (returned for the JAX package's
    calling pattern). The metrics stay on the device; the loss includes the
    penalty.

    ``elastic_weight`` weighs the model's penalties
    (``nn.collect_elastic_losses``) in the loss: a constant, or a schedule
    called with the step before its update (the JAX package's ``lambda(step)``)."""

    def step(state: QuantTrainState, batch):
        x, y = _on_device(batch, state.device)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        compute_loss = make_compute_loss(state, x, y, elastic_weight=elastic_weight,
                                         loss_fn=loss_fn)
        with fp32_cudnn():
            loss, logits = compute_loss()
            loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step


def make_eval_step():
    """``(state, batch) -> {"loss", "accuracy", "count"}`` in eval mode:
    running BatchNorm statistics, deterministic quantizers (the stochastic
    ones' ``eval_fn``)."""

    @torch.no_grad()
    def step(state: QuantTrainState, batch):
        x, y = _on_device(batch, state.device)
        state.model.eval()
        logits = state.model(x)
        return {
            "loss": cross_entropy(logits, y),
            "accuracy": (logits.argmax(-1) == y).to(torch.float32).mean(),
            "count": torch.tensor(y.shape[0]),
        }

    return step
