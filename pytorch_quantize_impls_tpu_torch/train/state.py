"""Train state: the model, its optimizer, the clamp, and the step's
generator.

Counterpart of ``pytorch_quantize_impls_tpu/train/state.py``. The model
holds the parameters and the BatchNorm statistics; an optimizer steps them
(``torch.optim.Adam`` with optax's defaults, betas 0.9/0.999, eps 1e-8,
unless ``create_for`` is handed another, as the JAX package is handed a
``tx``: :class:`~.quantized_optim.QuantizedAdam`) and
:class:`~.clipping.ClampAfterStep` clamps the kernels after it. Stochastic
quantizers draw from :meth:`QuantTrainState.step_generator`, seeded from
(seed, step) on the model's device, so the draws are deterministic given
both, as the JAX package folds the step into its ``'quant'`` key. The
global RNG is never drawn from.

``lr`` is a float or a schedule ``step -> lr`` (the JAX runs' cosine decay:
:func:`cosine_decay_schedule`), read before each update as optax reads its
schedule with the update count. With an optimizer handed in, the optimizer
owns the rate (``QuantizedAdam`` reads its schedule at its own count) and
the state sets none.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.train.clipping import PathFilter, clip_quantized_weights

Schedule = Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax's ``cosine_decay_schedule(init_value, decay_steps)`` (alpha 0),
    in float32: ``init * 0.5 (1 + cos(pi min(step, decay_steps) / decay_steps))``."""

    def schedule(step: int) -> float:
        count = np.float32(min(step, decay_steps))
        cosine = np.float32(0.5) * (1 + np.cos(np.float32(np.pi) * count / np.float32(decay_steps)))
        return float(np.float32(init_value) * cosine)

    return schedule


class QuantTrainState:
    """(model, optimizer, clamp, step, seed); ``step`` counts applied
    updates. ``lr`` is the rate the state sets before each update (Adam's),
    or None where the optimizer owns it."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer, clamp, *,
                 seed: int = 0, lr: Union[float, Schedule, None] = None):
        self.model = model
        self.optimizer = optimizer
        self.clamp = clamp
        self.seed = seed
        self.lr = lr
        self.step = 0

    @classmethod
    def create_for(cls, model: nn.Module, lr: Union[float, Schedule, None] = None, seed: int = 0,
                   path_filter: Optional[PathFilter] = None,
                   optimizer: Optional[torch.optim.Optimizer] = None) -> "QuantTrainState":
        """Adam at ``lr`` (default 3e-3) over ``model``'s parameters, or
        ``optimizer`` (built on them, with its own rate), and the clamp."""
        if optimizer is not None:
            if lr is not None:
                raise ValueError("pass the learning rate to the optimizer, not to create_for")
        else:
            lr = 3e-3 if lr is None else lr
            first = lr(0) if callable(lr) else lr
            optimizer = torch.optim.Adam(model.parameters(), lr=first, betas=(0.9, 0.999),
                                         eps=1e-8)
        return cls(model, optimizer, clip_quantized_weights(model, path_filter), seed=seed, lr=lr)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def step_generator(self) -> torch.Generator:
        """This step's generator on the model's device, seeded from (seed,
        step)."""
        seed = int(np.random.SeedSequence([self.seed, self.step]).generate_state(1, np.uint64)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``, then the
        clamp; ``step`` += 1."""
        if callable(self.lr):
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr(self.step)
        self.clamp.step(self.optimizer)
        self.step += 1
