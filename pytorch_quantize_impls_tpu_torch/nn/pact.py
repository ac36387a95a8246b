"""PACT activation layer: learnable clip bound, k-bit activations.

Counterpart of ``pytorch_quantize_impls_tpu/nn/pact.py``. The scalar
``alpha`` is the flax ``alpha`` parameter (``utils.bridge`` carries it). The
JAX layer sows its training penalty on ``alpha`` into the ``losses``
collection; here :meth:`PACT.penalty` returns it, and
``nn.collect_elastic_losses`` sums it with every other layer's penalty, so
``train.make_train_step(elastic_weight=lambda)`` adds ``lambda sum alpha^2``
to the loss. The penalty depends on ``alpha`` alone and each PACT runs once
per forward, so the sum is the one JAX sows.
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.ops.pact import pact, pact_alpha_penalty


class PACT(nn.Module):
    def __init__(self, bits: int = 4, alpha_init: float = 6.0):
        super().__init__()
        self.bits = bits
        self.alpha = nn.Parameter(torch.tensor(alpha_init, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pact(x, self.alpha, self.bits)

    def penalty(self) -> torch.Tensor:
        """The training penalty on ``alpha`` (``ops.pact_alpha_penalty``)."""
        return pact_alpha_penalty(self.alpha)
