"""PACT activation layer: learnable clip bound, k-bit activations.

Counterpart of ``pytorch_quantize_impls_tpu/nn/pact.py``. The scalar
``alpha`` is the flax ``alpha`` parameter (``utils.bridge`` carries it). The
JAX layer also sows its training penalty on ``alpha`` into the ``losses``
collection; that waits for training.
"""

from __future__ import annotations

import torch
from torch import nn

from pytorch_quantize_impls_tpu_torch.ops.pact import pact


class PACT(nn.Module):
    def __init__(self, bits: int = 4, alpha_init: float = 6.0):
        super().__init__()
        self.bits = bits
        self.alpha = nn.Parameter(torch.tensor(alpha_init, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pact(x, self.alpha, self.bits)
