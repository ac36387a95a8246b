"""BinaryConnect / BNN sign binarization (deterministic).

Counterpart of ``pytorch_quantize_impls_tpu/ops/binary.py``. The stochastic
variant (``binary_connect_stoch``) waits for its ROADMAP item: its Bernoulli
draws cannot be bit-compared across the two packages and need a statistical
test.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from pytorch_quantize_impls_tpu_torch.ops.common import (
    STE_CLIP,
    resolve_ste_mask,
    safe_sign,
    ste,
)


def binary_connect_det(
    x: torch.Tensor,
    *,
    ste_mode: Union[str, Callable[[torch.Tensor], torch.Tensor]] = STE_CLIP,
    clip_bound: float = 1.0,
) -> torch.Tensor:
    """Deterministic BinaryConnect: ``sign(x)`` with ``sign(0) -> +1``.

    Backward is the straight-through estimator; ``ste_mode='clip'`` (the
    default) cancels the gradient where ``|x| > clip_bound``,
    ``'identity'`` passes it unchanged.
    """
    return ste(safe_sign, resolve_ste_mask(ste_mode, clip_bound))(x)


def binary_tanh(x: torch.Tensor) -> torch.Tensor:
    """BNN activation binarization: ``sign(x)`` with the hard-tanh STE,
    gradient ``g * 1[|x| <= 1]`` (arXiv:1602.02830 eq. 4)."""
    return binary_connect_det(x, ste_mode=STE_CLIP)
