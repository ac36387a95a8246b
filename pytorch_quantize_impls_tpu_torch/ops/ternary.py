"""TernaryConnect: weights quantized to {-1, 0, +1} (arXiv:1510.03009).

Counterpart of the deterministic half of
``pytorch_quantize_impls_tpu/ops/ternary.py``: the nearest of {-1, 0, +1},
``round(clip(x, -1, 1))`` (thresholds at +-0.5, ties to even as
``jnp.round``), with the straight-through estimator (clipped by default).
The stochastic variant (``ternary_connect_stoch``) acts in training and
waits for ROADMAP queue 1, item 3: its draws cannot be bit-compared across
the two packages.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from pytorch_quantize_impls_tpu_torch.ops.common import STE_CLIP, resolve_ste_mask, ste


def _ternary_round(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, -1.0, 1.0))


def ternary_connect_det(
    x: torch.Tensor,
    *,
    ste_mode: Union[str, Callable[[torch.Tensor], torch.Tensor]] = STE_CLIP,
) -> torch.Tensor:
    """Deterministic ternarization: the nearest of {-1, 0, +1}."""
    return ste(_ternary_round, resolve_ste_mask(ste_mode))(x)
