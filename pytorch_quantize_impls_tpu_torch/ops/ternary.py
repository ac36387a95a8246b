"""TernaryConnect: weights quantized to {-1, 0, +1} (arXiv:1510.03009).

Counterpart of ``pytorch_quantize_impls_tpu/ops/ternary.py``.
Deterministic: the nearest of {-1, 0, +1}, ``round(clip(x, -1, 1))``
(thresholds at +-0.5, ties to even as ``jnp.round``). Stochastic (paper
§2.2): with ``w = clip(x, -1, 1)``, ``sign(w)`` with probability ``|w|``,
else 0; the primitive takes the uniform draw ``u`` as an argument, as JAX's
``_ternary_stoch_prim(x, u)`` does. Backward: the STE (clipped by
default), the draw a constant.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from pytorch_quantize_impls_tpu_torch.ops.binary import uniform_like
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


class _TernaryStoch(torch.autograd.Function):
    """``where(u < |clip(x)|, sign(clip(x)), 0)``; backward
    ``g * 1[|x| <= 1]``, nothing for ``u``."""

    @staticmethod
    def forward(ctx, x, u):
        ctx.save_for_backward(x)
        w = torch.clamp(x, -1.0, 1.0)
        return torch.where(u < w.abs(), torch.sign(w), 0.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype), None


def ternary_stoch_prim(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The stochastic ternarizer on a given draw ``u`` ~ U[0, 1)."""
    return _TernaryStoch.apply(x, u)


def ternary_connect_stoch(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Stochastic ternarization, a fresh draw per call from ``generator``."""
    return ternary_stoch_prim(x, uniform_like(x, generator))


def ternary_connect(deterministic: bool = True):
    """The configured ternarizer: ``x -> ...`` or ``(x, generator) -> ...``."""
    if deterministic:
        return ternary_connect_det
    return ternary_connect_stoch
