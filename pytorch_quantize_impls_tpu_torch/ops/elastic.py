"""Elastic (loss-aware) quantization penalties.

Counterpart of ``pytorch_quantize_impls_tpu/ops/elastic.py``: differentiable
losses that pull full-precision weights toward a quantization grid, summed
into the task loss instead of a hard projection. For a grid ``G`` the
penalty is the mean squared distance to the nearest grid point,
``mean((w - nearest_G(w))^2)``, the nearest point detached, so the gradient
``2 (w - nearest_G(w)) / n`` pulls each weight toward its nearest level.
Grids: binary {-1, +1}, the linear FSR grid and the signed powers of two.
"""

from __future__ import annotations

import torch

from pytorch_quantize_impls_tpu_torch.ops.common import safe_sign
from pytorch_quantize_impls_tpu_torch.ops.log_lin import _log_quant_value


def _grid_penalty(w: torch.Tensor, nearest: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(w - nearest.detach()))


def binary_elastic_loss(w: torch.Tensor) -> torch.Tensor:
    """Penalty with zeros at +-1: pulls weights toward the binary grid."""
    return _grid_penalty(w, safe_sign(w))


def lin_elastic_loss(w: torch.Tensor, fsr: float = 0.0, bits: int = 4) -> torch.Tensor:
    """Penalty toward the uniform FSR grid (step ``2^(fsr - bits)``)."""
    step = 2.0 ** (fsr - bits)
    bound = 2.0**fsr
    nearest = torch.clamp(torch.round(w / step) * step, -bound, bound)
    return _grid_penalty(w, nearest)


def log_elastic_loss(w: torch.Tensor, fsr: float = 0.0, bits: int = 4) -> torch.Tensor:
    """Penalty toward the signed power-of-2 grid."""
    with torch.no_grad():
        nearest = _log_quant_value(w, fsr, bits, with_sign=True)
    return _grid_penalty(w, nearest)


def elastic_loss(grid: str, w: torch.Tensor, fsr: float = 0.0, bits: int = 4) -> torch.Tensor:
    """The penalty of ``grid`` ("binary", "lin" or "log") on ``w``."""
    if grid == "binary":
        return binary_elastic_loss(w)
    if grid == "lin":
        return lin_elastic_loss(w, fsr=fsr, bits=bits)
    if grid == "log":
        return log_elastic_loss(w, fsr=fsr, bits=bits)
    raise ValueError(f"unknown elastic grid {grid!r}")
