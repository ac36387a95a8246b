"""Shared kernel utilities. (The JAX package's tile helpers ``round_up`` and
``pick_tiles`` have no counterpart: the CUDA kernels tile and mask inside.)"""

from __future__ import annotations

import torch


def pad_dim(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """Zero-pad ``axis`` of x up to length ``to``."""
    n = x.shape[axis]
    if n == to:
        return x
    shape = list(x.shape)
    shape[axis] = to - n
    return torch.cat([x, x.new_zeros(shape)], dim=axis)
