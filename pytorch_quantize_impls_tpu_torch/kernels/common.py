"""Shared kernel utilities. (The JAX package's tile helpers ``round_up`` and
``pick_tiles`` have no counterpart: the CUDA kernels tile and mask inside.)"""

from __future__ import annotations

import torch

from pytorch_quantize_impls_tpu_torch.ops import pack as packlib


def packed_rows(w_packed: torch.Tensor, bits: int, k: int = 0) -> int:
    """Rows of a grouped-planar packed weight of ``bits``-bit codes; raise
    unless they are whole groups covering K = ``k``."""
    r = w_packed.shape[0]
    f = packlib.pack_factor(bits)
    if r % packlib.GROUP_ROWS or k > r * f:
        raise ValueError(f"packed weight has {r} rows (K <= {r * f}), x has K = {k}")
    return r


def pad_dim(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """Zero-pad ``axis`` of x up to length ``to``."""
    n = x.shape[axis]
    if n == to:
        return x
    shape = list(x.shape)
    shape[axis] = to - n
    return torch.cat([x, x.new_zeros(shape)], dim=axis)
