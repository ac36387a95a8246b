"""Shared kernel utilities. (The JAX package's tile helpers ``round_up`` and
``pick_tiles`` have no counterpart: the CUDA kernels tile and mask inside.)"""

from __future__ import annotations

import torch

from pytorch_quantize_impls_tpu_torch.ops import pack as packlib


# M-tiles of 64 rows that one block of a weight-stationary kernel runs
# against each decoded weight tile: the instantiated set, and each kernel's
# default, the fastest in the 4096^3 kernel-bench sweep on the H100 (PERF.md)
WS_M_TILES = (1, 2, 4)
WS_DEFAULT_M_TILES = {"binary_gemm_ws": 2, "dorefa_gemm_ws": 2, "shift_gemm_ws": 1}


def ws_m_tiles(m_tiles, kernel: str) -> int:
    """``m_tiles``, or ``kernel``'s default; raise unless it is in
    WS_M_TILES."""
    r = WS_DEFAULT_M_TILES[kernel] if m_tiles is None else m_tiles
    if r not in WS_M_TILES:
        raise ValueError(f"m_tiles={m_tiles!r}: must be one of {WS_M_TILES}")
    return r


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
