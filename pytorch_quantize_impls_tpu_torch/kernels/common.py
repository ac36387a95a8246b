"""Shared kernel utilities. (The JAX package's tile helpers ``round_up`` and
``pick_tiles`` have no counterpart: the CUDA kernels tile and mask inside.)"""

from __future__ import annotations

import functools

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


# The streamed GEMMs' launch plan (csrc/stream_tile.cuh: shift_gemm,
# dorefa_gemm): the SM count of the H100 SXM that a split over K fills, the
# output tile's columns, the fewest stages a split's chunk holds (the ring's
# depth: a shorter chunk cannot overlap its loads with its arithmetic), and
# a cap on the split's workspace. A split is taken only while the tile grid
# is at most half of STREAM_SMS, and it makes S < 2 ceil(STREAM_SMS / grid)
# chunks, so S * grid < 2 (STREAM_SMS + grid) <= 3 STREAM_SMS tiles of at
# most 64 x STREAM_BN four-byte partials.
STREAM_SMS = 132
STREAM_BN = 64
STREAM_MIN_CHUNK = 4
STREAM_WORKSPACE_CAP = 3 * STREAM_SMS * 64 * STREAM_BN * 4


def stream_workspace_bytes(m: int, n: int, splits: int) -> int:
    """Bytes of a streamed GEMM's workspace: ``splits`` partial (m, n)
    tiles of 4-byte sums; 0 without a split."""
    return 4 * splits * m * n if splits > 1 else 0


@functools.lru_cache(maxsize=None)
def stream_plan(m: int, n: int, k: int, stage_k: int):
    """(BM, S, chunk) for a streamed GEMM of (m, k) x (k, n), a pure
    function of the shape: output tiles of BM x 64 (BM 32 for m <= 32; 128
    where 128-row tiles still make two per SM, as at 4096^3, where they ran
    1.4-1.6x faster than 64 on the H100 (PERF.md); else 64), and K's
    ``ceil(k / stage_k)`` stages split into S contiguous chunks of
    ``chunk`` k each (a multiple of ``stage_k``; the last may be shorter,
    none is empty). S = 1 when the tile grid fills more than half of
    STREAM_SMS (a split of two would then overfill it); else the largest
    whole number of stages per chunk, at least STREAM_MIN_CHUNK, that gives
    ``ceil(STREAM_SMS / grid)`` chunks or more, so S is capped by
    ``ceil(stages / STREAM_MIN_CHUNK)``."""
    ncols = -(-n // STREAM_BN)
    bm = 32 if m <= 32 else 128 if -(-m // 128) * ncols >= 2 * STREAM_SMS else 64
    splits, per = stream_split(-(-m // bm) * ncols, -(-k // stage_k))
    return bm, splits, per * stage_k


def stream_split(grid: int, stages: int):
    """(S, stages per chunk) of :func:`stream_plan` for a grid of ``grid``
    output tiles and K's ``stages``."""
    if 2 * grid > STREAM_SMS or stages <= STREAM_MIN_CHUNK:
        return 1, stages
    per = max(STREAM_MIN_CHUNK, stages // -(-STREAM_SMS // grid))
    return -(-stages // per), per


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
