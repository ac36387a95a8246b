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
WS_DEFAULT_M_TILES = {"binary_gemm_ws": 4, "dorefa_gemm_ws": 4, "shift_gemm_ws": 4}


# The Hopper tile (csrc/wgmma_tile.cuh) of shift_gemm_ws (K12) and the
# probe's bf16 tiled_mm (P1) and, on its s8 path, of binary_gemm_ws (K10),
# dorefa_gemm_ws (K11) and P1 int8/int4: stages of 128 bytes of k (64 bf16,
# or 128 int8), each row 128 bytes in the 128-byte swizzle, warpgroups of
# 128 threads, m64n128 products, and the dynamic shared memory one block may
# use on the H100 (227 KB).
WGMMA_STAGE_K = 64
WGMMA_ROW_BYTES = 128
WGMMA_ATOM_BYTES = 1024
WGMMA_SMEM_LIMIT = 232448
WGMMA_WG_THREADS = 128
WGMMA_N_TILE = 128
SHIFT_WS_BN = WGMMA_N_TILE
BINARY_WS_STAGE_K = WGMMA_ROW_BYTES  # int8 k per stage of the s8 tiles
TMA_PITCH = 16  # bytes: TMA reads rows of x at a multiple of this


def wgmma_smem_bytes(a_rows: int, b_rows: int, stages: int, extra: int) -> int:
    """Dynamic shared memory of a wgmma ring (``csrc/wgmma_tile.cuh``
    ``smem_bytes``, which the kernels ``static_assert`` against
    WGMMA_SMEM_LIMIT): ``stages`` slots of ``a_rows`` + ``b_rows`` 128-byte
    rows, ``extra`` bytes, two 8-byte mbarriers per stage and 1024 bytes to
    align the first slot to the swizzle atom."""
    return (WGMMA_ATOM_BYTES + stages * (a_rows + b_rows) * WGMMA_ROW_BYTES + extra
            + 2 * stages * 8)


def swizzle128(row: int, chunk: int) -> int:
    """Byte offset of 16-byte chunk ``chunk`` (0..7) of row ``row`` of a tile
    of 128-byte rows in the 128-byte swizzle that TMA writes and wgmma reads
    (``csrc/wgmma_tile.cuh`` ``swizzle128``)."""
    return row * WGMMA_ROW_BYTES + ((chunk ^ (row & 7)) << 4)


def shift_ws_plan(m_tiles: int) -> dict:
    """The launch of shift_gemm_ws (``csrc/shift_gemm.cu`` ShiftWsTile) for
    ``m_tiles`` (one of WS_M_TILES): a block of 64 ``m_tiles`` rows x 128
    columns, one consumer warpgroup per 64-row M-tile plus the decoder
    warpgroup, a ring of 4 stages of x and of the decoded weight tile; two
    blocks share an SM at m_tiles 1."""
    if m_tiles not in WS_M_TILES:
        raise ValueError(f"m_tiles={m_tiles!r}: must be one of {WS_M_TILES}")
    rows = 64 * m_tiles
    return dict(bm=rows, bn=SHIFT_WS_BN, consumers=m_tiles, stages=4,
                blocks_per_sm=2 if m_tiles == 1 else 1,
                threads=(m_tiles + 1) * WGMMA_WG_THREADS,
                smem=wgmma_smem_bytes(rows, SHIFT_WS_BN, 4, 0))


def packed_ws_plan(bits: int, m_tiles: int) -> dict:
    """The launch of the weight-stationary packed GEMMs on the s8 tile
    (``csrc/packed_ws.cuh`` PackedWsTile: binary_gemm_ws at one bit,
    dorefa_gemm_ws at 1, 2 or 4) for ``m_tiles``: :func:`shift_ws_plan`'s
    block of 64 ``m_tiles`` rows x 128 columns, ring and blocks per SM, with
    stages of 128 int8 of k, 8 / ``bits`` to a 32-word packed group; one
    consumer warpgroup per M-tile, at most two (``mi`` M-tiles each:
    wgmma m64n128k32 s8), and the decoder, a thread per column."""
    if bits not in (1, 2, 4):
        raise ValueError(f"bits={bits!r}: the s8 tile decodes 1-, 2- or 4-bit codes")
    consumers = min(m_tiles, 2)
    group_k = packlib.GROUP_ROWS * packlib.pack_factor(bits)
    return dict(shift_ws_plan(m_tiles), consumers=consumers, mi=m_tiles // consumers,
                threads=(consumers + 1) * WGMMA_WG_THREADS, stage_k=BINARY_WS_STAGE_K,
                stages_per_group=group_k // BINARY_WS_STAGE_K)


def binary_ws_plan(m_tiles: int) -> dict:
    """The launch of binary_gemm_ws (K10): :func:`packed_ws_plan` at one
    bit, 8 stages to a 1024-row packed group."""
    return packed_ws_plan(1, m_tiles)


def tiled_mm_bf16_plan(bm: int, bn: int) -> dict:
    """The launch of the probe's bf16 tiled_mm (``csrc/mxu_probe.cu``
    Bf16Tile) for a (BM, BN) tiling: two consumer warpgroups (one for BM =
    64), each running BM / 64 / consumers 64-row tiles x BN / 128 column
    tiles of m64n128 products (64 f32 accumulators each per thread), one
    producer warpgroup, a ring of 4 stages."""
    consumers = 2 if bm >= 128 else 1
    if bm % 64 or bm > 256 or (bm // 64) % consumers or bn % WGMMA_N_TILE:
        raise ValueError(f"tiles ({bm}, {bn}): no bf16 wgmma tile")
    mi, ni = bm // 64 // consumers, bn // WGMMA_N_TILE
    return dict(consumers=consumers, mi=mi, ni=ni, acc_per_thread=64 * mi * ni, stages=4,
                threads=(consumers + 1) * WGMMA_WG_THREADS,
                smem=wgmma_smem_bytes(bm, bn, 4, 0))


def tiled_mm_s8_plan(bm: int, bn: int, int4: bool) -> dict:
    """The launch of the probe's int8 or int4 tiled_mm (``csrc/mxu_probe.cu``
    S8Tile) for a (BM, BN) tiling: :func:`tiled_mm_bf16_plan`'s consumers
    (m64n128k32 s8 products, int32 accumulators) and one transposer
    warpgroup; stages of 128 k. The wgmma ring holds ``stages`` slots of x
    (A, BM rows) and the transposed w (B, BN rows) of 128 bytes; the staging
    ring ``staging`` slots of w's rows as TMA brings them (128 k-rows x BN
    bytes; int4: 64 rows of packed pairs, and x's BM x 64 packed bytes),
    each with an mbarrier. ``stages`` is 4 where two staging slots still
    fit in WGMMA_SMEM_LIMIT, else 3; ``staging`` then as many as fit, at
    most 4."""
    try:
        consumers = tiled_mm_bf16_plan(bm, bn)
    except ValueError:
        raise ValueError(f"tiles ({bm}, {bn}): no s8 wgmma tile") from None
    if bn > 256:
        raise ValueError(f"tiles ({bm}, {bn}): no s8 wgmma tile")
    w_bytes = (BINARY_WS_STAGE_K // (2 if int4 else 1)) * bn
    stg_bytes = w_bytes + (bm * BINARY_WS_STAGE_K // 2 if int4 else 0)

    def smem(stages, staging):
        return wgmma_smem_bytes(bm, bn, stages, staging * (stg_bytes + 8))

    stages = 4 if smem(4, 2) <= WGMMA_SMEM_LIMIT else 3
    staging = next(g for g in (4, 3, 2) if g == 2 or smem(stages, g) <= WGMMA_SMEM_LIMIT)
    return dict(consumers=consumers["consumers"], mi=consumers["mi"], ni=consumers["ni"],
                acc_per_thread=consumers["acc_per_thread"], stage_k=BINARY_WS_STAGE_K,
                stages=stages, staging=staging, w_stage_bytes=w_bytes, staging_bytes=stg_bytes,
                threads=consumers["threads"], smem=smem(stages, staging))


# decode_attention (K4, csrc/decode_attention.cu): blocks of ATTN_THREADS
# threads, each lane 16 codes of a cache row; one cluster of C blocks (one
# of ATTN_CLUSTERS) per (b, h). The default C is the largest that keeps b h
# C at most ATTN_TARGET_BLOCKS (four blocks an SM), at most
# ATTN_DEFAULT_MAX_CLUSTER: the fastest in bench/attention_cost.py's sweep on
# the H100 (PERF.md).
ATTN_THREADS = 256
ATTN_WARPS = ATTN_THREADS // 32
ATTN_HEAD_DIMS = (16, 32, 64, 128, 256)
ATTN_CLUSTERS = (1, 2, 4, 8, 16)
ATTN_SCALARS = ATTN_CLUSTERS[-1] + 4 * ATTN_WARPS
ATTN_TARGET_BLOCKS = 512
ATTN_DEFAULT_MAX_CLUSTER = 4


def attention_rows(hd: int) -> int:
    """Cache rows one load round of a K4 block covers: hd / 16 lanes to a
    row, 32 lanes to a warp."""
    return ATTN_WARPS * 32 // (hd // 16)


def attention_smem_bytes(hd: int, chunk: int) -> int:
    """Dynamic shared memory of a K4 block that owns ``chunk`` rows
    (``csrc/decode_attention.cu`` ``smem_bytes``), in floats: the warps'
    contexts, the cluster's partial contexts of this block's dimensions,
    ATTN_SCALARS (the cluster's block sums; the warps' maxima, sums, maxima
    over masked rows and last live rounds) and ``chunk`` scores."""
    return 4 * ((ATTN_WARPS + 1) * hd + ATTN_SCALARS + chunk)


@functools.lru_cache(maxsize=None)
def attention_plan(b: int, h: int, cl: int, hd: int, clusters=None) -> dict:
    """The launch of decode_attention (K4) for (b, h, cl, hd): C blocks per
    (b, h) in one cluster (``clusters``, else the default: the largest of
    ATTN_CLUSTERS up to ATTN_DEFAULT_MAX_CLUSTER with b h C <=
    ATTN_TARGET_BLOCKS and no more than the cache's load rounds of
    :func:`attention_rows` rows, raised until a block's shared memory
    fits). Rank r of a cluster owns the load rounds
    r, r + C, r + 2C, ... of the cache, so the cluster's first rounds cover
    its head, where the engine's live rows are: ``chunk`` rows, ceil(cl /
    C) rounded up to a round. ``blocks`` is the grid, ``smem`` a block's
    dynamic shared memory."""
    if hd not in ATTN_HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in {ATTN_HEAD_DIMS}")
    rows = attention_rows(hd)
    if clusters is None:
        rounds = -(-cl // rows)
        c = max(k for k in ATTN_CLUSTERS if k == 1 or (
            k <= ATTN_DEFAULT_MAX_CLUSTER and b * h * k <= ATTN_TARGET_BLOCKS and k <= rounds))
    elif clusters in ATTN_CLUSTERS:
        c = clusters
    else:
        raise ValueError(f"clusters={clusters!r}: must be one of {ATTN_CLUSTERS}")
    while True:
        chunk = -(-cl // (rows * c)) * rows
        smem = attention_smem_bytes(hd, chunk)
        if smem <= WGMMA_SMEM_LIMIT:
            break
        if clusters is not None or c == ATTN_CLUSTERS[-1]:
            raise ValueError(f"decode_attention: cl={cl} needs {smem} bytes of shared memory "
                             f"per block at {c} blocks per (b, h)")
        c *= 2
    return dict(clusters=c, chunk=chunk, rows=rows, blocks=b * h * c, smem=smem)


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """A row-major byte matrix as TMA reads it: 16-byte aligned, with a row
    pitch of its width rounded up to a multiple of TMA_PITCH bytes. x
    itself where the width is a multiple already and x is aligned (a copy
    if it is not aligned); else a copy into the first columns of a wider
    buffer (the columns past the width are never read: the kernels' tensor
    maps are as wide as x)."""
    m, k = x.shape
    pitch = -(-k // TMA_PITCH) * TMA_PITCH
    if pitch == k:
        return x if x.data_ptr() % 16 == 0 else x.clone()
    xq = torch.empty((m, pitch), dtype=x.dtype, device=x.device)
    xq[:, :k] = x
    return xq


def ws_m_tiles(m_tiles, kernel: str) -> int:
    """``m_tiles``, or ``kernel``'s default; raise unless it is in
    WS_M_TILES."""
    r = WS_DEFAULT_M_TILES[kernel] if m_tiles is None else m_tiles
    if r not in WS_M_TILES:
        raise ValueError(f"m_tiles={m_tiles!r}: must be one of {WS_M_TILES}")
    return r


# The streamed GEMMs' launch plan (csrc/stream_tile.cuh: shift_gemm,
# dorefa_gemm, binary_gemm, int8_gemm): the SM count of the H100 SXM that a
# split over K fills, the output tile's columns, the fewest stages a split's chunk holds
# (the ring's depth: a shorter chunk cannot overlap its loads with its
# arithmetic), and a cap on the split's workspace. A split is taken only while the tile grid
# is at most half of STREAM_SMS, and it makes S < 2 ceil(STREAM_SMS / grid)
# chunks, so S * grid < 2 (STREAM_SMS + grid) <= 3 STREAM_SMS tiles of at
# most 64 x STREAM_BN four-byte partials.
STREAM_SMS = 132
STREAM_BN = 64
STREAM_MIN_CHUNK = 4
STREAM_WORKSPACE_CAP = 3 * STREAM_SMS * 64 * STREAM_BN * 4


# The raw int8 tiles on the same schedule (csrc/stream_tile.cuh BytesTile:
# int8_gemm, int8_conv2d): shared-memory rows of STREAM_LDW words (64 bytes of
# k and 16 of pad), STREAM_RING stages in flight, each weight stage 64
# k-rows of BN bytes plus STREAM_RAW_PAD; the conv's tiles are CONV_BM
# output pixels by one of CONV_BNS channels.
STREAM_STAGE_BYTES = 64
STREAM_LDW = 20
STREAM_RING = 4
STREAM_RAW_PAD = 16
STREAM_SMEM_LIMIT = WGMMA_SMEM_LIMIT
CONV_BM = 128
CONV_BNS = (64, 128)


def bytes_tile_smem(bm: int, bn: int) -> int:
    """Dynamic shared memory of a raw int8 streamed tile of ``bm`` x ``bn``
    (``csrc/stream_tile.cuh`` ``Tile::SMEM`` of ``BytesTile``): the ring of
    activation rows, a ring of weight stages and two transposed weight
    stages."""
    words = (STREAM_RING * bm * STREAM_LDW
             + STREAM_RING * STREAM_STAGE_BYTES * (bn + STREAM_RAW_PAD) // 4
             + 2 * bn * STREAM_LDW)
    return 4 * words


@functools.lru_cache(maxsize=None)
def conv_plan(m: int, n: int) -> dict:
    """The launch of int8_conv2d (K5, ``csrc/int8_conv.cu``) for M = B HO
    WO output pixels and N output channels: tiles of CONV_BM pixels by
    min(N, 128) channels, rounded up to the 64 or 128 the kernel has; the
    grid (M tiles, N tiles); the dynamic shared memory (the tile's and the
    per-row pixel table's); the blocks that share an SM (three 64-wide, two
    128-wide: the kernel's launch bounds). No split over K."""
    bn = CONV_BNS[0] if n <= CONV_BNS[0] else CONV_BNS[1]
    return dict(bm=CONV_BM, bn=bn, grid=(-(-m // CONV_BM), -(-n // bn)),
                smem=bytes_tile_smem(CONV_BM, bn) + 3 * CONV_BM * 4,
                blocks_per_sm=3 if bn == CONV_BNS[0] else 2)


# The packed weight stage of int8_conv2d (K5 on packed words,
# csrc/int8_conv.cu int8_conv_kernel_packed): tiles of CONV_BM pixels by
# CONV_PACKED_BN channels, two slab slots after the tile (each with a
# header of CONV_SLAB_HEADER_WORDS words in the tile's weight ring).
CONV_PACKED_BN = 64
CONV_SLAB_HEADER_WORDS = 4


@functools.lru_cache(maxsize=None)
def conv_slab_plan(c: int, taps: int, bits: int) -> dict:
    """The packed weight stage of K5 for ``c`` input channels, ``taps`` =
    kh kw and ``bits``-bit packed words (``csrc/int8_conv.cu``
    ``slab_blocks``, ``slab_groups``, ``packed_smem``): K walked channel
    block by channel block, ``cbs`` blocks of 64 channels (and all their
    taps) to a slab (one, or a whole packed group's at taps 1), ``spg``
    stages a slab; ``groups``, the most packed groups of 32 word rows one
    slab covers, sizes each of the two slots (``slot_words`` words of 64
    columns); ``table_words`` a slab's address table (an entry per
    channel and tap; two of them); ``smem`` the block's dynamic shared
    memory and ``fits`` whether the H100 takes it."""
    gk = packlib.planar_group_k(bits)
    cbs = 1 if taps > 1 else gk // STREAM_STAGE_BYTES
    cst = -(-c // STREAM_STAGE_BYTES)
    groups = 0
    for slab in range(-(-cst // cbs)):
        k_lo = slab * cbs * STREAM_STAGE_BYTES * taps
        k_hi = min((slab + 1) * cbs * STREAM_STAGE_BYTES, c) * taps
        groups = max(groups, (k_hi - 1) // gk - k_lo // gk + 1)
    slot = groups * packlib.GROUP_ROWS * CONV_PACKED_BN
    table = cbs * STREAM_STAGE_BYTES * taps
    tile = 4 * (STREAM_RING * CONV_BM * STREAM_LDW + 2 * CONV_SLAB_HEADER_WORDS
                + 2 * CONV_PACKED_BN * STREAM_LDW)
    smem = tile + 4 * (2 * slot + 2 * table) + 3 * CONV_BM * 4
    return dict(bn=CONV_PACKED_BN, cbs=cbs, spg=cbs * taps, groups=groups, slot_words=slot,
                table_words=table, smem=smem, fits=smem <= STREAM_SMEM_LIMIT)


# The largest conv, in int8 operations 2 M N K, that the packed conv sends
# through the fused packed stage: on the H100 (PERF.md, bench/
# conv_decode_cost.py) the fused route was no slower by CUDA events than
# decode + raw K5 at every ResNet conv up to b = 64 (at most 4.83e9
# operations) and slower at every one at b = 256 (9.66e9 and up), where the
# raw kernel's 128-wide tiles and its plain weight stage win back more than
# the decoder's launch costs.
CONV_FUSED_MAX_OPS = 6.8e9


def conv_route(b: int, m: int, n: int, c: int, taps: int, bits: int) -> str:
    """How the packed conv (``kernels/conv.py`` direct mode) runs on the
    card for a batch of ``b`` images, M = B HO WO output pixels, N output
    channels, ``c`` input channels, ``taps`` = kh kw and ``bits``-bit
    packed words, a pure function of the shape: ``"fused"``, one launch of
    K5 with the packed weight stage, where its slab fits and the batch is
    one image or the conv is at most CONV_FUSED_MAX_OPS operations; else
    ``"decode"``, K2 or K7 then the raw K5."""
    if not conv_slab_plan(c, taps, bits)["fits"]:
        return "decode"
    return "fused" if b == 1 or 2 * m * n * c * taps <= CONV_FUSED_MAX_OPS else "decode"


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
