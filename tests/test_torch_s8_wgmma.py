"""The s8 path of the Hopper tile (``csrc/wgmma_tile.cuh``) under P1's int8 and
int4 ``tiled_mm`` (``csrc/mxu_probe.cu``) and K11 ``dorefa_gemm_ws``
(``csrc/packed_ws.cuh``, the tile body K11 shares with K10), on the CPU.

The CUDA kernels cannot run here. What their weight-writing warpgroups
compute is mirrored in Python, step for step, and held to the plain
versions, inputs made with numpy from a seed:

- P1's transposer: each 4 x 4 byte block of w's staged rows turned with
  ``__byte_perm`` (each lane's column order rotated), placed by the 128-byte
  swizzle (``common.swizzle128``) into the K-major B stage, a bijection that
  reproduces ``w.T``'s bytes; int4 nibbles of x and w sign-extended into
  bytes as they are written, reproducing ``unpack_int4``; the shared-memory
  accesses free of bank conflicts;
- K11's decoder at 1, 2 and 4 bits, reproducing
  ``decode_dorefa_weights_reference``'s rows;
- the launch plans ``tiled_mm_s8_plan`` and ``packed_ws_plan`` against the
  constants in the CUDA sources and the 227 KB budget.

The wrappers' contract on the CPU is held to the JAX package: K11 to its
``dorefa_gemm_ws`` in Pallas interpret mode, P1 to ``scripts/mxu_probe.py``'s
kernel body in interpret mode.
"""

from __future__ import annotations

import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu_torch.bench import mxu_probe as tmp
from pytorch_quantize_impls_tpu_torch.bench import ws_decode_cost
from pytorch_quantize_impls_tpu_torch.kernels import common
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as tpm
from pytorch_quantize_impls_tpu_torch.ops import pack as tpack

jpm = sys.modules["pytorch_quantize_impls_tpu.kernels.packed_matmul"]

REPO = Path(__file__).resolve().parent.parent
CSRC = Path(tpm.__file__).resolve().parent.parent / "csrc"
SM_SHARED_BYTES = 233472  # an H100 SM's 228 KB of shared memory
BLOCK_RESERVED_BYTES = 1024  # shared memory the hardware keeps per block
WG = common.WGMMA_WG_THREADS
MASK32 = 0xFFFFFFFF


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte i is byte (s >> 4i) & 7 of y:x."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _word(row: np.ndarray, byte: int) -> int:
    """The little-endian 32-bit word at ``byte`` of a uint8 row."""
    return int(row[byte:byte + 4].view(np.uint32)[0])


def _bytes(words) -> np.ndarray:
    return np.array(words, np.uint32).view(np.uint8)


# --- P1: the transposer -----------------------------------------------------------

def _transpose4(L, rot):
    """mxu_probe.cu Transpose4: rows L[0..3] of a 4 x 4 byte block -> word i
    holds column i ^ rot's four rows."""
    s1 = (0x7362 if rot & 2 else 0x5140, 0x5140 if rot & 2 else 0x7362)
    s2 = (0x7632 if rot & 1 else 0x5410, 0x5410 if rot & 1 else 0x7632)
    out = [0] * 4
    for p in range(2):
        t01, t23 = _byte_perm(L[0], L[1], s1[p]), _byte_perm(L[2], L[3], s1[p])
        for h in range(2):
            out[2 * p + h] = _byte_perm(t01, t23, s2[h])
    return out


def _int4_bytes(v: int):
    """mxu_probe.cu int4_bytes: eight packed nibbles -> two words of their
    sign-extended bytes, in k order."""
    e = v ^ 0x88888888
    lo = (((e & 0x0F0F0F0F) + 0x78787878) ^ 0x80808080) & MASK32
    hi = ((((e >> 4) & 0x0F0F0F0F) + 0x78787878) ^ 0x80808080) & MASK32
    return _byte_perm(lo, hi, 0x5140), _byte_perm(lo, hi, 0x7362)


def _transposer_stage(W: np.ndarray, X, bn: int, bm: int, int4: bool):
    """One stage of P1's transposer warpgroup: w's staged rows W (128 k-rows,
    or int4 64 rows of pairs, x bn bytes) and (int4) x's packed rows X (bm x
    64 bytes) -> the swizzled B stage (bn rows of 128 bytes) and (int4) A
    stage, how often each byte was written, and every access by (warp,
    step): {(warp, step): [(lane, kind, byte address)]}."""
    B = np.full(bn * 128, 0x55, np.uint8)
    nb = np.zeros(bn * 128, np.int64)
    A = np.full(bm * 128, 0x55, np.uint8) if int4 else None
    na = np.zeros(bm * 128, np.int64) if int4 else None
    access: dict = {}
    groups = bn // 128
    for t in range(WG):
        rot, lane, warp = (t >> 1) & 3, t & 31, t >> 5
        for it, e in enumerate(range(t, 2 * bn, WG)):
            u, c = 32 * ((e >> 5) % groups) + (e & 31), (e >> 5) // groups
            q = [[0] * 4 for _ in range(4)]
            if int4:
                for h in range(2):
                    rows = [8 * c + 4 * h + j for j in range(4)]
                    P = _transpose4([_word(W[r], 4 * u) for r in rows], rot)
                    for j, r in enumerate(rows):
                        access.setdefault((warp, "w", it, h, j), []).append((lane, r * bn + 4 * u))
                    for i in range(4):
                        q[2 * h][i], q[2 * h + 1][i] = _int4_bytes(P[i])
            else:
                for h in range(4):
                    rows = [16 * c + 4 * h + j for j in range(4)]
                    q[h] = _transpose4([_word(W[r], 4 * u) for r in rows], rot)
                    for j, r in enumerate(rows):
                        access.setdefault((warp, "w", it, h, j), []).append((lane, r * bn + 4 * u))
            for i in range(4):
                addr = common.swizzle128(4 * u + (i ^ rot), c)
                B[addr:addr + 16] = _bytes([q[0][i], q[1][i], q[2][i], q[3][i]])
                nb[addr:addr + 16] += 1
                access.setdefault((warp, "B", it, i), []).append((lane, addr))
        if int4:
            for it, e in enumerate(range(t, 4 * bm, WG)):
                m, c = e >> 2, 2 * (e & 3)
                access.setdefault((warp, "X", it), []).append((lane, m * 64 + 8 * c))
                for half in range(2):  # chunks c and c + 1: 8 packed bytes each
                    lo = _int4_bytes(_word(X[m], 8 * (c + half)))
                    hi = _int4_bytes(_word(X[m], 8 * (c + half) + 4))
                    addr = common.swizzle128(m, c + half)
                    A[addr:addr + 16] = _bytes([lo[0], lo[1], hi[0], hi[1]])
                    na[addr:addr + 16] += 1
                    access.setdefault((warp, "A", it, half), []).append((lane, addr))
    return B, nb, A, na, access


def _unswizzle(tile: np.ndarray, rows: int) -> np.ndarray:
    """A K-major stage of ``rows`` 128-byte rows in the 128-byte swizzle ->
    (rows, 128) int8, k along the row."""
    out = np.empty((rows, 128), np.int8)
    for r in range(rows):
        for kk in range(0, 128, 16):
            a = common.swizzle128(r, kk // 16)
            out[r, kk:kk + 16] = tile[a:a + 16].view(np.int8)
    return out


# the transposer's lines that the mirror above repeats
_TRANSPOSER_LINES = (
    "s1[0] = rot & 2 ? 0x7362u : 0x5140u;",
    "s1[1] = rot & 2 ? 0x5140u : 0x7362u;",
    "s2[0] = rot & 1 ? 0x7632u : 0x5410u;",
    "s2[1] = rot & 1 ? 0x5410u : 0x7632u;",
    "const uint32_t t01 = __byte_perm(L[0], L[1], s1[p]), t23 = __byte_perm(L[2], L[3], s1[p]);",
    "for (int h = 0; h < 2; ++h) out[2 * p + h] = __byte_perm(t01, t23, s2[h]);",
    "const uint32_t e = v ^ 0x88888888u;",
    "const uint32_t lo = ((e & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;",
    "const uint32_t hi = (((e >> 4) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;",
    "return make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));",
    "const int rot = (t >> 1) & 3;",
    "for (int e = t; e < 8 * BN / 4; e += WG_THREADS) {",
    "const int u = 32 * ((e >> 5) % NB) + (e & 31), c = (e >> 5) / NB;",
    "L[j] = *reinterpret_cast<const uint32_t*>(W + (8 * c + 4 * h + j) * BN + 4 * u);",
    "L[j] = *reinterpret_cast<const uint32_t*>(W + (16 * c + 4 * h + j) * BN + 4 * u);",
    "q[2 * h][i] = v.x;",
    "q[2 * h + 1][i] = v.y;",
    "*reinterpret_cast<uint4*>(B + swizzle128(4 * u + (i ^ rot), c)) =",
    "make_uint4(q[0][i], q[1][i], q[2][i], q[3][i]);",
    "for (int e = t; e < 4 * BM; e += WG_THREADS) {",
    "const int m = e >> 2, c = 2 * (e & 3);",
    "const uint4 v = *reinterpret_cast<const uint4*>(X + m * (T::STAGE_K / 2) + 8 * c);",
    "const uint2 a = int4_bytes(v.x), b = int4_bytes(v.y), d = int4_bytes(v.z), f = int4_bytes(v.w);",
    "*reinterpret_cast<uint4*>(A + swizzle128(m, c)) = make_uint4(a.x, a.y, b.x, b.y);",
    "*reinterpret_cast<uint4*>(A + swizzle128(m, c + 1)) = make_uint4(d.x, d.y, f.x, f.y);",
)


def test_the_transposer_mirror_repeats_the_source():
    src = (CSRC / "mxu_probe.cu").read_text()
    for line in _TRANSPOSER_LINES:
        assert line in src, line


@pytest.mark.parametrize("rot", range(4))
def test_transpose4_puts_column_i_xor_rot_in_word_i(rot):
    rows = [0x03020100, 0x13121110, 0x23222120, 0x33323130]  # byte j of row r: 16 r + j
    out = _transpose4(rows, rot)
    for i in range(4):
        col = i ^ rot
        assert out[i] == sum((16 * r + col) << (8 * r) for r in range(4))


@pytest.mark.parametrize("bn", [128, 256])
def test_p1_int8_transposer_is_a_bijection_onto_w_transposed(bn):
    """A stage of 128 k-rows x bn columns of int8 w: every byte of the K-major
    B stage is written exactly once, and unswizzled it is w's stage
    transposed, byte for byte."""
    rng = np.random.default_rng(bn)
    w = rng.integers(-128, 128, (128, bn)).astype(np.int8)
    B, nb, _, _, _ = _transposer_stage(w.view(np.uint8), None, bn, 64, int4=False)
    assert (nb == 1).all()
    np.testing.assert_array_equal(_unswizzle(B, bn), w.T)


@pytest.mark.parametrize("bm,bn", common_tiles := [(128, 128), (64, 128), (256, 128), (128, 256)])
def test_p1_int4_expansion_reproduces_unpack_int4(bm, bn):
    """int4: w's 64 rows of packed pairs x bn columns and x's bm x 64 packed
    bytes: every byte of the K-major B and A stages is written once, and
    they are unpack_int4 of w (transposed) and of x, every value in [-8, 7]."""
    rng = np.random.default_rng(bm + bn)
    wv = torch.from_numpy(rng.integers(-8, 8, (128, bn)).astype(np.int8))
    xv = torch.from_numpy(rng.integers(-8, 8, (bm, 128)).astype(np.int8))
    wp, xp = tmp.pack_int4(wv, 0), tmp.pack_int4(xv, 1)
    assert wp.shape == (64, bn) and xp.shape == (bm, 64)
    B, nb, A, na, _ = _transposer_stage(wp.numpy().view(np.uint8), xp.numpy().view(np.uint8),
                                        bn, bm, int4=True)
    assert (nb == 1).all() and (na == 1).all()
    np.testing.assert_array_equal(_unswizzle(B, bn), tmp.unpack_int4(wp, 0).numpy().T)
    np.testing.assert_array_equal(_unswizzle(A, bm), tmp.unpack_int4(xp, 1).numpy())
    np.testing.assert_array_equal(_unswizzle(A, bm), xv.numpy())


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("bn", [128, 256])
def test_p1_transposer_accesses_are_free_of_bank_conflicts(bn, int4):
    """Each warp's 4-byte reads of a staged row cover 128 contiguous bytes
    (x's 16-byte reads: 512), and each quarter of a warp's 16-byte stores
    (the 8 lanes of one shared-memory wavefront) hits 8 distinct 16-byte
    slots of the 128 bytes the banks span."""
    rng = np.random.default_rng(7)
    w = rng.integers(0, 256, ((64 if int4 else 128), bn)).astype(np.uint8)
    x = rng.integers(0, 256, (128, 64)).astype(np.uint8) if int4 else None
    *_, access = _transposer_stage(w, x, bn, 128, int4)
    for key, acc in access.items():
        lanes = dict(acc)
        assert sorted(lanes) == list(range(32)), key
        if key[1] in ("w", "X"):
            width = 4 if key[1] == "w" else 16
            addrs = sorted(lanes.values())
            assert addrs == list(range(addrs[0], addrs[0] + 32 * width, width)), key
        else:
            for quarter in range(4):
                slots = {lanes[lane] % 128 for lane in range(8 * quarter, 8 * quarter + 8)}
                assert len(slots) == 8, key


# --- P1: the plan ----------------------------------------------------------------

# (BM, BN, int4) -> (stages of the wgmma ring, staging slots)
_S8_DEPTHS = {
    (128, 128, False): (4, 4), (128, 256, False): (3, 2), (256, 128, False): (4, 2),
    (64, 128, False): (4, 4), (128, 128, True): (4, 4), (128, 256, True): (3, 3),
    (256, 128, True): (3, 3), (64, 128, True): (4, 4),
}


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("tiles", tmp.TILES)
def test_every_probe_tiling_has_an_s8_plan_that_fits(tiles, int4):
    bm, bn = tiles
    plan = common.tiled_mm_s8_plan(bm, bn, int4)
    assert (plan["stages"], plan["staging"]) == _S8_DEPTHS[(bm, bn, int4)]
    bf16 = common.tiled_mm_bf16_plan(bm, bn)  # the same consumers
    assert {k: plan[k] for k in ("consumers", "mi", "ni", "acc_per_thread", "threads")} == {
        k: bf16[k] for k in ("consumers", "mi", "ni", "acc_per_thread", "threads")}
    assert plan["consumers"] * plan["mi"] * 64 == bm and plan["ni"] * 128 == bn
    assert plan["threads"] == (plan["consumers"] + 1) * WG <= 384
    assert plan["acc_per_thread"] <= 128  # within the 168 registers of 384 threads
    assert plan["stage_k"] == 128
    assert plan["w_stage_bytes"] == (64 if int4 else 128) * bn
    assert plan["staging_bytes"] == plan["w_stage_bytes"] + (bm * 64 if int4 else 0)
    assert plan["smem"] == common.wgmma_smem_bytes(
        bm, bn, plan["stages"], plan["staging"] * (plan["staging_bytes"] + 8))
    assert plan["smem"] <= common.WGMMA_SMEM_LIMIT
    assert plan["smem"] + BLOCK_RESERVED_BYTES <= SM_SHARED_BYTES
    # one deeper staging ring, or a 4-deep wgmma ring, would not fit
    deeper = common.wgmma_smem_bytes(
        bm, bn, plan["stages"], (plan["staging"] + 1) * (plan["staging_bytes"] + 8))
    assert plan["staging"] == 4 or deeper > common.WGMMA_SMEM_LIMIT
    assert plan["stages"] == 4 or common.wgmma_smem_bytes(
        bm, bn, 4, 2 * (plan["staging_bytes"] + 8)) > common.WGMMA_SMEM_LIMIT


@pytest.mark.parametrize("tiles", [(32, 128), (128, 64), (512, 128), (128, 384)])
def test_tilings_without_an_s8_tile_raise(tiles):
    with pytest.raises(ValueError, match="no s8 wgmma tile"):
        common.tiled_mm_s8_plan(*tiles, False)


def test_the_s8_plan_is_the_kernels_tile():
    """csrc/mxu_probe.cu S8Tile computes its depths, budget and warpgroups by
    the plan's rules, and launches every tiling of TILES with both types."""
    src = (CSRC / "mxu_probe.cu").read_text()
    assert "return qt::wg::smem_bytes(bm, bn, stages, stg * (stg_bytes + 8));" in src
    tile = src[src.index("struct S8Tile {"):]
    tile = tile[:tile.index("};")]
    for line in (
        "static constexpr int STAGE_K = qt::wg::ROW_BYTES;",
        "static constexpr int CONSUMERS = BM >= 128 ? 2 : 1;",
        "static constexpr int MI = BM / 64 / CONSUMERS;",
        "static constexpr int NI = BN / 128;",
        "static constexpr int W_ROWS = INT4 ? STAGE_K / 2 : STAGE_K;",
        "static constexpr int X_BYTES = INT4 ? BM * STAGE_K / 2 : 0;",
        "static constexpr int STAGES = s8_smem(BM, BN, STG_BYTES, 4, 2) <= LIMIT ? 4 : 3;",
        "static constexpr int STG = s8_smem(BM, BN, STG_BYTES, STAGES, 4) <= LIMIT   ? 4",
        ": s8_smem(BM, BN, STG_BYTES, STAGES, 3) <= LIMIT ? 3",
        "static constexpr int THREADS = (CONSUMERS + 1) * qt::wg::WG_THREADS;",
        "static_assert(SMEM <= LIMIT",
    ):
        assert line in tile, line
    for bm, bn in tmp.TILES:
        assert f"if (bm == {bm} && bn == {bn}) return launch_s8_tile<{bm}, {bn}, INT4>" in src
    assert "case 1: return (int)launch_s8<false>(" in src
    assert "case 2: return (int)launch_s8<true>(" in src
    # the ring's barriers: the transposers (and int8 x's TMA), every
    # consumer warp, one TMA per staging slot
    assert "bar_init(&full[s], WG_THREADS + (INT4 ? 0 : 1));" in src
    assert "bar_init(&empty[s], 4 * T::CONSUMERS);" in src
    assert "for (int g = 0; g < T::STG; ++g) bar_init(&landed[g], 1);" in src


def test_no_mma_sync_tile_is_left_for_p1_and_k11():
    """tiled_mm_kernel, ws_gemm and the s4 mma.sync are gone from csrc/; P1
    and K11 reach wgmma; mma_tile.cuh keeps what the streamed schedule uses."""
    for path in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        text = path.read_text()
        assert not re.search(r"\btiled_mm_kernel\b(?!_)", text), path.name
        assert not re.search(r"\bws_gemm\b", text), path.name
        assert "struct S4" not in text and ".s4.s4" not in text, path.name
    probe = (CSRC / "mxu_probe.cu").read_text()
    assert '#include "mma_tile.cuh"' not in probe and "consume<T::STAGES, T::MI, T::NI, 0>(" in probe
    dorefa = (CSRC / "dorefa_gemm.cu").read_text()
    assert "qt::ws::packed_ws_gemm<BITS, R>(xmap, wp, epi, out, M, N, K);" in dorefa
    mma = (CSRC / "mma_tile.cuh").read_text()
    for kept in ("constexpr int STAGE_BYTES = 64;", "constexpr int LDW = 20;", "struct S8 {",
                 "struct BF16 {", "void warp_stage_ldsm(", "void for_each_acc("):
        assert kept in mma, kept


# --- P1: the wrapper against the JAX probe kernel ---------------------------------


def _probe_script():
    """scripts/mxu_probe.py as a module (it has no package to import from)."""
    spec = importlib.util.spec_from_file_location("mxu_probe_script", REPO / "scripts" / "mxu_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tiled_mm(x, w, tiles):
    """scripts/mxu_probe.py's kernel body with the grid and specs of its
    pallas_mm, in interpret mode, int32 accumulator."""
    mp = _probe_script()
    m, k = x.shape
    n = w.shape[1]
    tm, tn, tk = tiles
    return pl.pallas_call(
        functools.partial(mp._mm_kernel, n_k=k // tk, out_dtype=jnp.float32),
        grid=(m // tm, n // tn, k // tk),
        in_specs=[
            pl.BlockSpec((tm, tk), lambda i, j, kk: (i, kk), memory_space=pltpu.VMEM),
            pl.BlockSpec((tk, tn), lambda i, j, kk: (kk, j), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tm, tn), lambda i, j, kk: (i, j), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        scratch_shapes=[pltpu.VMEM((tm, tn), jnp.int32)],
        interpret=True,
    )(x, w)


def _off_by_four(a: torch.Tensor) -> torch.Tensor:
    """a's values in a view 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(a.numel() + 32, dtype=a.dtype)
    start = (-flat.data_ptr()) % 16 + 4
    view = flat[start:start + a.numel()].view(a.shape)
    view.copy_(a)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.parametrize("dtype", ["int8", "int4"])
@pytest.mark.parametrize("tiles", tmp.TILES)
def test_p1_with_a_w_the_card_copies_matches_the_jax_probe_kernel(tiles, dtype):
    """A w only 4-byte aligned (tiled_mm accepts it; on the card it copies w
    into a 16-byte-aligned buffer for TMA, common.int8_rows), every tiling,
    K = 576 (int4 640: a last int8 stage half filled, as TMA zero-fills
    it): the wrapper on the CPU and the copy both give the JAX kernel's
    bits (int4 through its values as int8: the JAX CPU backend cannot
    multiply int4)."""
    bm, bn = tiles
    m, k, n = 256, 576 if dtype == "int8" else 640, 256
    rng = np.random.default_rng(bm * 3 + bn + k)
    lo, hi = (-128, 128) if dtype == "int8" else (-8, 8)
    x = rng.integers(lo, hi, (m, k)).astype(np.int8)
    w = rng.integers(lo, hi, (k, n)).astype(np.int8)
    ref = np.asarray(_jax_tiled_mm(jnp.asarray(x), jnp.asarray(w), (bm, bn, 64)))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if dtype == "int4":
        tx, tw = tmp.pack_int4(tx, 1), tmp.pack_int4(tw, 0)
    wv = _off_by_four(tw)
    copied = common.int8_rows(wv)
    assert copied is not wv and copied.data_ptr() % 16 == 0 and torch.equal(copied, tw)
    for w_in in (wv, copied):
        got = tmp.tiled_mm(tx, w_in, tiles=tiles, int4=dtype == "int4")
        np.testing.assert_array_equal(got.numpy(), ref)


def test_p1_keeps_refusing_what_it_refused():
    x = torch.zeros((128, 64), dtype=torch.int8)
    w = torch.zeros((64, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="does not divide"):
        tmp.tiled_mm(x[:, :32].contiguous(), w[:32].contiguous())
    flat = torch.zeros(64 * 128 + 16, dtype=torch.int8)
    start = (-flat.data_ptr()) % 16 + 2
    with pytest.raises(ValueError, match="aligned"):
        tmp.tiled_mm(x, flat[start:start + 64 * 128].view(64, 128))
    assert tmp.STAGE_K == {"bf16": 32, "int8": 64, "int4": 128}


def test_the_probe_ranks_the_dtypes_by_rate():
    res = {"bf16": {"best_tops": 800.0, "best": "128x256"},
           "int8": {"best_tops": 1100.5, "best": "256x128"},
           "int4": {"best_tops": 950.25, "best": "128x128"}}
    assert tmp.ranking(res) == ("int8 1100.5 T/s (256x128) > int4 950.2 T/s (128x128) > "
                                "bf16 800.0 T/s (128x256)")


# --- K11: the decoder ------------------------------------------------------------


def _centered_bytes(c: int, bits: int) -> int:
    """packed_ws.cuh centered_bytes: four codes -> four bytes 2c - n_w."""
    return ((2 * c + (0x80 - (2**bits - 1)) * 0x01010101) ^ 0x80808080) & MASK32


def _decode_stage(w, S: int, t: int, bits: int):
    """Decoder thread t's stage S of its group at ``bits``: its column's 32
    words -> {byte address in the swizzled weight tile: byte} and the (word,
    field) each byte came from."""
    mask = (2**bits - 1) * 0x01010101
    out, source = {}, {}
    for h in range(2):
        q = [[0] * 4 for _ in range(4)]
        for u in range(4):
            r = 16 * h + 4 * u
            for p in range(4):
                bit = bits * (4 * S + p)
                sel = (bit // 8) | ((bit // 8 + 4) << 4)
                b = _byte_perm(_byte_perm(int(w[r]), int(w[r + 1]), sel),
                               _byte_perm(int(w[r + 2]), int(w[r + 3]), sel), 0x5410)
                q[p][u] = _centered_bytes((b >> (bit % 8)) & mask, bits)
        for p in range(4):
            chunk = _bytes(q[p])
            base = common.swizzle128(t, 2 * p + h)
            for i in range(16):
                out[base + i] = chunk[i]
                u, j = divmod(i, 4)
                source[base + i] = (16 * h + 4 * u + j, 4 * S + p)
    return out, source


@pytest.mark.parametrize("bits,c", [(b, c) for b in (1, 2, 4) for c in range(2**b)])
def test_centered_bytes_carry_nothing(bits, c):
    """Codes c and n_w - c side by side: each byte is its own 2c - n_w."""
    nw = 2**bits - 1
    word = sum(v << (8 * i) for i, v in enumerate((c, nw - c, c, nw)))
    got = _bytes([_centered_bytes(word, bits)]).view(np.int8)
    assert list(got) == [2 * c - nw, nw - 2 * c, 2 * c - nw, nw]


@pytest.mark.parametrize("bits,k,n", [(1, 1500, 130), (2, 1000, 128), (4, 300, 256),
                                      (4, 1024, 130), (2, 128, 10)])
def test_k11_decoder_is_a_bijection_onto_k_major(bits, k, n):
    """Each stage of 128 k: thread t's 32 words of column n0 + t (fields 4S ..
    4S + 3) fill its row of the 128 x 128-byte tile exactly once, and the
    unswizzled row is decode_dorefa_weights_reference's column, rows 128 s
    .. 128 s + 127."""
    rng = np.random.default_rng(bits * 1000 + k + n)
    codes = torch.from_numpy(rng.integers(0, 2**bits, (k, n)).astype(np.int32))
    wp = tpack.pack_bitplanes(codes, bits)
    ref = tpm.decode_dorefa_weights_reference(wp, w_bits=bits).numpy()
    words = wp.numpy().view(np.uint32)
    plan = common.packed_ws_plan(bits, 1)
    stage_k, spg = plan["stage_k"], plan["stages_per_group"]
    assert (stage_k, spg * bits) == (128, 8)
    for n0 in range(0, n, plan["bn"]):
        cols = np.minimum(np.arange(n0, n0 + plan["bn"]), n - 1)  # past N: column N - 1
        for s in range(-(-k // stage_k)):
            g, S = divmod(s, spg)
            tile = np.full(plan["bn"] * 128, 0x55, np.uint8)
            written = np.zeros(plan["bn"] * 128, np.int64)
            for t in range(plan["bn"]):
                row, source = _decode_stage(words[32 * g:32 * g + 32, cols[t]], S, t, bits)
                assert sorted(source.values()) == sorted(
                    (r, 4 * S + p) for p in range(4) for r in range(32))
                for addr, byte in row.items():
                    assert addr // 128 == t
                    tile[addr] = byte
                    written[addr] += 1
            assert (written == 1).all()
            np.testing.assert_array_equal(
                _unswizzle(tile, plan["bn"]), ref[s * stage_k:(s + 1) * stage_k, cols].T)


def test_the_k11_decoder_mirror_repeats_the_source():
    src = (CSRC / "packed_ws.cuh").read_text()
    for line in ("constexpr uint32_t MASK = ((1u << BITS) - 1) * 0x01010101u;",
                 "const int bit = BITS * (4 * S + p);",
                 "const uint32_t sel = (bit / 8) | ((bit / 8 + 4) << 4);",
                 "q[p][u] = centered_bytes<BITS>((b >> (bit % 8)) & MASK);",
                 "return (2 * c + (0x80u - NW) * 0x01010101u) ^ 0x80808080u;",
                 "static constexpr int SPG = 32 * GROUP_ROWS / BITS / STAGE_K;"):
        assert line in src, line


# --- K11: the plan and the wrapper ------------------------------------------------


@pytest.mark.parametrize("m_tiles", common.WS_M_TILES)
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_every_bits_and_m_tiles_has_a_packed_ws_plan_that_fits(bits, m_tiles):
    plan = common.packed_ws_plan(bits, m_tiles)
    assert plan == dict(common.binary_ws_plan(m_tiles), stages_per_group=8 // bits)
    assert plan["stages_per_group"] * plan["stage_k"] == tpack.planar_group_k(bits)
    assert plan["smem"] == common.wgmma_smem_bytes(plan["bm"], 128, plan["stages"], 0)
    assert plan["smem"] <= common.WGMMA_SMEM_LIMIT
    assert plan["blocks_per_sm"] * (plan["smem"] + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert plan["blocks_per_sm"] * plan["threads"] * 64 <= 65536


@pytest.mark.parametrize("bits", [3, 8])
def test_packed_ws_plan_refuses_other_bits(bits):
    with pytest.raises(ValueError, match="bits"):
        common.packed_ws_plan(bits, 2)


def test_the_k11_library_takes_the_pitch():
    """qt_dorefa_gemm_ws takes x's row pitch after K, as the wrapper passes
    it (through common.int8_rows), and refuses what TMA cannot read."""
    src = (CSRC / "dorefa_gemm.cu").read_text()
    assert ('extern "C" int qt_dorefa_gemm_ws(const void* x, const void* wp, void* out, int M, '
            'int N, int K,\n                                 int pitch, int R, int bits, float '
            'inv_scale, int m_tiles,\n                                 int device, void* stream)'
            ) in src
    assert "pitch < K || pitch % 16 || reinterpret_cast<uintptr_t>(x) % 16" in src
    wrapper = (Path(tpm.__file__)).read_text()
    assert "xq = int8_rows(a_codes)" in wrapper
    assert "_build.ptr(xq), _build.ptr(w_packed), _build.ptr(out), m, n, k, xq.shape[1], r," in wrapper


def _codes_and_words(rng, m, k, n, w_bits, a_bits, zeros=False):
    a = rng.integers(0, 2**a_bits, (m, k)).astype(np.int8)
    if zeros:
        a[:] = 0
    c = rng.integers(0, 2**w_bits, (k, n)).astype(np.int32)
    wp = tpack.pack_bitplanes(torch.from_numpy(c), w_bits)
    return a, wp


@pytest.mark.parametrize("m_tiles", common.WS_M_TILES)
@pytest.mark.parametrize("w_bits,a_bits", [(1, 2), (2, 2), (4, 4)])
@pytest.mark.parametrize("m,k,n", [(65, 300, 130), (1, 27, 10), (257, 1500, 64)])
def test_k11_ragged_shapes_match_jax_at_every_bits_and_m_tiles(m, k, n, w_bits, a_bits, m_tiles):
    """Ragged M, N and K (K off the 128-deep stage, the 16-byte pitch and
    the group) through the wrapper on the CPU, whatever m_tiles: bit for
    bit the JAX dorefa_gemm_ws in interpret mode on the same words, and
    the port's dorefa_gemm plain version."""
    rng = np.random.default_rng(m * 7 + k + n + w_bits)
    a, wp = _codes_and_words(rng, m, k, n, w_bits, a_bits)
    words = wp.numpy().view(np.uint32)
    ref = np.asarray(jpm.dorefa_gemm_ws(jnp.asarray(a), jnp.asarray(words), w_bits=w_bits,
                                        a_bits=a_bits, tiles=(128, 128, 1024), interpret=True))
    got = tpm.dorefa_gemm_ws(torch.from_numpy(a), wp, w_bits=w_bits, a_bits=a_bits,
                             m_tiles=m_tiles)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), tpm.dorefa_gemm_reference(torch.from_numpy(a), wp, w_bits=w_bits,
                                               a_bits=a_bits).numpy())


@pytest.mark.parametrize("w_bits", [1, 2, 4])
def test_k11_zero_activations_give_zeros(w_bits):
    rng = np.random.default_rng(w_bits)
    a, wp = _codes_and_words(rng, 200, 300, 130, w_bits, 2, zeros=True)
    got = tpm.dorefa_gemm_ws(torch.from_numpy(a), wp, w_bits=w_bits, a_bits=2)
    assert not got.any()


# --- the decode-cost bench --------------------------------------------------------


def test_the_decode_cost_variants_edit_k11s_source():
    """K11 shares K10's decoder in csrc/packed_ws.cuh and builds from
    dorefa_gemm.cu: the no-decode variant writes no weight tile, the
    instrumented one counts."""
    k = ws_decode_cost.KERNELS["dorefa_gemm_ws"]
    assert (k["library"], k["source"]) == ("dorefa_gemm", "packed_ws.cuh")
    src = (CSRC / k["source"]).read_text()
    v = ws_decode_cost.variants(src, "dorefa_gemm_ws")
    assert "centered_bytes<BITS>((b >>" not in v["no_decode"]
    assert v["instrumented"].count("clock64()") == 5
    assert v["instrumented"].index("__device__ unsigned long long qt_decode_cycles[4];") < \
        v["instrumented"].index("namespace qt {")


@pytest.mark.parametrize("kernel", ["tiled_mm_int8", "tiled_mm_int4"])
def test_the_decode_cost_variants_edit_p1s_transposer(kernel):
    """P1's variants edit csrc/mxu_probe.cu's transposer: the no-transpose
    build writes neither B nor int4's A but keeps the staging loads, the
    waits and the arrivals; the instrumented one times both waits."""
    src = (CSRC / "mxu_probe.cu").read_text()
    v = ws_decode_cost.variants(src, kernel)
    assert v["kernel"] == src
    nd = v["no_decode"]
    assert "transpose(" not in nd.split("auto stage = [&](int s) {")[1].split("};")[0]
    assert "int4_bytes(v.x)" not in nd
    assert nd.count("bar_arrive(&full[slot]);") == 1 and "fetch(s + T::STG)" in nd
    inst = v["instrumented"]
    assert inst.count("clock64()") == 5
    c0 = inst.index("const long long c0 = clock64();")
    assert c0 < inst.index("bar_wait(&landed[g]") < inst.index("const long long c1 = clock64();")
    assert ws_decode_cost.configs(kernel) == tmp.TILES
    assert ws_decode_cost.configs("dorefa_gemm_ws") == common.WS_M_TILES
    with pytest.raises(ValueError, match="mxu_probe.cu: expected the line"):
        ws_decode_cost.variants(src.replace("fetch(s + T::STG);", "fetch(s);"), kernel)
