"""PyTorch port, the Hopper tile (csrc/wgmma_tile.cuh) of shift_gemm_ws (K12),
the probe's bf16 tiled_mm (P1) and, on its s8 path, binary_gemm_ws (K10), on
the CPU.

The CUDA kernels run on the card only (chip_smoke.py holds them against
their plain versions). Here: the Python side of their launch, which the CUDA
sources mirror (the launch plans, the shared-memory budget that the
kernels static_assert, the 128-byte swizzle), and the wrappers' unchanged
contract on the CPU against the JAX package's shift_gemm_ws in Pallas
interpret mode, inputs made with numpy from a seed.
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu_torch.bench import common as bench_common
from pytorch_quantize_impls_tpu_torch.bench import mxu_probe as tmp
from pytorch_quantize_impls_tpu_torch.bench import ws_decode_cost
from pytorch_quantize_impls_tpu_torch.kernels import common
from pytorch_quantize_impls_tpu_torch.kernels import shift_matmul as tsm

jsm = sys.modules["pytorch_quantize_impls_tpu.kernels.shift_matmul"]

CSRC = Path(tsm.__file__).resolve().parent.parent / "csrc"
SM_SHARED_BYTES = 233472  # an H100 SM's 228 KB of shared memory
BLOCK_RESERVED_BYTES = 1024  # shared memory the hardware keeps per block


def _header_constant(name: str, path: Path = CSRC / "wgmma_tile.cuh") -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, f"{name} not in {path.name}"
    return int(m.group(1))


@pytest.mark.parametrize("name,value", [
    ("STAGE_K", common.WGMMA_STAGE_K), ("ROW_BYTES", common.WGMMA_ROW_BYTES),
    ("ATOM_BYTES", common.WGMMA_ATOM_BYTES), ("SMEM_LIMIT", common.WGMMA_SMEM_LIMIT),
    ("WG_THREADS", common.WGMMA_WG_THREADS),
])
def test_the_header_has_the_python_constants(name, value):
    assert _header_constant(name) == value


def test_the_header_budget_is_the_python_budget():
    """csrc/wgmma_tile.cuh smem_bytes, term by term, is wgmma_smem_bytes."""
    text = (CSRC / "wgmma_tile.cuh").read_text()
    assert ("return ATOM_BYTES + stages * (a_rows + b_rows) * ROW_BYTES + extra + 2 * stages * 8;"
            in text)
    assert common.wgmma_smem_bytes(64, 128, 4, 0) == 1024 + 4 * 192 * 128 + 64
    assert common.wgmma_smem_bytes(0, 0, 3, 100) == 1024 + 100 + 48


@pytest.mark.parametrize("m_tiles", common.WS_M_TILES)
def test_every_m_tiles_has_a_shift_ws_plan_that_fits(m_tiles):
    plan = common.shift_ws_plan(m_tiles)
    assert plan["bm"] == 64 * m_tiles and plan["bn"] == common.SHIFT_WS_BN == 128
    assert plan["consumers"] == m_tiles
    assert plan["threads"] == (m_tiles + 1) * 128  # one decoder warpgroup
    assert plan["bm"] <= 256  # a TMA box has at most 256 rows
    assert plan["smem"] == common.wgmma_smem_bytes(plan["bm"], 128, plan["stages"], 0)
    assert plan["smem"] <= common.WGMMA_SMEM_LIMIT
    assert plan["blocks_per_sm"] * (plan["smem"] + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    # the register file holds the blocks an SM runs at once
    assert plan["blocks_per_sm"] * plan["threads"] * 64 <= 65536


def test_the_shift_ws_plan_is_the_kernels_tile():
    """csrc/shift_gemm.cu ShiftWsTile has the plan's stages, blocks per SM,
    column width and thread count."""
    text = (CSRC / "shift_gemm.cu").read_text()
    tile = text[text.index("struct ShiftWsTile {"):]
    tile = tile[:tile.index("};")]
    assert "static constexpr int BN = 128;" in tile
    assert "static constexpr int STAGES = 4;" in tile
    assert "static constexpr int BLOCKS = R == 1 ? 2 : 1;" in tile
    assert "static constexpr int THREADS = (R + 1) * qt::wg::WG_THREADS;" in tile
    assert "smem_bytes(64 * R, BN, STAGES, 0)" in tile
    assert {common.shift_ws_plan(r)["blocks_per_sm"] for r in common.WS_M_TILES} == {1, 2}
    assert common.shift_ws_plan(1)["blocks_per_sm"] == 2


@pytest.mark.parametrize("m_tiles", common.WS_M_TILES)
def test_every_m_tiles_has_a_binary_ws_plan_that_fits(m_tiles):
    """K10's s8 tile: 128-byte stages of 128 int8 of k, 8 to a 1024-row packed
    group, one consumer warpgroup per 64-row M-tile, at most two (two M-tiles
    each at m_tiles 4), and one decoder warpgroup of a thread per column."""
    plan = common.binary_ws_plan(m_tiles)
    assert plan["bm"] == 64 * m_tiles and plan["bn"] == common.SHIFT_WS_BN == 128
    assert plan["stage_k"] == common.WGMMA_ROW_BYTES == 128
    assert plan["stages_per_group"] * plan["stage_k"] == 1024
    assert plan["consumers"] == min(m_tiles, 2) and plan["consumers"] * plan["mi"] == m_tiles
    assert plan["threads"] == (plan["consumers"] + 1) * 128 <= 384
    assert plan["bn"] == common.WGMMA_WG_THREADS
    assert plan["bm"] <= 256  # a TMA box has at most 256 rows
    assert plan["smem"] == common.wgmma_smem_bytes(plan["bm"], 128, plan["stages"], 0)
    assert plan["smem"] <= common.WGMMA_SMEM_LIMIT
    assert plan["blocks_per_sm"] * (plan["smem"] + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert plan["blocks_per_sm"] * plan["threads"] * 64 <= 65536


def test_the_binary_ws_plan_is_the_kernels_tile():
    """csrc/packed_ws.cuh PackedWsTile, which csrc/xnor_gemm.cu's K10 runs at
    one bit, has the plan's stage depth, stages, blocks per SM, column width
    and thread count, and static_asserts them."""
    text = (CSRC / "packed_ws.cuh").read_text()
    tile = text[text.index("struct PackedWsTile {"):]
    tile = tile[:tile.index("};")]
    assert "static constexpr int BN = 128;" in tile
    assert "static constexpr int STAGE_K = wg::ROW_BYTES;" in tile
    assert "static constexpr int STAGES = 4;" in tile
    assert "static constexpr int BLOCKS = R == 1 ? 2 : 1;" in tile
    assert "static constexpr int CONSUMERS = R < 2 ? R : 2;" in tile
    assert "static constexpr int MI = R / CONSUMERS;" in tile
    assert "static constexpr int THREADS = (CONSUMERS + 1) * wg::WG_THREADS;" in tile
    assert "smem_bytes(64 * R, BN, STAGES, 0)" in tile
    assert "static_assert(SPG * BITS == 8 && BN == wg::WG_THREADS" in tile
    assert "BLOCKS * (SMEM + 1024) <= 233472" in tile
    assert "qt::ws::packed_ws_gemm<1, R>(xmap, wp, epi, out, M, N, K);" in (
        CSRC / "xnor_gemm.cu").read_text()
    assert [common.binary_ws_plan(r)["blocks_per_sm"] for r in common.WS_M_TILES] == [2, 1, 1]


def test_the_header_has_an_s8_path():
    """wgmma_tile.cuh's s8 product (m64n128k32, s32 accumulators, both
    operands K-major: PTX allows no transpose for .s8), picked by the
    accumulator's type, and its uint8 tensor map; a stage is four 32-byte
    k-steps for either type."""
    text = (CSRC / "wgmma_tile.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " in text
    assert "void mma_k_step(int32_t (&d)[64], uint64_t da, uint64_t db)" in text
    assert 'static_assert(TRANS_B == 0, "wgmma has no transpose for s8: B is K-major");' in text
    assert "CU_TENSOR_MAP_DATA_TYPE_UINT8" in text
    assert "for (int ks = 0; ks < K_STEPS; ++ks)" in text
    assert _header_constant("K_STEPS") * 32 == common.WGMMA_ROW_BYTES
    src = (CSRC / "packed_ws.cuh").read_text()
    assert "wg::tile_map(&xmap, 1, x, M, K, pitch, 64 * R, T::STAGE_K)" in src
    assert "int32_t acc[T::MI][1][64];" in src


@pytest.mark.parametrize("m_tiles", [0, 3, 8])
def test_binary_ws_plan_refuses_other_m_tiles(m_tiles):
    with pytest.raises(ValueError, match="m_tiles"):
        common.binary_ws_plan(m_tiles)


def test_binary_gemm_ws_default_m_tiles_is_in_the_set():
    assert common.WS_DEFAULT_M_TILES["binary_gemm_ws"] in common.WS_M_TILES


@pytest.mark.parametrize("tiles", tmp.TILES)
def test_every_probe_tiling_has_a_bf16_plan_that_fits(tiles):
    bm, bn = tiles
    plan = common.tiled_mm_bf16_plan(bm, bn)
    assert plan["consumers"] * plan["mi"] * 64 == bm
    assert plan["ni"] * 128 == bn
    assert plan["acc_per_thread"] <= 128
    assert plan["threads"] == (plan["consumers"] + 1) * 128
    assert plan["smem"] == common.wgmma_smem_bytes(bm, bn, plan["stages"], 0)
    assert plan["smem"] <= common.WGMMA_SMEM_LIMIT


@pytest.mark.parametrize("tiles", [(32, 128), (128, 64), (512, 128), (192, 128)])
def test_tilings_without_a_bf16_tile_raise(tiles):
    with pytest.raises(ValueError, match="no bf16 wgmma tile"):
        common.tiled_mm_bf16_plan(*tiles)


@pytest.mark.parametrize("m_tiles", [0, 3, 8])
def test_shift_ws_plan_refuses_other_m_tiles(m_tiles):
    with pytest.raises(ValueError, match="m_tiles"):
        common.shift_ws_plan(m_tiles)


@pytest.mark.parametrize("rows", [8, 64, 256])
def test_swizzle128_is_a_bijection_on_a_stage(rows):
    """A stage of ``rows`` 128-byte rows: every 16-byte chunk lands on a
    distinct 16-byte slot of the stage, inside its own row, and the 8 rows of
    an atom put a given chunk in 8 different slots (no bank conflicts)."""
    offs = np.array([[common.swizzle128(r, c) for c in range(8)] for r in range(rows)])
    assert (offs % 16 == 0).all()
    assert sorted(offs.ravel() // 16) == list(range(rows * 8))
    assert ((offs // 128) == np.arange(rows)[:, None]).all()
    for a in range(0, rows, 8):
        for c in range(8):
            assert len({offs[r, c] % 128 for r in range(a, a + 8)}) == 8


def test_swizzle128_matches_the_header():
    text = (CSRC / "wgmma_tile.cuh").read_text()
    assert "return row * ROW_BYTES + ((chunk ^ (row & 7)) << 4);" in text
    assert common.swizzle128(9, 3) == 9 * 128 + ((3 ^ 1) << 4)


def _log_weights(rng, k, n, fsr, bits):
    w = rng.normal(size=(k, n)).astype(np.float32) * np.float32((2.0 / k) ** 0.5)
    return jsm.pack_log_weights(jnp.asarray(w), fsr, bits)


@pytest.mark.parametrize("m_tiles", common.WS_M_TILES)
@pytest.mark.parametrize("m,k,n,fsr,bits", [
    (65, 300, 130, 1.0, 4), (1, 27, 10, 0.0, 3), (257, 500, 64, 1.0, 6),
])
def test_shift_gemm_ws_ragged_shapes_match_jax_at_every_m_tiles(m, k, n, fsr, bits, m_tiles):
    """Ragged M, N and K (K off the 128-row group, N off the 128-column
    tile, M off every M-tile height) through the wrapper on the CPU: the
    plain version, whatever m_tiles, against JAX's shift_gemm_ws in interpret
    mode within 1e-5 (|bf16(x)| @ |w|) (JAX sums in float32)."""
    rng = np.random.default_rng(m * 7 + k + n + bits)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wp = _log_weights(rng, k, n, fsr, bits)
    ref = np.asarray(jsm.shift_gemm_ws(jnp.asarray(x), wp, fsr=fsr, bits=bits,
                                       tiles=(128, 128, 1024), interpret=True))
    twp = torch.from_numpy(np.array(wp).view(np.int32))
    tx = torch.from_numpy(x)
    got = tsm.shift_gemm_ws(tx, twp, fsr=fsr, bits=bits, m_tiles=m_tiles)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, tsm.shift_gemm_ws_reference(tx, twp, fsr=fsr, bits=bits))
    wd = tsm.decode_log_weights(twp, fsr=fsr, bits=bits)[:k].to(torch.float64)
    bound = (tx.to(torch.bfloat16).to(torch.float64).abs() @ wd.abs()).numpy()
    assert (np.abs(got.numpy().astype(np.float64) - ref) <= 1e-5 * bound).all()


def test_shift_gemm_ws_default_m_tiles_is_in_the_set():
    assert common.WS_DEFAULT_M_TILES["shift_gemm_ws"] in common.WS_M_TILES


@pytest.mark.parametrize("k", [8, 64, 300, 1, 27])
def test_bf16_rows_give_tma_a_pitch_of_eight(k):
    """x rounded to bf16 as the kernel's TMA reads it: a 16-byte-aligned row
    pitch of K rounded up to 8, the first K columns x's bf16 values."""
    x = torch.from_numpy(np.random.default_rng(k).normal(size=(5, k)).astype(np.float32))
    xb = tsm._bf16_rows(x)
    assert xb.dtype == torch.bfloat16 and xb.shape == (5, -(-k // 8) * 8)
    assert xb.is_contiguous() and xb.data_ptr() % 16 == 0
    assert torch.equal(xb[:, :k], x.to(torch.bfloat16))


def test_bf16_rows_keep_aligned_bf16_input():
    xb = torch.ones(4, 16, dtype=torch.bfloat16)
    assert tsm._bf16_rows(xb) is xb
    view = torch.ones(4 * 16 + 4, dtype=torch.bfloat16)[4:].view(4, 16)  # 8 bytes off
    out = tsm._bf16_rows(view)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, view)


def test_tiled_mm_bf16_needs_a_16_byte_aligned_w():
    """TMA reads the bf16 w: a view 8 bytes off raises where an int8 one, read
    four bytes at a time, does not."""
    x = torch.ones(128, 128, dtype=torch.bfloat16)
    w = torch.ones(128 * 128 + 4, dtype=torch.bfloat16)[4:].view(128, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tmp.tiled_mm(x, w)
    w8 = torch.ones(128 * 128 + 8, dtype=torch.int8)[8:].view(128, 128)
    out = tmp.tiled_mm(torch.ones(128, 128, dtype=torch.int8), w8)
    assert torch.equal(out, torch.full((128, 128), 128.0))


def test_the_bf16_yardstick_computes_the_same_product():
    """bench.mxu_probe's bf16 library call (torch.mm with a float32 output
    where this torch has it, else bf16 torch.matmul) and its name."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(32, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32)).to(torch.bfloat16)
    f32 = bench_common.mm_f32_out_supported(x.device)
    assert isinstance(f32, bool)
    name = tmp.library_name("bf16", x)
    assert name == ("torch.mm out_dtype=float32" if f32 else "torch.matmul bf16")
    got = tmp.library_call("bf16", x, w)()
    ref = x.double() @ w.double()
    tol = 2**-7 if got.dtype == torch.bfloat16 else 1e-5
    assert ((got.double() - ref).abs() <= tol * (x.double().abs() @ w.double().abs())).all()
    assert tmp.library_name("int8", x) == "torch._int_mm"
    assert tmp.library_name("int4", x) == "none"


def test_the_decode_cost_variants_edit_the_kernel_source():
    """bench/ws_decode_cost.py builds its variants by editing
    csrc/shift_gemm.cu's decoder; the lines it edits are still there, the
    no-decode variant writes no weight tile, the instrumented one counts."""
    src = (CSRC / "shift_gemm.cu").read_text()
    v = ws_decode_cost.variants(src)
    assert v["kernel"] == src
    assert "log_bf16_pair(__byte_perm" in src and "log_bf16_pair(__byte_perm" not in v["no_decode"]
    assert v["no_decode"].count("bar_arrive(&full[slot]);") == 1
    assert v["instrumented"].count("clock64()") == 5
    assert 'extern "C" int qt_read_cycles' in v["instrumented"]
    with pytest.raises(ValueError, match="expected the line"):
        ws_decode_cost.variants(src.replace("fence_async_shared();", ""))


def test_the_decode_cost_variants_edit_k10s_source():
    """bench/ws_decode_cost.py's variants of K10's decoder, in
    csrc/packed_ws.cuh: the no-decode one writes no weight tile, the
    instrumented one counts."""
    src = (CSRC / "packed_ws.cuh").read_text()
    v = ws_decode_cost.variants(src, "binary_gemm_ws")
    assert v["kernel"] == src
    assert "centered_bytes<BITS>((b >>" in src
    assert "centered_bytes<BITS>((b >>" not in v["no_decode"]
    assert v["no_decode"].count("bar_arrive(&full[slot]);") == 1
    assert v["instrumented"].count("clock64()") == 5
    assert 'extern "C" int qt_read_cycles' in v["instrumented"]
    assert {"shift_gemm_ws", "binary_gemm_ws"} <= set(ws_decode_cost.KERNELS)
    with pytest.raises(ValueError, match="packed_ws.cuh: expected the line"):
        ws_decode_cost.variants(src.replace("T::SPG * (g + 1) < stages", "0"), "binary_gemm_ws")


def test_the_decode_cost_bench_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="times the card"):
        ws_decode_cost.run("cpu")
