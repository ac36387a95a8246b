"""The int8 tensor-core schedule of K3 ``int8_gemm`` and K5 ``int8_conv2d``
(``csrc/stream_tile.cuh`` with raw int8 weights), on the CPU.

The CUDA kernels cannot run here. What they compute is mirrored in numpy,
step for step, and held to the plain versions and to the JAX package:

- the launch plans (``kernels/common.py`` ``stream_plan`` for K3,
  ``conv_plan`` for K5) at every shape the port gives the two kernels,
  against the constants of the CUDA sources and the H100's shared memory;
- K3's split over K: int32 partial sums per chunk of whole 64-deep stages
  (zero-filled past K), summed in index order, then the f32 epilogue;
- the stage transpose to K-major (``transpose_stage``: 4 x 4 byte transposes
  with ``__byte_perm``'s selectors, each 32-thread block's units);
- K5's implicit-GEMM gather: the per-row pixel table and one (tap, 64
  channels) stage at a time, summed over the stages, against
  ``int8_conv2d_reference`` and ``lax.conv_general_dilated(...,
  preferred_element_type=int32)`` as the JAX package's direct conv calls it.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu.kernels import int8_matmul as jim
from pytorch_quantize_impls_tpu_torch.bench import int8_tc_cost, kernel_bench
from pytorch_quantize_impls_tpu_torch.kernels import common
from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as tic
from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as tim
from pytorch_quantize_impls_tpu_torch.kernels.conv import conv_pads

jconv = sys.modules["pytorch_quantize_impls_tpu.kernels.conv"]
CSRC = Path(tim.__file__).resolve().parent.parent / "csrc"
STAGE = common.STREAM_STAGE_BYTES


def _constant(name: str, path: Path) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, f"{name} not in {path.name}"
    return int(m.group(1))


# --- the launch plans -----------------------------------------------------------

# (label, M, K, N): every shape the port's paths and chip_smoke.py give K3
K3_SHAPES = (
    [(f"lenet {name} M={m}", m, k, n) for name, k, n in (("fc1", 4096, 1024), ("head", 1024, 10))
     for m in (1, 16, 256)]
    + [(f"lm {name} M={m}", m, k, n) for name, k, n in chip_smoke.lm_gemms(chip_smoke.LM_CFG)
       for m in (1, 32)]
    + [("headline 4096^3", 4096, 4096, 4096),
       ("edge M=33 K=300 N=130", 33, 300, 130), ("edge M=255 K=2100 N=257", 255, 2100, 257),
       ("edge M=1 K=1000 N=10", 1, 1000, 10), ("edge M=17 K=301 N=64", 17, 301, 64),
       ("edge M=32 K=1024 N=256", 32, 1024, 256), ("edge M=8 K=1028 N=260", 8, 1028, 260)]
)

# (label, batch, size, cin, cout, kernel, strides, padding): K5's
K5_SHAPES = (
    [(f"resnet b={b} {label}", b, h, cin, cout, 3, (s, s), "SAME")
     for label, h, cin, cout, s in chip_smoke.resnet_convs() for b in (1, 256)]
    + [("bnn_lenet conv2", 256, 12, 128, 256, 5, (1, 1), "VALID"),
       ("edge C=5 N=7 VALID", 1, 3, 5, 7, 3, (1, 1), "VALID"),
       ("edge 5x5 C=6 N=10", 2, 12, 6, 10, 5, (1, 1), "VALID"),
       ("edge 1x1 s2 C=12 N=20", 3, 9, 12, 20, 1, (2, 2), "SAME"),
       ("edge s2 C=64 N=130", 2, 15, 64, 130, 3, (2, 2), "SAME"),
       ("edge s2 C=3 N=65", 2, 16, 3, 65, 3, (2, 2), "SAME"),
       ("edge pads s(2,1) C=33 N=70", 2, 15, 33, 70, 3, (2, 1), ((1, 2), (0, 1))),
       ("edge ties C=16 N=20", 2, 8, 16, 20, 3, (1, 1), "SAME")]
)


def test_the_sources_have_the_python_constants():
    mma, stream = CSRC / "mma_tile.cuh", CSRC / "stream_tile.cuh"
    assert _constant("STAGE_BYTES", mma) == common.STREAM_STAGE_BYTES == tim.STAGE_K
    assert _constant("LDW", mma) == common.STREAM_LDW
    assert _constant("RING", stream) == common.STREAM_RING
    assert _constant("RAW_PAD", stream) == common.STREAM_RAW_PAD
    assert _constant("BN", stream) == common.STREAM_BN
    assert _constant("SMEM_LIMIT", stream) == common.STREAM_SMEM_LIMIT == 232448
    conv = (CSRC / "int8_conv.cu").read_text()
    assert _constant("CONV_BM", CSRC / "int8_conv.cu") == common.CONV_BM
    # the blocks per SM of conv_plan are the kernel's launch bounds
    assert "__launch_bounds__(THREADS, BN_ == 64 ? 3 : 2)" in conv
    assert [common.conv_plan(128, n)["blocks_per_sm"] for n in (64, 128)] == [3, 2]
    # the budget's formula is the header's
    text = stream.read_text()
    assert "RING * A_WORDS + (size_t)W_SLOTS * W_SLOT_WORDS" in text
    assert "using BytesTile = Tile<BM, BN_, BM * LDW, RING, raw_stage_words(BN_), false>" in text
    assert "return (bn + RAW_PAD) / 4;" in text


@pytest.mark.parametrize("label,m,k,n", K3_SHAPES, ids=[s[0] for s in K3_SHAPES])
def test_k3_plan_at_the_ports_shapes(label, m, k, n):
    bm, s, chunk = common.stream_plan(m, n, k, tim.STAGE_K)
    stages = -(-k // STAGE)
    big = -(-m // 128) * -(-n // common.STREAM_BN) >= 2 * common.STREAM_SMS
    assert bm == (32 if m <= 32 else 128 if big else 64)
    assert chunk % STAGE == 0 and (s - 1) * chunk < stages * STAGE <= s * chunk
    assert common.bytes_tile_smem(bm, common.STREAM_BN) <= common.STREAM_SMEM_LIMIT
    assert common.stream_workspace_bytes(m, n, s) <= common.STREAM_WORKSPACE_CAP
    if label.startswith("edge"):
        assert s > 1, "chip_smoke.py's K3 edges split K"
    if label == "lm ffn_out M=32":
        assert (bm, s, chunk) == (32, 10, 7 * STAGE)  # 16 tiles, 10 chunks of 7 stages
    if label.startswith("headline"):
        assert (bm, s) == (128, 1)


def test_the_raw_tile_budgets():
    """Every BytesTile the sources instantiate fits the H100's dynamic shared
    memory: K3's three heights at 64 columns, K5's two widths at 128 rows
    with the per-row table, two of K5's blocks per SM."""
    for bm in (32, 64, 128):
        assert common.bytes_tile_smem(bm, 64) <= common.STREAM_SMEM_LIMIT
    for bn in common.CONV_BNS:
        plan = common.conv_plan(common.CONV_BM, bn)
        assert plan["bn"] == bn
        assert plan["blocks_per_sm"] * (plan["smem"] + 1024) <= 233472
    # the staged output tile (f32 rows of BN + 8) fits in the ring it reuses
    for bn in common.CONV_BNS:
        assert common.CONV_BM * (bn + 8) * 4 <= common.bytes_tile_smem(common.CONV_BM, bn)
    assert common.bytes_tile_smem(128, 128) == 98304


@pytest.mark.parametrize("case", K5_SHAPES, ids=[c[0] for c in K5_SHAPES])
def test_k5_plan_at_the_ports_shapes(case):
    label, b, h, cin, cout, k, strides, padding = case
    pads = conv_pads(padding, (h, h), (k, k), strides)
    ho, wo = tic.out_size(h, k, strides[0], pads[0]), tic.out_size(h, k, strides[1], pads[1])
    m = b * ho * wo
    plan = common.conv_plan(m, cout)
    assert plan["bm"] == common.CONV_BM
    assert plan["bn"] == (64 if cout <= 64 else 128) and plan["bn"] in common.CONV_BNS
    assert plan["grid"] == (-(-m // common.CONV_BM), -(-cout // plan["bn"]))
    assert plan["grid"][1] <= 65535  # N tiles on the grid's y
    assert plan["smem"] == common.bytes_tile_smem(128, plan["bn"]) + 3 * 128 * 4
    assert plan["blocks_per_sm"] * (plan["smem"] + 1024) <= 233472
    if b == 256 and not label.startswith("edge"):
        # no split over K: 256 to 2048 tiles, every SM takes at least one
        assert plan["grid"][0] * plan["grid"][1] >= 256 > common.STREAM_SMS


# --- K3: the split over K -------------------------------------------------------

def _k3_mirror(x, w, alpha, row, plan):
    """int8_gemm as the kernel runs it: each split z sums its chunk of whole
    stages (zero-filled past K) into an int32 partial tile; the partials are
    summed in index order (int8_gemm_kernel_sum), then f32(acc) * alpha[n]
    * row_scale[m]."""
    m, k = x.shape
    n = w.shape[1]
    _, s, chunk = plan
    kp = -(-k // STAGE) * STAGE
    xp = np.zeros((m, kp), np.int64)
    xp[:, :k] = x
    wpad = np.zeros((kp, n), np.int64)
    wpad[:k] = w
    acc = np.zeros((m, n), np.int32)
    for z in range(s):
        k0, k1 = z * chunk, min((z + 1) * chunk, kp)
        part = (xp[:, k0:k1] @ wpad[k0:k1]).astype(np.int32)
        acc = acc + part
    out = acc.astype(np.float32)
    if alpha is not None:
        out = out * alpha[None, :]
    if row is not None:
        out = out * row[:, None]
    return out


@pytest.mark.parametrize("m,k,n,scales", [
    (17, 301, 64, "alpha+row"), (1, 1000, 10, "row"), (33, 300, 130, "alpha+row"),
    (64, 2100, 130, "alpha"), (32, 4096, 72, "none"), (5, 1028, 260, "alpha+row"),
])
def test_k3_split_matches_plain_and_jax(m, k, n, scales):
    rng = np.random.default_rng(m * k + n)
    x = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    alpha = rng.uniform(0.5, 1.5, n).astype(np.float32) if "alpha" in scales else None
    row = rng.uniform(0.5, 1.5, m).astype(np.float32) if "row" in scales else None
    plan = common.stream_plan(m, n, k, tim.STAGE_K)
    assert plan[1] > 1, "the case must split K"
    got = _k3_mirror(x, w, alpha, row, plan)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    plain = tim.int8_gemm_reference(t(x), t(w), t(alpha), t(row)).numpy()
    np.testing.assert_array_equal(got, plain)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = np.asarray(jim.int8_gemm(j(x), j(w), j(alpha), j(row)))
    np.testing.assert_array_equal(got, ref)


# --- the stage transpose --------------------------------------------------------

def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte i is byte (s >> 4i) & 7 of y:x."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


# transpose_stage's lines that the mirror below repeats, word for word
_TRANSPOSE_LINES = (
    "const int lane = threadIdx.x & 31, rr = (lane >> 3) & 2, rot = (lane >> 1) & 3;",
    "const uint32_t s1[2] = {rot & 2 ? 0x7362u : 0x5140u, rot & 2 ? 0x5140u : 0x7362u};",
    "const uint32_t even = rr ? 0x1054u : 0x5410u, odd = rr ? 0x3276u : 0x7632u;",
    "const uint32_t s2[2] = {rot & 1 ? odd : even, rot & 1 ? even : odd};",
    "const int u = (blk % NB) * 8 + (sub & 7), q = (blk / NB) * 4 + (sub >> 3);",
    "for (int j = 0; j < 4; ++j) L[j] = W[(4 * q + (j ^ rr)) * RW + u];",
    "const uint32_t t01 = __byte_perm(L[0], L[1], s1[p]), t23 = __byte_perm(L[2], L[3], s1[p]);",
    "Bs[(4 * u + ((2 * p + h) ^ rot)) * LDW + q] = __byte_perm(t01, t23, s2[h]);",
)


def _transpose_stage(W: np.ndarray, bn: int):
    """transpose_stage<bn> over the words of a weight stage W (64 k-rows of
    raw_row_words(bn) words): Bs (bn rows of LDW words), the unit (u, q) of
    each thread index e, and the word addresses of each warp's shared-memory
    instructions: {(warp, "read" j or "write" (p, h)): [32 addresses]}."""
    rw = (bn + common.STREAM_RAW_PAD) // 4
    ldw, nb = common.STREAM_LDW, bn // 32
    Bs = np.zeros(bn * ldw, np.uint32)
    units, access = [], {}
    for e in range(16 * (bn // 4)):
        lane = e & 31
        rr, rot = (lane >> 3) & 2, (lane >> 1) & 3
        s1 = [0x7362 if rot & 2 else 0x5140, 0x5140 if rot & 2 else 0x7362]
        even, odd = (0x1054, 0x3276) if rr else (0x5410, 0x7632)
        s2 = [odd if rot & 1 else even, even if rot & 1 else odd]
        sub, blk = e & 31, e >> 5
        u, q = (blk % nb) * 8 + (sub & 7), (blk // nb) * 4 + (sub >> 3)
        units.append((u, q))
        L = []
        for j in range(4):
            addr = (4 * q + (j ^ rr)) * rw + u
            access.setdefault((e >> 5, "read", j), []).append(addr)
            L.append(int(W[addr]))
        for p in range(2):
            t01, t23 = _byte_perm(L[0], L[1], s1[p]), _byte_perm(L[2], L[3], s1[p])
            for h in range(2):
                addr = (4 * u + ((2 * p + h) ^ rot)) * ldw + q
                access.setdefault((e >> 5, "write", p, h), []).append(addr)
                Bs[addr] = _byte_perm(t01, t23, s2[h])
    return Bs, units, access


@pytest.mark.parametrize("bn", [64, 128])
def test_stage_transpose_is_a_bijection_onto_k_major(bn):
    text = (CSRC / "stream_tile.cuh").read_text()
    body = text[text.index("void transpose_stage("):text.index("void stream_mainloop(")]
    for line in _TRANSPOSE_LINES:
        assert line in body, line
    rng = np.random.default_rng(bn)
    stage = rng.integers(0, 256, size=(STAGE, bn)).astype(np.uint8)  # [k][n]
    rw = (bn + common.STREAM_RAW_PAD) // 4
    W = np.zeros((STAGE, rw * 4), np.uint8)
    W[:, :bn] = stage
    W[:, bn:] = 0xEE  # the pad is never read
    Bs, units, access = _transpose_stage(W.view(np.uint32).reshape(-1), bn)
    # every 4 x 4 unit once: a bijection of thread indices onto units
    assert sorted(units) == [(u, q) for u in range(bn // 4) for q in range(16)]
    got = Bs.reshape(bn, common.STREAM_LDW).view(np.uint8)  # [n][4 * LDW bytes]
    np.testing.assert_array_equal(got[:, :STAGE], stage.T)  # B[n][kb] = w[kb][n]
    assert (got[:, STAGE:] == 0).all()  # the rows' pad is left alone
    # every warp instruction's 32 words lie in 32 distinct banks
    for key, addrs in access.items():
        assert len(addrs) == 32 and len({a % 32 for a in addrs}) == 32, key


# --- K5: the implicit-GEMM gather ------------------------------------------------

def _k5_mirror(x, w, kernel_size, strides, pads):
    """int8_conv_kernel's sums: per tile of CONV_BM output pixels (rows past
    M marked -1 in the row table), one stage per (tap, 64 channels), A
    gathered through the row table with zero outside the image and past C,
    B the stage's weight rows c * taps + tap; int32 sums over the stages."""
    b, h, wd, c = x.shape
    kh, kw = kernel_size
    n = w.shape[1]
    taps, cst = kh * kw, -(-c // STAGE)
    ho = (h + sum(pads[0]) - kh) // strides[0] + 1
    wo = (wd + sum(pads[1]) - kw) // strides[1] + 1
    m = b * ho * wo
    bm = common.CONV_BM
    out = np.zeros((m, n), np.int32)
    for m0 in range(0, m, bm):
        rows = np.arange(m0, m0 + bm)
        ox, t = rows % wo, rows // wo
        rb = np.where(rows < m, t // ho, -1)
        riy, rix = (t % ho) * strides[0] - pads[0][0], ox * strides[1] - pads[1][0]
        acc = np.zeros((bm, n), np.int64)
        for st in range(taps * cst):
            tap, c0 = st // cst, (st % cst) * STAGE
            dy, dx = tap // kw, tap % kw
            A = np.zeros((bm, STAGE), np.int64)
            iy, ix = riy + dy, rix + dx
            ok = (rb >= 0) & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
            cs = np.arange(c0, min(c0 + STAGE, c))
            A[ok, :len(cs)] = x[rb[ok], iy[ok], ix[ok]][:, cs]
            B = np.zeros((STAGE, n), np.int64)
            B[:len(cs)] = w[cs * taps + tap]
            acc += A @ B
        keep = rows < m
        out[rows[keep]] = acc[keep].astype(np.int32)
    return out.reshape(b, ho, wo, n)


@pytest.mark.parametrize("b,h,c,n,k,strides,padding", [
    (2, 9, 16, 24, 3, (2, 2), "SAME"),          # SAME stride 2
    (2, 15, 33, 70, 3, (2, 1), ((1, 2), (0, 1))),  # JAX's asymmetric pads, C = 33
    (1, 12, 6, 10, 5, (1, 1), "VALID"),          # 5 x 5 VALID
    (3, 8, 3, 65, 3, (1, 1), "SAME"),            # C = 3, N past one tile
    (1, 13, 70, 20, 3, (1, 1), "SAME"),          # C past one stage, M = 169: rows past M
])
def test_k5_gather_matches_plain_and_xla(b, h, c, n, k, strides, padding):
    rng = np.random.default_rng(b * h * c + n)
    x = rng.integers(-8, 16, size=(b, h, h, c)).astype(np.int8)
    w = (2 * rng.integers(0, 16, size=(c * k * k, n)) - 15).astype(np.int8)
    pads = conv_pads(padding, (h, h), (k, k), strides)
    got = _k5_mirror(x, w, (k, k), strides, pads)
    plain = tic.int8_conv2d_reference(torch.from_numpy(x), torch.from_numpy(w), (k, k), strides,
                                      pads)
    np.testing.assert_array_equal(got.astype(np.float32), plain.numpy())
    w4 = jnp.asarray(w).reshape(c, k, k, n).transpose(1, 2, 0, 3)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), w4, strides, padding,
                                       dimension_numbers=jconv._DN,
                                       preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got, np.asarray(ref))


# --- the benches' CPU side ----------------------------------------------------

def test_the_cost_variants_edit_the_sources():
    """bench/int8_tc_cost.py's variants each change the sources (the lines
    they edit are there), the kernel variant none."""
    for source, edits in int8_tc_cost.EDITS.items():
        v = int8_tc_cost.variants(source)
        assert set(v) == {"kernel", *edits}
        for name, files in v.items():
            changed = [f for f in files if files[f] != v["kernel"][f]]
            assert bool(changed) == (name != "kernel"), (source, name)


def test_the_cost_bench_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="times the card"):
        int8_tc_cost.run("cpu")


def test_the_conv_bench_configs_and_their_yardstick():
    """kernel_bench --kernel int8_conv: each conv's call equals its plain
    version, and the cuDNN yardstick computes the same integer sums (exact
    in float32 here) on the same codes."""
    configs = kernel_bench.conv_configs(1, "cpu")
    assert [c["conv"] for c, *_ in configs] == [c[0] for c in kernel_bench.CONVS]
    for config, fn, plain, cudnn in configs:
        got = fn()
        assert torch.equal(got, plain())
        m, k, n = config["gemm_mkn"]
        assert got.shape[0] * got.shape[1] * got.shape[2] == m and got.shape[3] == n
        raw = cudnn().permute(0, 2, 3, 1)
        if config["conv"].startswith("bnn"):  # no scale: the sums themselves
            assert torch.equal(raw, got)
        else:
            assert raw.shape == got.shape and (raw == raw.round()).all()
