"""The packed conv's fused route (K5 with the packed weight stage) and the
rewritten standalone decoders K2 and K7, on the CPU.

The CUDA kernels cannot run here. What they compute is mirrored in numpy,
step for step, and held to the plain versions and to the JAX package:

- the fused stage's walk and addressing (``csrc/int8_conv.cu``: K walked
  channel block by channel block, the slab of packed groups a block's taps
  cover, the slab's address table, each stage's rows gathered through it
  and centered four at a time) reproduces rows ``c * taps + tap`` of the
  decoded weights bit for bit and covers every k < C taps exactly once;
- the thread map of ``csrc/plane_decode.cuh`` (K2 at one bit, K7 at 1, 2
  and 4): every output byte written once, equal to the plain decode;
- the route (``common.conv_route``): a pure function of the shape, fused at
  b = 1, two launches where the slab does not fit or the conv is large;
- ``packed_conv2d`` direct mode, either route, bit-equal to the JAX
  package's direct conv (XLA's int8 conv on the decoded weights).
"""

from __future__ import annotations

import functools
import re
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu import ops as jops
from pytorch_quantize_impls_tpu_torch.bench import conv_decode_cost
from pytorch_quantize_impls_tpu_torch.kernels import common
from pytorch_quantize_impls_tpu_torch.kernels import conv as tconv
from pytorch_quantize_impls_tpu_torch.kernels import int8_conv as tic
from pytorch_quantize_impls_tpu_torch.kernels import packed_matmul as tpm
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as tbg
from pytorch_quantize_impls_tpu_torch.ops import pack as tpack

jconv = sys.modules["pytorch_quantize_impls_tpu.kernels.conv"]
CSRC = Path(tic.__file__).resolve().parent.parent / "csrc"
STAGE = common.STREAM_STAGE_BYTES
ROWS = tpack.GROUP_ROWS
BN = common.CONV_PACKED_BN


def _words(rng, k, n, bits):
    """Random ``bits``-bit codes (k, n), packed: (int32 words as uint32, the
    plain centered decode of all their rows)."""
    codes = torch.from_numpy(rng.integers(0, 2**bits, size=(k, n))).to(torch.int32)
    wp = tpack.pack_bitplanes(codes, bits)
    return wp.numpy().view(np.uint32), tpm.decode_dorefa_weights_reference(wp, w_bits=bits).numpy()


def _centered_bytes4(codes, bits):
    """numpy mirror of ``stream_tile.cuh`` ``centered_bytes4``: four codes,
    one a byte, to 2c - (2^bits - 1) without carries between the bytes."""
    nw = np.uint32(2**bits - 1)
    return (np.uint32(2) * codes + (np.uint32(0x80) - nw) * np.uint32(0x01010101)) ^ np.uint32(
        0x80808080)


def _bytes_of(words):
    """uint32 words -> their four bytes as int8, byte j last."""
    return words[..., None].view(np.uint8).reshape(*words.shape, 4).view(np.int8)


# --- the sources hold the Python plan's constants -----------------------------------


def test_the_sources_have_the_plans_constants():
    conv = (CSRC / "int8_conv.cu").read_text()
    assert "constexpr int PACKED_BN = 64;" in conv and BN == 64
    assert f"constexpr int SLAB_HEADER_WORDS = {common.CONV_SLAB_HEADER_WORDS};" in conv
    assert "__launch_bounds__(THREADS, 2)\nint8_conv_kernel_packed(" in conv
    # slab_blocks, slab_groups, table_words and packed_smem: conv_slab_plan's formulas
    assert "return taps > 1 ? 1 : 32 / bits * qt::stream::GROUP_ROWS / STAGE_BYTES;" in conv
    assert "const long k_hi = (long)std::min((slab + 1) * cbs * STAGE_BYTES, C) * taps;" in conv
    assert "return slab_blocks(taps, bits) * STAGE_BYTES * taps;" in conv
    assert ("PackedConvTile::SMEM +\n         ((size_t)2 * slab_words(groups) + 2 * "
            "table_words(taps, bits)) * 4 +") in conv
    assert ("qt::stream::Tile<CONV_BM, PACKED_BN, CONV_BM * LDW, 2, SLAB_HEADER_WORDS, false>"
            in conv)
    # the raw kernel keeps its launch bounds and its walk
    assert "__launch_bounds__(THREADS, BN_ == 64 ? 3 : 2)" in conv
    assert "const int tap = BITS == 0 ? st / cst : st % taps;" in conv
    decode = (CSRC / "plane_decode.cuh").read_text()
    assert "static constexpr int F = 32 / BITS, PER = F < 8 ? F : 8, OCTETS = F / PER;" in decode
    assert "constexpr int WIDTH = 4;  // words a chunk" in decode


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_centered_bytes4_is_2c_minus_nw_for_every_code(bits):
    nw = 2**bits - 1
    grid = np.stack(np.meshgrid(*[np.arange(nw + 1)] * 4, indexing="ij"), -1).reshape(-1, 4)
    codes = (grid.astype(np.uint32) << np.array([0, 8, 16, 24], np.uint32)).sum(1, dtype=np.uint32)
    got = _bytes_of(_centered_bytes4(codes, bits))
    np.testing.assert_array_equal(got, (2 * grid - nw).astype(np.int8))


# --- the fused stage: walk, slab, table, gather ---------------------------------------


def _fused_stages(words, c, taps, bits, n):
    """numpy mirror of the packed weight stage of ``int8_conv_kernel_packed``
    over every N tile: for each stage st (channel block st // taps, tap st %
    taps, the A loader's walk) the slab of slab st // spg (load_slab), its
    table (build_slab_table) and the stage's 64 rows x 64 columns gathered
    through the table (decode_slab_stage). Yields (stage, n0, c0, tap, the
    stage's centered bytes (64, 64))."""
    plan = common.conv_slab_plan(c, taps, bits)
    f, nw = 32 // bits, 2**bits - 1
    gk = f * ROWS
    cbs, spg = plan["cbs"], plan["spg"]
    cst = -(-c // STAGE)
    assert spg >= 2 and (2 - 1) * spg >= 2, "two slab slots and the next table need two stages"
    for n0 in range(0, n, BN):
        cols = np.zeros((words.shape[0], BN), np.uint32)
        cols[:, : min(BN, n - n0)] = words[:, n0:n0 + BN]
        for st in range(cst * taps):
            g, within = divmod(st, spg)
            k_lo = g * cbs * STAGE * taps
            k_hi = min((g + 1) * cbs * STAGE, c) * taps
            g_lo = k_lo // gk
            groups = (k_hi - 1) // gk - g_lo + 1
            assert groups <= plan["groups"]
            assert (g_lo + groups) * ROWS <= words.shape[0], "the slab stays inside the packed rows"
            slab = cols[g_lo * ROWS:(g_lo + groups) * ROWS]  # load_slab
            rows = cbs * STAGE
            c_lo = g * rows
            k_base = c_lo * taps // gk * gk
            e = np.arange(rows * taps)
            tap_e, ch = e // rows, c_lo + e % rows
            kr = ch * taps + tap_e - k_base
            offset = (kr // gk * ROWS + kr % 32) * BN * 4
            table = np.where(ch < c, offset | bits * (kr // 32 % f), 0)
            assert (table >> 5).max() < groups * ROWS * BN * 4 >> 5
            tap, cbl = within % taps, within // taps
            # the A loader's stage is the same (channel block, tap)
            assert (st // taps, st % taps) == (g * cbs + cbl, tap)
            entries = table[tap * rows + cbl * STAGE:][:STAGE]
            w = slab[(entries & ~31) // (BN * 4)]  # (64 rows, 64 columns)
            code = (w >> (entries & 31)[:, None].astype(np.uint32)) & np.uint32(nw)
            # four rows a word: the byte gather, then the carry-free centering
            quad = (code.reshape(16, 4, BN) << (np.arange(4, dtype=np.uint32) * 8)[None, :, None])
            centered = _bytes_of(_centered_bytes4(quad.sum(1, dtype=np.uint32), bits))
            yield st, n0, (st // taps) * STAGE, tap, centered.transpose(0, 2, 1).reshape(STAGE, BN)


FUSED_GRID = [(bits, taps, c) for bits in (1, 2, 4) for taps in (1, 9, 25)
              for c in (1, 3, 33, 64, 100, 256)]


@pytest.mark.parametrize("bits,taps,c", FUSED_GRID,
                         ids=[f"w{b}-taps{t}-C{c}" for b, t, c in FUSED_GRID])
def test_the_fused_stage_reproduces_the_decoded_rows(bits, taps, c):
    rng = np.random.default_rng(7 * bits + taps + c)
    n = 70  # a second, ragged N tile
    words, ref = _words(rng, c * taps, n, bits)
    seen = np.zeros(c * taps, np.int64)
    for _, n0, c0, tap, got in _fused_stages(words, c, taps, bits, n):
        live = np.arange(c0, min(c0 + STAGE, c))
        k = live * taps + tap
        w = min(BN, n - n0)
        np.testing.assert_array_equal(got[: len(live), :w], ref[k, n0:n0 + w])
        if n0 == 0:
            np.add.at(seen, k, 1)
    np.testing.assert_array_equal(seen, 1)  # every k < C taps once


# --- the standalone decoders' thread map (K2, K7) -----------------------------------


def _decode_mode(n):
    """``plane_decode.cuh`` decode_mode for torch's 16-byte aligned arrays:
    4 where N % 4 == 0, else 1 (also every unaligned array's)."""
    return 4 if n % 4 == 0 else 1


def _plane_writes(words, bits, mode):
    """numpy mirror of ``decode_planes``: (written bytes, write counts)."""
    width = 4  # words a chunk
    r, n = words.shape
    f = 32 // bits
    per = min(f, 8)
    octets = f // per
    chunks = -(-n // width)
    it = np.arange(r * chunks * octets)
    rest, n0 = it // chunks, it % chunks * width
    row, f0 = rest // octets, rest % octets * per
    out = np.zeros((r * f, n), np.int8)
    count = np.zeros((r * f, n), np.int64)
    for i in range(per):
        orow = row // ROWS * f * ROWS + row % ROWS + 32 * (f0 + i)
        for j in range(width):
            col = n0 + j
            keep = col < n
            if mode != 1:
                assert keep.all(), "the wide path takes whole chunks"
            word = words[row[keep], col[keep]]
            shift = np.uint32(bits) * (f0[keep] + i).astype(np.uint32)
            code = (word >> shift) & np.uint32(2**bits - 1)
            out[orow[keep], col[keep]] = (2 * code.astype(np.int64) - (2**bits - 1)).astype(np.int8)
            np.add.at(count, (orow[keep], col[keep]), 1)
    return out, count


PLANE_SHAPES = [(bits, k, n) for bits in (1, 2, 4)
                for k, n in ((300, 7), (1500, 65), (2304, 130), (1024, 256), (25, 16), (4096, 64))]


@pytest.mark.parametrize("bits,k,n", PLANE_SHAPES,
                         ids=[f"w{b}-K{k}-N{n}" for b, k, n in PLANE_SHAPES])
def test_the_decoders_write_every_byte_once(bits, k, n):
    rng = np.random.default_rng(bits * 1000 + k + n)
    words, ref = _words(rng, k, n, bits)
    for mode in {_decode_mode(n), 1}:
        got, count = _plane_writes(words, bits, mode)
        np.testing.assert_array_equal(count, 1)
        np.testing.assert_array_equal(got, ref)
    if bits == 1:  # K2 is K7's decode at one bit
        wp = torch.from_numpy(words.view(np.int32))
        np.testing.assert_array_equal(tbg.decode_binary_weights_reference(wp).numpy(), ref)


def test_the_cost_variants_edit_the_packed_stage():
    """bench/conv_decode_cost.py's variants of the packed stage: its decode
    left out, and the words read from L2 instead of the slab; an anchor
    that a later edit of the source moves is an error, not a silent no-op."""
    src = (CSRC / "int8_conv.cu").read_text()
    v = conv_decode_cost.variants(src)
    assert set(v) == {"no_decode", "words_from_l2"}
    assert "if (false) decode_slab_stage<BITS>(Bs, slabs" in v["no_decode"]
    assert "if (false) load_slab<BITS>(slabs" in v["words_from_l2"]
    assert "__ldg(D + (t[i] >> 8) * Ng + n)" in v["words_from_l2"]
    with pytest.raises(ValueError, match="expected"):
        conv_decode_cost.variants(src.replace("decode_slab_stage<BITS>(Bs, slabs", "_"))


# --- the route ------------------------------------------------------------------------


def _resnet_shapes(b):
    for label, h, cin, cout, s in chip_smoke.resnet_convs():
        ho = -(-h // s)
        yield label, b * ho * ho, cout, cin, 9


@pytest.mark.parametrize("b", [1, 4, 16, 64, 256])
def test_the_route_at_the_resnet_convs(b):
    for label, m, n, c, taps in _resnet_shapes(b):
        route = common.conv_route(b, m, n, c, taps, 4)
        assert route == common.conv_route(b, m, n, c, taps, 4)  # a pure function
        assert route == ("decode" if b == 256 else "fused"), label


def test_the_route_at_lenet_and_at_shapes_that_keep_two_launches():
    w = chip_smoke.WIDTH
    assert common.conv_route(1, 64, 2 * w, w, 25, 1) == "fused"
    assert common.conv_route(256, 256 * 64, 2 * w, w, 25, 1) == "decode"
    # a slab that does not fit decodes even at b = 1: 7 x 7 at 4 bits
    plan = common.conv_slab_plan(256, 49, 4)
    assert not plan["fits"] and plan["smem"] > common.STREAM_SMEM_LIMIT
    assert common.conv_route(1, 64, 256, 256, 49, 4) == "decode"
    # b = 1 is fused however large the conv
    assert common.conv_route(1, 512 * 512, 512, 512, 9, 1) == "fused"
    for bits, taps, c in FUSED_GRID:
        plan = common.conv_slab_plan(c, taps, bits)
        assert plan["fits"] and plan["groups"] >= 1


# --- packed_conv2d against JAX, either route --------------------------------------------

SCHEMES = [("binary", 1), ("xnor", 1), ("dorefa", 1), ("dorefa", 2), ("dorefa", 4)]
CONVS = [(1, 16, 70, 12, 3, (2, 2), "SAME"), (2, 12, 6, 10, 5, (1, 1), "VALID"),
         (3, 9, 12, 20, 1, (2, 2), "SAME")]


@functools.lru_cache(maxsize=None)
def _conv_case(conv, scheme, bits):
    """Seeded inputs of one conv, the JAX package's packed weights and its
    direct conv's output (numpy)."""
    b, h, cin, cout, k, strides, padding = conv
    rng = np.random.default_rng(zlib.crc32(repr((conv, scheme, bits)).encode()))
    w_hwio = rng.normal(size=(k, k, cin, cout)).astype(np.float32)
    x = rng.normal(size=(b, h, h, cin)).astype(np.float32)
    if scheme == "dorefa":
        w_hwio = np.asarray(jops.dorefa_weight(jnp.asarray(w_hwio), bits))
        x = np.asarray(jops.dorefa_activation(jnp.asarray(x), 4))
    jpc = jconv.pack_conv_weights(jnp.asarray(w_hwio), scheme, w_bits=bits, a_bits=4)
    ref = np.asarray(jconv.packed_conv2d(jnp.asarray(x), jpc, strides=strides, padding=padding))
    alpha = None if jpc.alpha is None else np.asarray(jpc.alpha)
    return w_hwio, x, alpha, ref


@pytest.mark.parametrize("route", ["fused", "decode"])
@pytest.mark.parametrize("scheme,bits", SCHEMES, ids=[f"{s}{b}" for s, b in SCHEMES])
@pytest.mark.parametrize("conv", CONVS, ids=[
    f"b{c[0]}-{c[1]}x{c[1]}x{c[2]}-k{c[4]}-s{c[5][0]}-{c[6]}" for c in CONVS])
def test_packed_conv_direct_matches_jax(conv, scheme, bits, route, monkeypatch):
    b, h, cin, cout, k, strides, padding = conv
    if route == "decode":  # the route the shape picks is fused: take the other one
        monkeypatch.setattr(tconv, "conv_route", lambda *shape: "decode")
    w_hwio, x, alpha, ref = _conv_case(conv, scheme, bits)
    # one-bit DoReFa weights are E|W| sign(W): the port's conv takes E|W|,
    # which JAX's packing drops
    e_w = float(np.abs(w_hwio).max()) if (scheme, bits) == ("dorefa", 1) else None
    tpc = tconv.pack_conv_weights(torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()), scheme,
                                  w_bits=bits, a_bits=4, w_scale=e_w)
    if scheme == "xnor":  # a float mean, in another order
        np.testing.assert_allclose(tpc.alpha.numpy(), alpha, rtol=1e-6)
        tpc = tpc._replace(alpha=torch.from_numpy(alpha.copy()))
    pads = tconv.conv_pads(padding, (h, h), (k, k), strides)
    assert tconv.packed_conv_route(x.shape, tpc, strides, pads) == route
    before = tic.int8_conv2d.packed_launches
    got = tconv.packed_conv2d(torch.from_numpy(x.copy()), tpc, strides=strides, padding=padding)
    assert tic.int8_conv2d.packed_launches == before  # CPU tensors launch nothing
    if e_w is None:
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    # JAX's sums scaled by f32(1/15); the port's by f32(1/15) E|W|
    inv = np.float32(1 / 15)
    acc = np.round(ref.astype(np.float64) / inv).astype(np.float32)
    np.testing.assert_array_equal(acc * inv, ref)  # acc is JAX's integer sum
    np.testing.assert_array_equal(got.numpy(), acc * (inv * np.float32(e_w)))
    with pytest.raises(ValueError, match="E\\|W\\|"):
        tconv.packed_conv2d(torch.from_numpy(x.copy()), tpc._replace(w_scale=None),
                            strides=strides, padding=padding)


def test_same_stride2_pads_as_jax_and_c_off_the_block():
    """The fused route's shape: stride 2 SAME pads (0, 1) at an even size,
    and C % 64 != 0."""
    assert tconv.conv_pads("SAME", (16, 16), (3, 3), (2, 2)) == ((0, 1), (0, 1))
    assert all(c[2] % STAGE != 0 for c in CONVS)


def test_the_packed_wrapper_equals_decode_then_conv_and_refuses_bad_words():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 16, size=(2, 9, 9, 33)).astype(np.int8))
    for bits in (1, 2, 4):
        words, ref = _words(rng, 33 * 9, 20, bits)
        wp = torch.from_numpy(words.view(np.int32))
        a = torch.full((20,), 1e-3)
        got = tic.int8_conv2d(x, wp, (3, 3), (1, 1), ((1, 1), (1, 1)), "scale", a, w_bits=bits)
        want = tic.int8_conv2d(x, torch.from_numpy(ref[: 33 * 9]), (3, 3), (1, 1),
                               ((1, 1), (1, 1)), "scale", a)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="w_bits"):
        tic.int8_conv2d(x, wp, (3, 3), (1, 1), ((1, 1), (1, 1)), w_bits=3)
    with pytest.raises(ValueError, match="packed weight has"):
        tic.int8_conv2d(x, wp[:, :].reshape(-1, 20)[:0], (3, 3), (1, 1), ((1, 1), (1, 1)), w_bits=4)
    assert re.search(r"int8_conv2d\.packed_launches = 0", Path(tic.__file__).read_text())
