"""The 1-bit GEMMs on the int8 tensor cores, K1 ``binary_gemm`` (the streamed
schedule of ``csrc/stream_tile.cuh``) and K10 ``binary_gemm_ws`` (the s8
path of the Hopper tile ``csrc/wgmma_tile.cuh``), on the CPU.

The CUDA kernels cannot run here. What they compute is mirrored in numpy
and PyTorch, step for step, and held to the plain versions and to the JAX
package (its Pallas kernels in interpret mode), inputs made with numpy from
a seed:

- K1's split over K: int32 partial sums per chunk of the launch plan
  (``common.stream_plan``), summed in index order, then the epilogue;
- K10's decoder (``csrc/packed_ws.cuh`` at one bit): the ``__byte_perm``
  gather and the ±1 byte expansion of each 128-deep stage of a column's 32
  words, placed by the 128-byte swizzle (``common.swizzle128``) into the
  K-major weight tile;
- the pitch-16 rows that K10's TMA reads x from.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_quantize_impls_tpu.kernels  # noqa: F401  (package init)
from pytorch_quantize_impls_tpu_torch.kernels import _build, common
from pytorch_quantize_impls_tpu_torch.kernels import int8_matmul as tim
from pytorch_quantize_impls_tpu_torch.kernels import xnor_gemm as tbg

jbg = sys.modules["pytorch_quantize_impls_tpu.kernels.xnor_gemm"]
CSRC = Path(tbg.__file__).resolve().parent.parent / "csrc"


def _inputs(rng, m, k, n, zeros=False):
    """±1 activations (with zeros where ``zeros``, as in padding) and packed
    weights, through the JAX package's own packers."""
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    xi = np.array(jbg.binarize_to_int8(jnp.asarray(x)))
    if zeros:
        xi = xi * rng.integers(0, 2, size=(m, k)).astype(np.int8)
    wp = np.array(jbg.pack_binary_weights(jnp.asarray(w)))
    return xi, wp


def _scales(rng, m, n, use_alpha, use_row):
    alpha = rng.uniform(0.5, 1.5, n).astype(np.float32) if use_alpha else None
    row = rng.uniform(0.5, 1.5, m).astype(np.float32) if use_row else None
    return alpha, row


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# --- K1: the split over K ---------------------------------------------------------


@pytest.mark.parametrize("scales", ["none", "alpha", "row", "alpha+row"])
@pytest.mark.parametrize("m", [1, 65])
@pytest.mark.parametrize("k", [300, 1500, 1501, 2100])
def test_binary_split_is_exact(k, m, scales):
    """K1 at N = 10: the plan splits K; int32 partials over its chunks of
    whole 64-deep stages (x zero past K, the packed rows past K decoding to
    -1), summed in index order, then f32(acc) * alpha * row_scale once: the
    plain version's bits and the JAX kernel's."""
    n = 10
    rng = np.random.default_rng(k * 3 + m)
    xi, wp = _inputs(rng, m, k, n, zeros=m == 65)
    alpha, row = _scales(rng, m, n, "alpha" in scales, "row" in scales)
    bm, s, chunk = common.stream_plan(m, n, k, tbg.STAGE_K)
    assert s > 1 and chunk % tbg.STAGE_K == 0
    twp = torch.from_numpy(wp.view(np.int32))
    w = tbg.decode_binary_weights_reference(twp).to(torch.int64)  # (Kp, N) ±1
    x = torch.zeros(m, w.shape[0], dtype=torch.int64)
    x[:, :k] = torch.from_numpy(xi).to(torch.int64)
    parts = [(x[:, k0:k0 + chunk] @ w[k0:k0 + chunk]).to(torch.int32)
             for k0 in range(0, s * chunk, chunk)]
    assert len(parts) == s and all(p.abs().max() <= 2100 for p in parts)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    assert torch.equal(acc.to(torch.int64), x @ w)
    got = tim.epilogue(acc, _t(alpha), _t(row))
    ref = tbg.binary_gemm_reference(torch.from_numpy(xi), twp, _t(alpha), _t(row))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    jref = jbg.binary_gemm(jnp.asarray(xi), jnp.asarray(wp), _j(alpha), _j(row), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref))
    # the wrapper on the CPU: the plain version
    np.testing.assert_array_equal(
        tbg.binary_gemm(torch.from_numpy(xi), twp, _t(alpha), _t(row)).numpy(), ref.numpy())


def test_k1_is_the_streamed_schedule_at_one_bit():
    """csrc/xnor_gemm.cu's K1 is the shared packed-code mainloop of
    stream_tile.cuh (stream_gemm on the packed tile with the stage decode)
    at one bit, as K6 is at two and four, with the split's second pass
    named so that chip_smoke.py's device times count it; no __dp4a is left
    in any source, and gemm_tile.cuh is gone."""
    src = (CSRC / "xnor_gemm.cu").read_text()
    assert "qt::stream::packed_code_gemm<1, BM>(" in src
    stream = (CSRC / "stream_tile.cuh").read_text()
    body = stream[stream.index("void packed_code_gemm("):]
    body = body[:body.index("\n}\n")]
    assert "decode_packed_stage<BITS>(Bs, W, 2 * stage);" in body
    assert "stream_gemm<mma::S8, PackedTile<BM, BM * LDW, false>>(GROUP_K / STAGE_BYTES" in body
    assert "binary_gemm_kernel_sum" in src
    import chip_smoke
    assert chip_smoke.KERNEL_SYMBOLS["binary_gemm"] in "binary_gemm_kernel_sum"
    assert chip_smoke.KERNEL_SYMBOLS["binary_gemm"] not in "binary_gemm_ws_kernel"
    for path in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        assert "__dp4a" not in path.read_text(), path.name
    assert not (CSRC / "gemm_tile.cuh").exists()
    # dorefa_gemm.cu runs the same mainloop and decode from the shared header
    dorefa = (CSRC / "dorefa_gemm.cu").read_text()
    assert "qt::stream::packed_code_gemm<BITS, BM>(" in dorefa
    assert "uint32_t centered_byte(" not in dorefa


def test_the_binary_args_struct_is_the_wrappers():
    """The wrapper packs BinaryGemmArgs field for field: seven addresses, then
    (M, N, K, R, bm, splits, chunk, device)."""
    src = (CSRC / "xnor_gemm.cu").read_text()
    body = src[src.index("struct BinaryGemmArgs {"):]
    body = body[:body.index("};")]
    assert [line.strip() for line in body.splitlines()[1:]] == [
        "const void* x;", "const void* wp;", "const void* alpha;", "const void* row_scale;",
        "void* out;", "void* ws;", "cudaStream_t stream;",
        "int M, N, K, R, bm, splits, chunk, device;"]
    assert tbg._GEMM_ARGS.format == "=7Q8i" and tbg._GEMM_ARGS.size == 7 * 8 + 8 * 4


# --- K10: the decoder ------------------------------------------------------------

# the decoder's lines (csrc/packed_ws.cuh, K10's and K11's shared tile body)
# that the mirror below repeats at one bit
_DECODER_LINES = (
    "const int bit = BITS * (4 * S + p);",
    "const uint32_t sel = (bit / 8) | ((bit / 8 + 4) << 4);",
    "const int r = 16 * h + 4 * u;",
    "const uint32_t b = __byte_perm(__byte_perm(w[r], w[r + 1], sel),",
    "__byte_perm(w[r + 2], w[r + 3], sel), 0x5410);",
    "q[p][u] = centered_bytes<BITS>((b >> (bit % 8)) & MASK);",
    "*reinterpret_cast<uint4*>(B + swizzle128(t, 2 * p + h)) =",
    "make_uint4(q[p][0], q[p][1], q[p][2], q[p][3]);",
    "return (2 * c + (0x80u - NW) * 0x01010101u) ^ 0x80808080u;",
)


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm: result byte i is byte (s >> 4i) & 7 of y:x."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _pm1_bytes(b: int) -> int:
    """packed_ws.cuh centered_bytes at one bit: bytes b in {0, 1} -> 2b - 1."""
    return ((2 * b + 0x7F * 0x01010101) ^ 0x80808080) & 0xFFFFFFFF


def _decode_stage(w, stage_in_group: int, t: int):
    """Decoder thread t's stage: its column's 32 words -> {byte address in
    the swizzled weight tile: byte}, and the (word, bit) each byte came
    from."""
    S = stage_in_group
    out, source = {}, {}
    for h in range(2):
        q = [[0] * 4 for _ in range(4)]
        for u in range(4):
            r = 16 * h + 4 * u
            for p in range(4):
                bit = 4 * S + p
                sel = (bit // 8) | ((bit // 8 + 4) << 4)
                b = _byte_perm(_byte_perm(int(w[r]), int(w[r + 1]), sel),
                               _byte_perm(int(w[r + 2]), int(w[r + 3]), sel), 0x5410)
                q[p][u] = _pm1_bytes((b >> (bit % 8)) & 0x01010101)
        for p in range(4):
            chunk = np.array(q[p], np.uint32).view(np.uint8)  # the uint4, little-endian
            base = common.swizzle128(t, 2 * p + h)
            for i in range(16):
                out[base + i] = chunk[i]
                u, j = divmod(i, 4)
                source[base + i] = (16 * h + 4 * u + j, 4 * S + p)
    return out, source


def test_the_decoder_mirror_repeats_the_source():
    src = (CSRC / "packed_ws.cuh").read_text()
    for line in _DECODER_LINES:
        assert line in src, line


@pytest.mark.parametrize("k,n", [(2048, 128), (1000, 130), (4096, 256)])
def test_k10_decoder_is_a_bijection_onto_k_major(k, n):
    """Each stage of 128 k: thread t's 32 words of column n0 + t (bits 4S ..
    4S + 3 of words 0..31) fill its row of the 128 x 128-byte tile exactly
    once (the 128-byte swizzle: row t, chunk c at t * 128 + ((c ^ (t & 7))
    << 4)), and the unswizzled row is decode_binary_weights_reference's
    column, rows 128 s .. 128 s + 127, as ±1 bytes."""
    rng = np.random.default_rng(k + n)
    _, wp = _inputs(rng, 1, k, n)
    ref = tbg.decode_binary_weights_reference(torch.from_numpy(wp.view(np.int32))).numpy()
    plan = common.binary_ws_plan(1)
    stage_k, spg = plan["stage_k"], plan["stages_per_group"]
    assert (stage_k, spg) == (128, 8)
    stages = -(-k // stage_k)
    for n0 in range(0, n, plan["bn"]):
        for s in range(stages):
            g, S = divmod(s, spg)
            tile = np.full(plan["bn"] * 128, 0x55, np.uint8)
            written = np.zeros(plan["bn"] * 128, np.int64)
            for t in range(plan["bn"]):
                col = min(n0 + t, n - 1)  # past N the decoder repeats column N - 1
                words = wp[32 * g:32 * g + 32, col]
                row, source = _decode_stage(words, S, t)
                assert sorted(source.values()) == sorted((r, 4 * S + p) for p in range(4)
                                                         for r in range(32))
                for addr, byte in row.items():
                    assert addr // 128 == t  # inside the thread's own row
                    tile[addr] = byte
                    written[addr] += 1
            assert (written == 1).all()  # every byte of the stage once
            got = np.empty((plan["bn"], 128), np.int8)
            for t in range(plan["bn"]):
                for kk in range(128):
                    got[t, kk] = tile[common.swizzle128(t, kk // 16) + kk % 16].view(np.int8)
            cols = np.minimum(np.arange(n0, n0 + plan["bn"]), n - 1)
            want = ref[s * stage_k:(s + 1) * stage_k, cols].T
            np.testing.assert_array_equal(got, want)


# --- K10: the wrapper -----------------------------------------------------------


@pytest.mark.parametrize("m_tiles", common.WS_M_TILES)
@pytest.mark.parametrize("m,k,n,scales", [
    (65, 300, 130, "alpha+row"), (1, 27, 10, "none"), (257, 1500, 64, "alpha"),
])
def test_binary_gemm_ws_ragged_shapes_match_jax_at_every_m_tiles(m, k, n, scales, m_tiles):
    """Ragged M, N and K (K off the 128-deep stage and the group, N off the
    128-column tile, M off every M-tile height) through the wrapper on the
    CPU, whatever m_tiles: bit for bit the JAX binary_gemm_ws in interpret
    mode and K1's plain version."""
    rng = np.random.default_rng(m * 7 + k + n)
    xi, wp = _inputs(rng, m, k, n, zeros=True)
    alpha, row = _scales(rng, m, n, "alpha" in scales, "row" in scales)
    ref = np.asarray(jbg.binary_gemm_ws(jnp.asarray(xi), jnp.asarray(wp), _j(alpha), _j(row),
                                        tiles=(128, 128, 1024), interpret=True))
    twp = torch.from_numpy(wp.view(np.int32))
    got = tbg.binary_gemm_ws(_t(xi), twp, _t(alpha), _t(row), m_tiles=m_tiles)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), tbg.binary_gemm_reference(_t(xi), twp, _t(alpha), _t(row)).numpy())


@pytest.mark.parametrize("k", [16, 4096, 1, 27, 300, 1000])
def test_int8_rows_give_tma_a_pitch_of_sixteen(k):
    """x as K10's TMA reads it: a 16-byte-aligned row pitch of K rounded up
    to 16 bytes, the first K columns x's values; x itself where K is a
    multiple of 16 and x aligned."""
    x = torch.from_numpy(np.random.default_rng(k).integers(-1, 2, size=(5, k)).astype(np.int8))
    xq = common.int8_rows(x)
    assert xq.dtype == torch.int8 and xq.shape == (5, -(-k // 16) * 16)
    assert xq.is_contiguous() and xq.data_ptr() % 16 == 0
    assert torch.equal(xq[:, :k], x)
    assert (xq is x) == (k % 16 == 0)


def test_int8_rows_copy_an_unaligned_view():
    flat = torch.ones(4 * 32 + 4, dtype=torch.int8)
    view = flat[4:].view(4, 32)  # rows of 32 bytes, 4 bytes off
    assert view.data_ptr() % 16 != 0
    xq = common.int8_rows(view)
    assert xq is not view and xq.data_ptr() % 16 == 0 and torch.equal(xq, view)


def test_the_k10_library_takes_the_pitch():
    """qt_binary_gemm_ws takes x's row pitch after K, as the wrapper passes it."""
    src = (CSRC / "xnor_gemm.cu").read_text()
    assert ('extern "C" int qt_binary_gemm_ws(const void* x, const void* wp, const void* alpha,\n'
            '                                 const void* row_scale, void* out, int M, int N, int K, '
            'int pitch,\n                                 int R, int m_tiles, int device, '
            'void* stream)') in src
    assert "pitch % 16" in src
    assert common.TMA_PITCH == 16
    assert _build.SOURCES.count("xnor_gemm") == 1
