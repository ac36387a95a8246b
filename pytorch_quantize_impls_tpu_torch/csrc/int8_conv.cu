// int8_conv2d: NHWC int8 codes x flat int8 weights -> NHWC output, through an
// int32 accumulator, as an implicit GEMM (no im2col copy in device memory)
// on the int8 tensor cores.
//
// Replaces XLA's int8 conv_general_dilated with preferred_element_type=int32
// in the JAX package (pytorch_quantize_impls_tpu/kernels/conv.py:121-123,
// 130-133, the direct packed conv; infer/fused_chain.py:380-388, the fused
// DoReFa ResNet, and :421-431, the binary fused chains' conv and the
// where(y >= thr, hi, lo) after it). That is not a Pallas kernel, but
// PyTorch has no int8 convolution on CUDA, and the fused chains need the
// codes to stay int8 between convs.
//
//   x    (B, H, W, C) int8: ±1, or DoReFa codes in [0, n_a]; padding is the
//        code 0, which is the value 0 for both;
//   w    (C * KH * KW, N) int8, row c * KH * KW + dy * KW + dx: the layout
//        decode_binary_weights / decode_dorefa_weights emit (the HWIO kernel
//        flattened in (cin, kh, kw) order), so no transpose per call;
//   out  (B, HO, WO, N), output pixel (oy, ox) reading input rows
//        oy * SH - pad_top + dy and columns ox * SW - pad_left + dx.
//
// Epilogues, on f = (float)acc, each product and sum rounded on its own
// (__fmul_rn/__fadd_rn: nvcc would contract a * f + b into an FMA, which
// rounds once, and codes would flip at .5 boundaries against the plain
// version, which multiplies and adds in two steps):
//   EPI_SCALE  f32  f * scale[n]            (no scale: f) — xnor alpha, 1/(n_w n_a)
//   EPI_CODES  int8 clip(rint(a[n] * f + b[n]), 0, n_a) — the fused conv1
//   EPI_AFFINE f32  a[n] * f + b[n]         — the fused conv2
//   EPI_THRESHOLD int8  f >= a[n] ? b[n] : b[N + n] — the binary chains'
//                   boundary (BatchNorm + the next sign) on the raw sum:
//                   a the threshold, b (2, N) the codes (hi, lo) as floats;
//                   a tie gives hi, and a = -inf (a constant code) always hi
// rintf rounds half to even, as torch.round and jnp.round do.
//
// GEMM view: M = B * HO * WO output pixels, N output channels, K = taps * C
// (taps = KH * KW). The schedule is stream_tile.cuh's, on the int8 tensor
// cores (mma.sync m16n8k32, exact int32 sums, so the order of K does not
// change the result): a block owns a 128 x BN tile of M x N (BN 64 or 128,
// kernels/common.py conv_plan) and walks all of K, one stage per tap and
// 64 input channels (channels past C read as 0), with three stages in
// flight in a cp.async ring. Its A loader gathers each output pixel's 64
// channels of the stage's tap through a per-row table (image, first input
// row and column; JAX's asymmetric SAME pads come in as pad_top/pad_left):
// 16-byte copies with src_bytes = 0 for pixels outside the image and rows
// past M (4-byte copies or byte loads where C % 16 != 0); its B loader
// copies the stage's weight rows c * taps + tap, 16 bytes along N, and
// transposes them to K-major once per stage (transpose_stage, as K3 does).
// No split over K: b = 256 gives 512 tiles or more. The epilogue stages the
// tile through shared memory, so each warp writes whole rows of the output,
// the largest byte stream of the call (f32 at ResNet stage 1: 33.5 MB, 10
// us at 3.35 TB/s, against 19.3 G int8 operations, 9.8 us at 1979 TOP/s).
//
// The packed weight stage (int8_conv_kernel_packed<BITS>): w is the packed
// conv weight itself, the grouped-planar words (R, N) of ops/pack.py that
// decode_binary_weights (K2, one bit) and decode_dorefa_weights (K7, 1, 2
// or 4 bits) would expand, and the kernel decodes them into its K-major
// stage with centered_bytes4 (2c - (2^BITS - 1), as K1 and K6 do), so the
// packed conv makes one launch where decode + conv made two. Weight row k
// lives in word row (k / GROUP_K) 32 + k % 32, bit field (k % GROUP_K) /
// 32, so the 64 rows c taps + tap of one (tap, 64 channels) stage sit in up
// to 64 word rows: whole words per stage would read 4 bytes per code. The
// packed kernel walks K by channel block instead (stage st: channel block
// st / taps, tap st % taps; the int32 sums are exact, so the order of K
// changes no bit): a block's taps together read the contiguous rows
// [64 cb taps, 64 (cb + 1) taps), and the packed groups that cover them
// (the slab, at most `groups` of 32 word rows x 64 columns) are copied to
// shared memory once, with cp.async, at the slab's first stage, RING - 1
// stages ahead, into one of two slots; each stage then gathers its 64 rows
// from the slab through the slab's address table (an entry per channel and
// tap, built one slab ahead) and centers them four at a time
// (decode_slab_stage). A 1 x 1 conv's slab is one whole packed group,
// GROUP_K / 64 channel blocks. So each tile reads the packed bytes of its
// columns about once (4 bits: half the raw bytes); reading each stage's
// words from L2 with no slab ran 1-13% slower on the H100. Rows of
// channels past C decode to 0 and read no word (the slab stops at row C
// taps - 1, within the packed rows). Tiles are 128 x 64; two slab slots
// and two tables replace the raw weight ring (kernels/common.py
// conv_slab_plan: the shared memory; conv_route picks this kernel or
// decode + the raw one by shape).
#include <algorithm>
#include <climits>
#include <type_traits>

#include "mma_tile.cuh"
#include "stream_tile.cuh"

namespace {

using qt::mma::LDW;
using qt::mma::STAGE_BYTES;
using qt::mma::THREADS;

enum Epilogue { EPI_SCALE = 0, EPI_CODES = 1, EPI_AFFINE = 2, EPI_THRESHOLD = 3 };

constexpr int CONV_BM = 128;  // output pixels per block

struct ConvShape {
  int B, H, W, C, KH, KW, HO, WO, N, SH, SW, pad_top, pad_left;
};

template <int BN_>
using ConvTile = qt::stream::BytesTile<CONV_BM, BN_>;

// The tile's shared memory and, after it, the per-row table (3 x CONV_BM ints).
template <int BN_>
constexpr size_t conv_smem() {
  return ConvTile<BN_>::SMEM + 3 * CONV_BM * sizeof(int);
}

// The staged output tile reuses the ring: f32 rows of BN_ + 8 floats (a
// float2 store per lane pair, conflict-free), code rows of BN_ + 16 bytes.
template <int BN_>
constexpr size_t staged_bytes() {
  return (size_t)CONV_BM * (BN_ + 8) * 4;
}
static_assert(staged_bytes<64>() <= ConvTile<64>::SMEM &&
                  staged_bytes<128>() <= ConvTile<128>::SMEM,
              "the staged tile fits the ring");
// blocks per SM (__launch_bounds__): three of the 64-wide tile (at most 85
// registers a thread), two of the 128-wide one; the SM has 228 KB, 1 KB of
// it reserved per block
static_assert(3 * (conv_smem<64>() + 1024) <= 233472 && 2 * (conv_smem<128>() + 1024) <= 233472,
              "the blocks share an SM");

// The packed weight stage: 128 x 64 tiles, two slab slots of `groups` x
// 32 word rows x 64 columns after the tile's shared memory, each with a
// header word (the slab's index) in the tile's W ring, which holds nothing
// else.
constexpr int PACKED_BN = 64;
constexpr int SLAB_HEADER_WORDS = 4;
using PackedConvTile =
    qt::stream::Tile<CONV_BM, PACKED_BN, CONV_BM * LDW, 2, SLAB_HEADER_WORDS, false>;
static_assert(staged_bytes<PACKED_BN>() <= (size_t)4 * qt::stream::RING * CONV_BM * LDW,
              "the staged tile fits the activation ring");

__host__ __device__ inline int slab_words(int groups) {
  return groups * qt::stream::GROUP_ROWS * PACKED_BN;
}

// Channel blocks per slab: one, or a whole packed group's for a 1 x 1 conv
// (the mainloop's two slots need a slab of two stages or more).
__host__ __device__ inline int slab_blocks(int taps, int bits) {
  return taps > 1 ? 1 : 32 / bits * qt::stream::GROUP_ROWS / STAGE_BYTES;
}

// The most packed groups one slab covers (kernels/common.py conv_slab_plan).
inline int slab_groups(int C, int taps, int bits) {
  const long gk = 32 / bits * qt::stream::GROUP_ROWS;
  const int cbs = slab_blocks(taps, bits), cst = (C + STAGE_BYTES - 1) / STAGE_BYTES;
  int most = 0;
  for (int slab = 0; slab * cbs < cst; ++slab) {
    const long k_lo = (long)slab * cbs * STAGE_BYTES * taps;
    const long k_hi = (long)std::min((slab + 1) * cbs * STAGE_BYTES, C) * taps;
    most = std::max(most, (int)((k_hi - 1) / gk - k_lo / gk + 1));
  }
  return most;
}

// Words of a slab's address table: 64 cbs rows x taps.
__host__ __device__ inline int table_words(int taps, int bits) {
  return slab_blocks(taps, bits) * STAGE_BYTES * taps;
}

inline size_t packed_smem(int groups, int taps, int bits) {
  return PackedConvTile::SMEM +
         ((size_t)2 * slab_words(groups) + 2 * table_words(taps, bits)) * 4 +
         3 * CONV_BM * sizeof(int);
}

// Copy slab `slab` (channel blocks [slab cbs, + cbs) of all taps: packed
// groups g_lo .. g_hi, the groups of rows [64 slab cbs taps, min(64 (slab +
// 1) cbs, C) taps)) x columns [n0, n0 + 64) of wp (R x N words) into D
// (group - g_lo, word row, column), columns >= N as 0; `vec`: N % 4 == 0
// and wp 16-byte aligned, four neighbouring columns one 16-byte copy.
template <int BITS>
__device__ __forceinline__ void load_slab(uint32_t* D, const uint32_t* __restrict__ wp,
                                          int slab, int n0, int C, int N, int taps, int cbs,
                                          bool vec) {
  constexpr int GROUP_K = 32 / BITS * qt::stream::GROUP_ROWS;
  const long k_lo = (long)slab * cbs * STAGE_BYTES * taps;
  const long k_hi = (long)min((slab + 1) * cbs * STAGE_BYTES, C) * taps;
  const int g_lo = (int)(k_lo / GROUP_K);
  const int words = ((int)((k_hi - 1) / GROUP_K) - g_lo + 1) * qt::stream::GROUP_ROWS * PACKED_BN;
  const uint32_t* src0 = wp + (size_t)g_lo * qt::stream::GROUP_ROWS * N;
  if (vec) {
    for (int e = threadIdx.x; e < words / 4; e += THREADS) {
      const int row = e / (PACKED_BN / 4), c = 4 * (e % (PACKED_BN / 4));
      const bool in = n0 + c < N;
      qt::stream::cp_async16(D + row * PACKED_BN + c, in ? src0 + (size_t)row * N + n0 + c : wp,
                             in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < words; e += THREADS) {
      const int row = e / PACKED_BN, c = e % PACKED_BN;
      const bool in = n0 + c < N;
      qt::stream::cp_async4(D + row * PACKED_BN + c, in ? src0 + (size_t)row * N + n0 + c : wp,
                            in ? 4 : 0);
    }
  }
}

// A slab's address table: entry tap 64 cbs + cl (channel c_lo + cl of the
// slab at tap `tap`, weight row k = c taps + tap; kr = k - the slab's first
// packed row) holds the byte offset of its word row in the slab, (kr /
// GROUP_K 32 + kr % 32) 256, with its field's shift BITS (kr / 32 % F) in
// the low five bits; channels >= C point at word row 0 (A reads 0 there,
// so any weight does). Every column's stage rows share it. The table of
// slab g + 1 is built during slab g (two tables), so no stage waits for it.
template <int BITS>
__device__ __forceinline__ void build_slab_table(uint32_t* tab, int slab, int C, int taps,
                                                 int cbs) {
  constexpr int F = 32 / BITS, GROUP_K = F * qt::stream::GROUP_ROWS;
  const int rows = cbs * STAGE_BYTES, c_lo = slab * rows;
  const int k_base = c_lo * taps / GROUP_K * GROUP_K;
  for (int e = threadIdx.x; e < rows * taps; e += THREADS) {
    const int tap = e / rows, c = c_lo + e % rows;
    uint32_t entry = 0;
    if (c < C) {
      const int kr = c * taps + tap - k_base;
      entry = (uint32_t)((kr / GROUP_K * qt::stream::GROUP_ROWS + kr % 32) * PACKED_BN * 4) |
              (uint32_t)(BITS * (kr / 32 % F));
    }
    tab[e] = entry;
  }
}

// One stage into Bs (64 columns x LDW words, K-major: word q of column n
// holds stage rows 4q .. 4q + 3) from the slab D through the stage's 64
// table entries: row kl of column n is the code at shift tab[kl] & 31 of
// the word at byte (tab[kl] & ~31) + 4n of D. A unit is one column's 16
// rows: 16 slab words, read by the lanes of a warp along one word row
// (consecutive columns: no bank conflict; the table entries are one
// broadcast), centered four at a time (centered_bytes4), and one 16-byte
// store (eight lanes' stores fall in distinct banks at LDW = 20).
template <int BITS>
__device__ __forceinline__ void decode_slab_stage(uint32_t* Bs, const uint32_t* D,
                                                  const uint32_t* tab) {
  constexpr uint32_t NW4 = 0x01010101u * ((1u << BITS) - 1);
  const auto* Db = reinterpret_cast<const uint8_t*>(D);
  for (int e = threadIdx.x; e < 4 * PACKED_BN; e += THREADS) {
    const int n = e % PACKED_BN, q0 = 16 * (e / PACKED_BN);
    const uint8_t* col = Db + 4 * n;
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 t4 = *reinterpret_cast<const uint4*>(tab + q0 + 4 * j);
      const uint32_t t[4] = {t4.x, t4.y, t4.z, t4.w};
      uint32_t c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        c[i] = __funnelshift_r(*reinterpret_cast<const uint32_t*>(col + (t[i] & ~31u)), 0u, t[i]);
      // byte 0 of each code word into bytes 0..3, then the fields' bits
      const uint32_t codes =
          __byte_perm(__byte_perm(c[0], c[1], 0x40), __byte_perm(c[2], c[3], 0x40), 0x5410);
      v[j] = qt::stream::centered_bytes4<BITS>(codes & NW4);
    }
    *reinterpret_cast<uint4*>(Bs + n * LDW + q0 / 4) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// One 128 x BN_ output tile: raw int8 weights (BITS 0, the walk tap by tap,
// each stage's rows copied and transposed) or packed BITS-bit words (the
// walk channel block by channel block, slabs of `groups` packed groups).
template <int BN_, int BITS>
__device__ __forceinline__ void conv_tile(const int8_t* __restrict__ x, const void* __restrict__ w,
                                          const ConvShape& s, int epilogue,
                                          const float* __restrict__ pa,
                                          const float* __restrict__ pb, int n_a,
                                          void* __restrict__ out, int xmode, int wmode,
                                          int groups) {
  using T = std::conditional_t<BITS == 0, ConvTile<BN_>, PackedConvTile>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int taps = s.KH * s.KW, cst = (s.C + STAGE_BYTES - 1) / STAGE_BYTES;
  const int cbs = BITS == 0 ? 1 : slab_blocks(taps, BITS == 0 ? 1 : BITS);
  // packed: the two slab slots after the tile, then two address tables
  // (slab g's in table g % 2)
  uint32_t* slabs = smem + T::SMEM / 4;
  uint32_t* tabs = slabs + 2 * slab_words(groups);
  const int tw = BITS == 0 ? 0 : table_words(taps, BITS == 0 ? 1 : BITS);
  // per output row of the tile: its image (-1 past M), and its first input
  // row and column
  int* row_b = reinterpret_cast<int*>(tabs + 2 * tw);
  int* row_iy = row_b + CONV_BM;
  int* row_ix = row_iy + CONV_BM;
  const int M = s.B * s.HO * s.WO;
  const int m0 = blockIdx.x * CONV_BM, n0 = blockIdx.y * BN_;
  for (int r = threadIdx.x; r < CONV_BM; r += THREADS) {
    const int m = m0 + r;
    if (m < M) {
      const int ox = m % s.WO, t = m / s.WO;
      row_b[r] = t / s.HO;
      row_iy[r] = (t % s.HO) * s.SH - s.pad_top;
      row_ix[r] = ox * s.SW - s.pad_left;
    } else {
      row_b[r] = -1;
      row_iy[r] = row_ix[r] = 0;
    }
  }
  if constexpr (BITS != 0) build_slab_table<BITS>(tabs, 0, s.C, taps, cbs);
  __syncthreads();
  const auto* xb = reinterpret_cast<const uint8_t*>(x);
  // raw: a weight group is one stage; packed: a slab, cbs channel blocks of all taps
  const int k_stages = taps * cst, spg = BITS == 0 ? 1 : cbs * taps;

  // stage st: raw, tap st / cst and channels [64 (st % cst), + 64); packed,
  // channel block st / taps and tap st % taps
  auto load_a = [&](uint32_t* S, int, int k0) {
    const int st = k0 / STAGE_BYTES;
    const int tap = BITS == 0 ? st / cst : st % taps;
    const int c0 = (BITS == 0 ? st % cst : st / taps) * STAGE_BYTES;
    const int dy = tap / s.KW, dx = tap % s.KW;
    // the address of channel c of row r's input pixel, or null outside it
    auto pixel = [&](int r, int c) -> const uint8_t* {
      const int b = row_b[r], iy = row_iy[r] + dy, ix = row_ix[r] + dx;
      if (b < 0 || iy < 0 || iy >= s.H || ix < 0 || ix >= s.W || c >= s.C) return nullptr;
      return xb + (((size_t)b * s.H + iy) * s.W + ix) * s.C + c;
    };
    if (xmode == 16) {
      for (int e = threadIdx.x; e < CONV_BM * 4; e += THREADS) {
        const int r = e >> 2, c = 16 * (e & 3);
        const uint8_t* p = pixel(r, c0 + c);
        qt::stream::cp_async16(S + r * LDW + c / 4, p ? p : xb, p ? 16 : 0);
      }
    } else if (xmode == 4) {
      for (int e = threadIdx.x; e < CONV_BM * 16; e += THREADS) {
        const int r = e >> 4, c = 4 * (e & 15);
        const uint8_t* p = pixel(r, c0 + c);
        qt::stream::cp_async4(S + r * LDW + c / 4, p ? p : xb, p ? 4 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < CONV_BM * 16; e += THREADS) {
        const int r = e >> 4, c = 4 * (e & 15);
        const uint8_t* p = pixel(r, c0 + c);
        uint32_t v = 0u;
        for (int i = 0; p != nullptr && i < 4 && c0 + c + i < s.C; ++i)
          v |= (uint32_t)p[i] << (8 * i);
        S[r * LDW + c / 4] = v;
      }
    }
  };
  // raw: the stage's weight rows c * taps + tap, channels c in [c0, min(c0 +
  // 64, C)); packed: slab g into slot g % 2, its index into the slot's header
  auto load_w = [&](uint32_t* W, int g, int n0_) {
    if constexpr (BITS == 0) {
      const int tap = g / cst, c0 = (g % cst) * STAGE_BYTES;
      qt::stream::load_stage_bytes<BN_>(W, static_cast<const uint8_t*>(w), s.N, n0_, wmode,
                                        (long)c0 * taps + tap, taps, s.C - c0);
    } else {
      if (threadIdx.x == 0) W[0] = (uint32_t)g;
      load_slab<BITS>(slabs + (g & 1) * slab_words(groups), static_cast<const uint32_t*>(w), g,
                      n0_, s.C, s.N, taps, cbs, wmode != 0);
    }
  };
  auto prep = [&](const uint32_t*, const uint32_t* W, int within, uint32_t* Bs, uint32_t*) {
    if constexpr (BITS == 0) {
      qt::stream::transpose_stage<BN_>(Bs, W);
    } else {
      const int g = (int)W[0];
      decode_slab_stage<BITS>(Bs, slabs + (g & 1) * slab_words(groups),
                              tabs + (g & 1) * tw + within % taps * cbs * STAGE_BYTES +
                                  within / taps * STAGE_BYTES);
      // slab g + 1's table, into the one slab g - 1 used: its last stage was
      // prepared before the barrier that began this stage, and the mainloop's
      // barriers publish the table before slab g + 1's first stage
      if (within == 1 && (g + 1) * spg < k_stages)
        build_slab_table<BITS>(tabs + ((g + 1) & 1) * tw, g + 1, s.C, taps, cbs);
    }
  };
  int32_t acc[T::MF][T::NF][4];
  qt::stream::stream_mainloop<qt::mma::S8, T>(blockIdx.x, blockIdx.y, spg, k_stages, k_stages,
                                              load_a, load_w, prep, acc);

  // the epilogue, staged: every warp is done with the ring after this barrier
  __syncthreads();
  auto value = [&](int32_t a, int n) -> float {
    const float f = (float)a;
    if (n >= s.N) return 0.0f;
    if (epilogue == EPI_SCALE) return pa != nullptr ? __fmul_rn(f, pa[n]) : f;
    if (epilogue == EPI_THRESHOLD) return f >= pa[n] ? pb[n] : pb[s.N + n];
    const float y = __fadd_rn(__fmul_rn(pa[n], f), pb[n]);
    if (epilogue == EPI_AFFINE) return y;
    return fminf(fmaxf(rintf(y), 0.0f), (float)n_a);
  };
  const int warp = threadIdx.x >> 5, wm = warp % T::WM, wn = warp / T::WM;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  constexpr int SF = BN_ + 8, SB = BN_ + 16;  // staged row pitch: floats, code bytes
  const bool codes_out = epilogue == EPI_CODES || epilogue == EPI_THRESHOLD;  // int8 out
  auto* sf = reinterpret_cast<float*>(smem);
  auto* sb = reinterpret_cast<uint8_t*>(smem);
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * wm + 16 * T::WM * i + gid + 8 * h, c = T::NF * 8 * wn + 8 * j + 2 * tig;
        const float v0 = value(acc[i][j][2 * h], n0 + c);
        const float v1 = value(acc[i][j][2 * h + 1], n0 + c + 1);
        if (codes_out)
          *reinterpret_cast<uint16_t*>(sb + r * SB + c) =
              (uint16_t)((uint8_t)(int8_t)v0 | ((uint16_t)(uint8_t)(int8_t)v1 << 8));
        else
          *reinterpret_cast<float2*>(sf + r * SF + c) = make_float2(v0, v1);
      }
  __syncthreads();
  const int rows = min(CONV_BM, M - m0), cols = min(BN_, s.N - n0);
  if (codes_out) {
    auto* o = static_cast<int8_t*>(out);
    const bool vec = s.N % 16 == 0;
    for (int e = threadIdx.x; e < CONV_BM * (BN_ / 16); e += THREADS) {
      const int r = e / (BN_ / 16), c = 16 * (e % (BN_ / 16));
      if (r >= rows || c >= cols) continue;
      int8_t* dst = o + (size_t)(m0 + r) * s.N + n0 + c;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(sb + r * SB + c);
      } else {
        for (int i = 0; i < 16 && c + i < cols; ++i) dst[i] = (int8_t)sb[r * SB + c + i];
      }
    }
  } else {
    auto* o = static_cast<float*>(out);
    const bool vec = s.N % 4 == 0;
    for (int e = threadIdx.x; e < CONV_BM * (BN_ / 4); e += THREADS) {
      const int r = e / (BN_ / 4), c = 4 * (e % (BN_ / 4));
      if (r >= rows || c >= cols) continue;
      float* dst = o + (size_t)(m0 + r) * s.N + n0 + c;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(sf + r * SF + c);
      } else {
        for (int i = 0; i < 4 && c + i < cols; ++i) dst[i] = sf[r * SF + c + i];
      }
    }
  }
}

template <int BN_>
__global__ void __launch_bounds__(THREADS, BN_ == 64 ? 3 : 2)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, ConvShape s,
                 int epilogue, const float* __restrict__ pa, const float* __restrict__ pb,
                 int n_a, void* __restrict__ out, int xmode, int wmode) {
  conv_tile<BN_, 0>(x, w, s, epilogue, pa, pb, n_a, out, xmode, wmode, 0);
}

// wvec: N % 4 == 0 and w 16-byte aligned (load_slab)
template <int BITS>
__global__ void __launch_bounds__(THREADS, 2)
int8_conv_kernel_packed(const int8_t* __restrict__ x, const uint32_t* __restrict__ w,
                        ConvShape s, int epilogue, const float* __restrict__ pa,
                        const float* __restrict__ pb, int n_a, void* __restrict__ out, int xmode,
                        int wvec, int groups) {
  conv_tile<PACKED_BN, BITS>(x, w, s, epilogue, pa, pb, n_a, out, xmode, wvec, groups);
}

template <int BN_>
cudaError_t launch_conv(const int8_t* x, const int8_t* w, const ConvShape& s, int epilogue,
                        const float* a, const float* b, int n_a, void* out, int device,
                        cudaStream_t stream) {
  constexpr size_t smem = conv_smem<BN_>();
  static bool smem_set[16] = {};
  const cudaError_t err = qt::stream::allow_smem(int8_conv_kernel<BN_>, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  const long long m = (long long)s.B * s.HO * s.WO;
  // M tiles on x (up to 2^31 - 1 of them), N tiles on y
  const dim3 grid((unsigned)((m + CONV_BM - 1) / CONV_BM), (s.N + BN_ - 1) / BN_);
  int8_conv_kernel<BN_><<<grid, THREADS, smem, stream>>>(
      x, w, s, epilogue, a, b, n_a, out, qt::stream::copy_mode(x, s.C),
      qt::stream::copy_mode(w, s.N));
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_packed(const int8_t* x, const uint32_t* w, const ConvShape& s, int epilogue,
                          const float* a, const float* b, int n_a, void* out, int groups,
                          int device, cudaStream_t stream) {
  // the most any shape may take; a launch uses packed_smem(groups, taps, BITS)
  static bool smem_set[16] = {};
  const cudaError_t err = qt::stream::allow_smem(int8_conv_kernel_packed<BITS>,
                                                 qt::stream::SMEM_LIMIT, device, smem_set);
  if (err != cudaSuccess) return err;
  const long long m = (long long)s.B * s.HO * s.WO;
  const dim3 grid((unsigned)((m + CONV_BM - 1) / CONV_BM), (s.N + PACKED_BN - 1) / PACKED_BN);
  const int wvec = s.N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int8_conv_kernel_packed<BITS><<<grid, THREADS, packed_smem(groups, s.KH * s.KW, BITS),
                                  stream>>>(
      x, w, s, epilogue, a, b, n_a, out, qt::stream::copy_mode(x, s.C), wvec, groups);
  return cudaGetLastError();
}

}  // namespace

// qt_int8_conv2d's arguments in one struct, packed by the wrapper
// (kernels/int8_conv.py): the addresses, the shape (the caller computes HO,
// WO from the pads; pad_bottom/right only bound them), the epilogue, the
// tile width bn (64 or 128, kernels/common.py conv_plan), and the weights
// (b is (2, N) under EPI_THRESHOLD, (N,) otherwise):
// bits 0, raw int8 (C KH KW, N); bits 1, 2 or 4, packed words (rows, N) and
// the slab's packed groups (kernels/common.py conv_slab_plan; bn is then
// 64).
struct Int8ConvArgs {
  const void* x;
  const void* w;
  const void* a;
  const void* b;
  void* out;
  cudaStream_t stream;
  ConvShape s;
  int epilogue, n_a, bn, device, bits, groups, rows;
};

extern "C" int qt_int8_conv2d(const Int8ConvArgs* a) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  const ConvShape& s = a->s;
  const long long m = (long long)s.B * s.HO * s.WO;
  const int bits = a->bits, taps = s.KH * s.KW;
  if (a->epilogue < EPI_SCALE || a->epilogue > EPI_THRESHOLD || s.SH < 1 || s.SW < 1 || s.B < 1 ||
      s.HO < 1 || s.WO < 1 || s.N < 1 || s.C < 1 || s.KH < 1 || s.KW < 1 ||
      (a->epilogue != EPI_SCALE && (a->a == nullptr || a->b == nullptr)) ||
      (a->bn != 64 && a->bn != 128) || m > INT_MAX || (s.N + a->bn - 1) / a->bn > 65535 ||
      (bits != 0 && bits != 1 && bits != 2 && bits != 4))
    return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const int8_t*>(a->x);
  const auto* pa = static_cast<const float*>(a->a);
  const auto* pb = static_cast<const float*>(a->b);
  if (bits == 0) {
    const auto f = a->bn == 64 ? launch_conv<64> : launch_conv<128>;
    return (int)f(x, static_cast<const int8_t*>(a->w), s, a->epilogue, pa, pb, a->n_a, a->out,
                  a->device, a->stream);
  }
  // the packed rows cover K = C taps, and the slab is the one the wrapper sized
  if (a->bn != PACKED_BN || a->rows % qt::stream::GROUP_ROWS != 0 ||
      (long long)s.C * taps > (long long)a->rows * (32 / bits) ||
      a->groups != slab_groups(s.C, taps, bits) ||
      packed_smem(a->groups, taps, bits) > qt::stream::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  using Launch = decltype(&launch_packed<1>);
  const Launch f = bits == 1 ? launch_packed<1> : bits == 2 ? launch_packed<2> : launch_packed<4>;
  return (int)f(x, static_cast<const uint32_t*>(a->w), s, a->epilogue, pa, pb, a->n_a, a->out,
                a->groups, a->device, a->stream);
}
