// int8_conv2d: NHWC int8 codes x flat int8 weights -> NHWC output, through an
// int32 accumulator, as an implicit GEMM (no im2col copy in device memory)
// on the int8 tensor cores.
//
// Replaces XLA's int8 conv_general_dilated with preferred_element_type=int32
// in the JAX package (pytorch_quantize_impls_tpu/kernels/conv.py:121-123,
// 130-133, the direct packed conv; infer/fused_chain.py:380-388, the fused
// DoReFa ResNet). That is not a Pallas kernel, but PyTorch has no int8
// convolution on CUDA, and the fused ResNet needs the codes to stay int8
// between convs.
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
#include <climits>

#include "mma_tile.cuh"
#include "stream_tile.cuh"

namespace {

using qt::mma::LDW;
using qt::mma::STAGE_BYTES;
using qt::mma::THREADS;

enum Epilogue { EPI_SCALE = 0, EPI_CODES = 1, EPI_AFFINE = 2 };

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

template <int BN_>
__global__ void __launch_bounds__(THREADS, BN_ == 64 ? 3 : 2)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, ConvShape s,
                 int epilogue, const float* __restrict__ pa, const float* __restrict__ pb,
                 int n_a, void* __restrict__ out, int xmode, int wmode) {
  using T = ConvTile<BN_>;
  extern __shared__ __align__(16) uint32_t smem[];
  // per output row of the tile: its image (-1 past M), and its first input
  // row and column
  int* row_b = reinterpret_cast<int*>(smem + T::SMEM / 4);
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
  __syncthreads();
  const int taps = s.KH * s.KW, cst = (s.C + STAGE_BYTES - 1) / STAGE_BYTES;
  const auto* xb = reinterpret_cast<const uint8_t*>(x);
  const auto* wb = reinterpret_cast<const uint8_t*>(w);

  // stage st: tap st / cst, channels [64 (st % cst), + 64)
  auto load_a = [&](uint32_t* S, int, int k0) {
    const int st = k0 / STAGE_BYTES, tap = st / cst, c0 = (st % cst) * STAGE_BYTES;
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
  // the stage's weight rows c * taps + tap, channels c in [c0, min(c0 + 64, C))
  auto load_w = [&](uint32_t* W, int st, int n0_) {
    const int tap = st / cst, c0 = (st % cst) * STAGE_BYTES;
    qt::stream::load_stage_bytes<BN_>(W, wb, s.N, n0_, wmode, (long)c0 * taps + tap, taps,
                                      s.C - c0);
  };
  auto prep = [](const uint32_t*, const uint32_t* W, int, uint32_t* Bs, uint32_t*) {
    qt::stream::transpose_stage<BN_>(Bs, W);
  };
  int32_t acc[T::MF][T::NF][4];
  const int k_stages = taps * cst;
  qt::stream::stream_mainloop<qt::mma::S8, T>(blockIdx.x, blockIdx.y, 1, k_stages, k_stages,
                                              load_a, load_w, prep, acc);

  // the epilogue, staged: every warp is done with the ring after this barrier
  __syncthreads();
  auto value = [&](int32_t a, int n) -> float {
    const float f = (float)a;
    if (n >= s.N) return 0.0f;
    if (epilogue == EPI_SCALE) return pa != nullptr ? __fmul_rn(f, pa[n]) : f;
    const float y = __fadd_rn(__fmul_rn(pa[n], f), pb[n]);
    if (epilogue == EPI_AFFINE) return y;
    return fminf(fmaxf(rintf(y), 0.0f), (float)n_a);
  };
  const int warp = threadIdx.x >> 5, wm = warp % T::WM, wn = warp / T::WM;
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  constexpr int SF = BN_ + 8, SB = BN_ + 16;  // staged row pitch: floats, code bytes
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
        if (epilogue == EPI_CODES)
          *reinterpret_cast<uint16_t*>(sb + r * SB + c) =
              (uint16_t)((uint8_t)(int8_t)v0 | ((uint16_t)(uint8_t)(int8_t)v1 << 8));
        else
          *reinterpret_cast<float2*>(sf + r * SF + c) = make_float2(v0, v1);
      }
  __syncthreads();
  const int rows = min(CONV_BM, M - m0), cols = min(BN_, s.N - n0);
  if (epilogue == EPI_CODES) {
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

}  // namespace

// qt_int8_conv2d's arguments in one struct, packed by the wrapper
// (kernels/int8_conv.py): the addresses, the shape (the caller computes HO,
// WO from the pads; pad_bottom/right only bound them), the epilogue and
// the tile width bn (64 or 128, kernels/common.py conv_plan).
struct Int8ConvArgs {
  const void* x;
  const void* w;
  const void* a;
  const void* b;
  void* out;
  cudaStream_t stream;
  ConvShape s;
  int epilogue, n_a, bn, device;
};

extern "C" int qt_int8_conv2d(const Int8ConvArgs* a) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  const ConvShape& s = a->s;
  const long long m = (long long)s.B * s.HO * s.WO;
  if (a->epilogue < EPI_SCALE || a->epilogue > EPI_AFFINE || s.SH < 1 || s.SW < 1 || s.B < 1 ||
      s.HO < 1 || s.WO < 1 || s.N < 1 || s.C < 1 || s.KH < 1 || s.KW < 1 ||
      (a->epilogue != EPI_SCALE && (a->a == nullptr || a->b == nullptr)) ||
      (a->bn != 64 && a->bn != 128) || m > INT_MAX || (s.N + a->bn - 1) / a->bn > 65535)
    return (int)cudaErrorInvalidValue;
  const auto f = a->bn == 64 ? launch_conv<64> : launch_conv<128>;
  return (int)f(static_cast<const int8_t*>(a->x), static_cast<const int8_t*>(a->w), s,
                a->epilogue, static_cast<const float*>(a->a), static_cast<const float*>(a->b),
                a->n_a, a->out, a->device, a->stream);
}
