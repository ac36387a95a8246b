// int8_conv2d: NHWC int8 codes x flat int8 weights -> NHWC output, through an
// int32 accumulator, as an implicit GEMM (no im2col copy in device memory).
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
// GEMM view: M = B * HO * WO output pixels, N output channels, K = C * KH *
// KW. A block computes a 64 x 64 tile of M x N with the 256-thread __dp4a
// tile of gemm_tile.cuh. K is walked tap by tap (dy, dx), and within a tap
// over 32 input channels at a time, so each A row of a k-tile is 32
// consecutive bytes of one input pixel (one 32-bit load per quad when C % 4
// == 0); the B k-tile gathers the same 32 (channel, tap) rows of w. Integer
// sums are exact, so the order of K does not change the result. Bound: the
// ResNet-20 convs at b = 256 do 2 M K N = 328.6 G int8 operations over a few
// tens of MB, so the __dp4a rate of the CUDA cores bounds this design; the
// tensor cores (mma.sync/wgmma, 1979 TOP/s) are later work.
#include "gemm_tile.cuh"

namespace {

enum Epilogue { EPI_SCALE = 0, EPI_CODES = 1, EPI_AFFINE = 2 };

struct ConvShape {
  int B, H, W, C, KH, KW, HO, WO, N, SH, SW, pad_top, pad_left;
};

__global__ void __launch_bounds__(qt::THREADS)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, ConvShape s,
                 int epilogue, const float* __restrict__ pa, const float* __restrict__ pb,
                 int n_a, void* __restrict__ out, bool aligned) {
  __shared__ int32_t As[qt::BM][qt::QK];
  __shared__ int32_t Bs[qt::QK][qt::BN];
  // per output row of the tile: its image, and its first input row/column
  __shared__ int row_b[qt::BM], row_iy[qt::BM], row_ix[qt::BM];
  const int M = s.B * s.HO * s.WO;
  const int m0 = blockIdx.x * qt::BM, n0 = blockIdx.y * qt::BN;
  for (int r = threadIdx.x; r < qt::BM; r += qt::THREADS) {
    const int m = m0 + r;
    if (m < M) {
      const int ox = m % s.WO, t = m / s.WO;
      row_b[r] = t / s.HO;
      row_iy[r] = (t % s.HO) * s.SH - s.pad_top;
      row_ix[r] = ox * s.SW - s.pad_left;
    } else {
      row_b[r] = -1;
    }
  }
  __syncthreads();
  const int taps = s.KH * s.KW;
  int32_t acc[4][4] = {};
  for (int tap = 0; tap < taps; ++tap) {
    const int dy = tap / s.KW, dx = tap % s.KW;
    for (int c0 = 0; c0 < s.C; c0 += qt::BK) {
      for (int e = threadIdx.x; e < qt::BM * qt::QK; e += qt::THREADS) {
        const int r = e / qt::QK, q = e % qt::QK;
        const int c = c0 + 4 * q;
        int32_t v = 0;
        const int iy = row_iy[r] + dy, ix = row_ix[r] + dx;
        if (row_b[r] >= 0 && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W && c < s.C) {
          const int8_t* p = x + (((size_t)row_b[r] * s.H + iy) * s.W + ix) * s.C + c;
          if (aligned && c + 3 < s.C) {
            v = *reinterpret_cast<const int32_t*>(p);
          } else {
            v = qt::pack4(p[0], c + 1 < s.C ? p[1] : 0, c + 2 < s.C ? p[2] : 0,
                          c + 3 < s.C ? p[3] : 0);
          }
        }
        As[r][q] = v;
      }
      for (int e = threadIdx.x; e < qt::QK * qt::BN; e += qt::THREADS) {
        const int q = e / qt::BN, col = e % qt::BN;
        const int n = n0 + col;
        int8_t b[4] = {0, 0, 0, 0};
        if (n < s.N) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 4 * q + j;
            if (c < s.C) b[j] = w[((size_t)c * taps + tap) * s.N + n];
          }
        }
        Bs[q][col] = qt::pack4(b[0], b[1], b[2], b[3]);
      }
      __syncthreads();
      qt::mma_tile(As, Bs, acc);
      __syncthreads();
    }
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= s.N) continue;
      const float f = (float)acc[i][j];
      const size_t o = (size_t)m * s.N + n;
      if (epilogue == EPI_SCALE) {
        static_cast<float*>(out)[o] = pa != nullptr ? __fmul_rn(f, pa[n]) : f;
      } else {
        const float y = __fadd_rn(__fmul_rn(pa[n], f), pb[n]);
        if (epilogue == EPI_AFFINE) {
          static_cast<float*>(out)[o] = y;
        } else {
          static_cast<int8_t*>(out)[o] = (int8_t)fminf(fmaxf(rintf(y), 0.0f), (float)n_a);
        }
      }
    }
  }
}

}  // namespace

// shape = {B, H, W, C, KH, KW, HO, WO, N, SH, SW, pad_top, pad_left}; the
// caller computes HO, WO from the pads (pad_bottom/right only bound them).
extern "C" int qt_int8_conv2d(const void* x, const void* w, const int* shape, int epilogue,
                              const void* a, const void* b, int n_a, void* out, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ConvShape s{shape[0], shape[1], shape[2], shape[3], shape[4], shape[5],
                    shape[6], shape[7], shape[8], shape[9], shape[10], shape[11], shape[12]};
  if (epilogue < EPI_SCALE || epilogue > EPI_AFFINE || s.SH < 1 || s.SW < 1 || s.B < 1 || s.HO < 1 || s.WO < 1 ||
      s.N < 1 || s.C < 1 || (epilogue != EPI_SCALE && (a == nullptr || b == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool aligned = (s.C % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  const long long m = (long long)s.B * s.HO * s.WO;
  // M tiles on x (up to 2^31 - 1 blocks): neighbouring blocks share a B tile
  const dim3 grid((unsigned)((m + qt::BM - 1) / qt::BM), (s.N + qt::BN - 1) / qt::BN);
  int8_conv_kernel<<<grid, qt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), s, epilogue,
      static_cast<const float*>(a), static_cast<const float*>(b), n_a, out, aligned);
  return (int)cudaGetLastError();
}
