// Log-quant (power-of-2) weight kernels over the grouped-planar layout of
// ops/pack.py at 8 bits per code: bit field [8i, 8i + 8) of word[g * 32 + r, n]
// holds the code c of weight row k = g * 128 + i * 32 + r. A code is
// (s << (BITS + 1)) | idx with s = 1 for a POSITIVE weight (IEEE's sign bit 1
// means negative) and idx in [0, 2^BITS]; it stands for ±2^(idx + lo),
// lo = int(fsr) - 2^BITS, whose bf16 bit pattern is assembled directly:
//   neg << 15 | (idx + lo + 127) << 7        (mantissa 0, exact)
// Code 0 is -2^lo, not 0: rows of the last group past K decode to that level
// and cancel only against zero activations.
//
// shift_gemm replaces the Pallas kernel
// pytorch_quantize_impls_tpu/kernels/shift_matmul.py shift_gemm (pallas_call
// at :112): (M, K) f32 x rounded to bf16 (round to nearest even, as XLA's
// convert) times the packed (Kp/4, N) codes -> (M, N) f32 sums. The TPU
// kernel decodes a weight tile to bf16 and feeds the MXU. Here a block owns a
// 64 x 64 output tile (256 threads, 4 x 4 outputs each, as gemm_tile.cuh),
// stages one 32-word group (128 k-rows, 8 KB for 64 columns) of codes in
// shared memory once, and expands each of its 4 byte planes into a 32-deep
// f32 k-tile of ±2^e; x's tile is rounded to bf16 on load and every column
// k >= K reads as 0, so x needs no padded copy. Products of a bf16 value and
// a power of two are exact in f32, so only the order of the f32 sum differs
// from the plain version. Multiply-add runs on the CUDA cores (67 TFLOP/s
// f32 on the H100): at serving batch sizes that, not the 1 byte per weight
// read, bounds it; bf16 tensor-core MMA (wgmma) is later work.
//
// shift_gemm_ws replaces the Pallas kernel shift_matmul.py shift_gemm_ws
// (pallas_call at :205): shift_gemm's contract, with each packed code tile
// decoded to bf16 once for many M tiles. The schedule is binary_gemm_ws's
// (mma_tile.cuh: ws_gemm): a block takes R M-tiles of 64 rows (m_tiles, R in
// {1, 2, 4}) and 64 columns, decodes each 32-row stage (one byte plane) of
// its codes once into bf16 ±2^e in shared memory with log_bf16_bits, rounds
// the R M-tiles' x to bf16 as it stages them, and runs them all on the bf16
// tensor cores (mma.sync m16n8k16, f32 accumulate), the f32 accumulators in
// registers for the whole of K. Every block sums its K in one fixed order,
// with no atomics and no split over K, so two launches give the same bits.
// Products are exact; only the order and rounding of the tensor core's f32
// sum differ from the plain version. Decodes per packed code tile:
// ceil(M / (64 R)) (16 at M = 4096, R = 4). At 4096^3 it is bound by the bf16
// tensor-core rate (0.139 ms at 989 TFLOP/s; its 155 MB take 0.046 ms).
//
// decode_log_weights replaces shift_matmul.py decode_log_weights (pallas_call
// at :260): packed (Kp/4, N) -> bf16 (Kp, N) bit patterns, the same decode.
// An elementwise pass bound by device-memory bandwidth: one thread per
// output quad (4 neighbouring columns of one row) reads the 4 words that hold
// them and writes 8 bytes; neighbouring threads take neighbouring quads, so
// loads and stores coalesce.
#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int GROUP_ROWS = 32;  // words per self-contained group
constexpr int GROUP_K = 128;    // k-rows per group: 4 codes per word
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;          // one byte plane of a group
constexpr int THREADS = 256;

// bf16 bit pattern (low 16 bits) of the code in the low byte of `c`
__device__ __forceinline__ uint32_t log_bf16_bits(uint32_t c, int bits, int lo) {
  const uint32_t neg = 1u - ((c >> (bits + 1)) & 1u);
  const uint32_t idx = c & ((1u << (bits + 1)) - 1u);
  return ((neg << 15) | ((uint32_t)((int)idx + lo + 127) << 7)) & 0xFFFFu;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t b) { return __uint_as_float(b << 16); }

__global__ void __launch_bounds__(THREADS)
shift_gemm_kernel(const float* __restrict__ x, const uint32_t* __restrict__ wp,
                  float* __restrict__ out, int M, int N, int K, int bits, int lo) {
  __shared__ float As[BK][BM + 1];  // k-major; +1 keeps the transposing store conflict-free
  __shared__ float Bs[BK][BN];
  __shared__ uint32_t Ws[GROUP_ROWS][BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int g = 0; g * GROUP_K < K; ++g) {
    for (int e = threadIdx.x; e < GROUP_ROWS * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      Ws[r][c] = (n0 + c < N) ? wp[(size_t)(g * GROUP_ROWS + r) * N + n0 + c] : 0u;
    }
    __syncthreads();
    for (int i = 0; i < 4 && g * GROUP_K + i * BK < K; ++i) {
      const int k0 = g * GROUP_K + i * BK;
      // neighbouring threads read neighbouring k of one row of x
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int m = m0 + r, k = k0 + kk;
        float v = 0.0f;
        if (m < M && k < K) v = __bfloat162float(__float2bfloat16_rn(x[(size_t)m * K + k]));
        As[kk][r] = v;
      }
      // plane i of word row r holds weight row k0 + r
      for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        Bs[r][c] = bf16_bits_to_float(log_bf16_bits((Ws[r][c] >> (8 * i)) & 0xFFu, bits, lo));
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) a[p] = As[kk][ty + 16 * p];
#pragma unroll
        for (int q = 0; q < 4; ++q) b[q] = Bs[kk][tx + 16 * q];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + ty + 16 * p;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 16 * q;
      if (n < N) out[(size_t)m * N + n] = acc[p][q];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(qt::mma::THREADS)
shift_gemm_ws_kernel(const float* __restrict__ x, const uint32_t* __restrict__ wp,
                     float* __restrict__ out, int M, int N, int K, int bits, int lo, bool vec) {
  using namespace qt::mma;
  auto load_a = [&](uint32_t* As, int m0, int k0) {
    load_rows_f32_as_bf16(As, x, m0, 64 * R, M, k0, K, vec);
  };
  // word q of column c: byte plane `plane` of word rows 2q and 2q + 1, i.e.
  // weight rows k0 + 2q (low half) and k0 + 2q + 1 (high half), as bf16
  auto decode = [&](uint32_t* Bs, const uint32_t* Ws, int plane) {
    for (int e = threadIdx.x; e < 16 * 64; e += qt::mma::THREADS) {
      const int c = e % 64, q = e / 64;
      const uint32_t lo16 = log_bf16_bits((Ws[2 * q * 64 + c] >> (8 * plane)) & 0xFFu, bits, lo);
      const uint32_t hi16 = log_bf16_bits((Ws[(2 * q + 1) * 64 + c] >> (8 * plane)) & 0xFFu, bits, lo);
      Bs[c * LDW + q] = lo16 | (hi16 << 16);
    }
  };
  auto store = [&](int m, int n, float acc) {
    if (m < M && n < N) out[(size_t)m * N + n] = acc;
  };
  ws_gemm<BF16, R>(wp, N, K, GROUP_K, load_a, decode, store);
}

__global__ void decode_log_kernel(const uint32_t* __restrict__ wp, uint16_t* __restrict__ out,
                                  int R, int N, int bits, int lo, bool vec) {
  const int nq = (N + 3) / 4;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * 4 * nq) return;
  const int k = (int)(idx / nq), n0 = 4 * (int)(idx % nq);
  const int g = k / GROUP_K, rem = k % GROUP_K;
  const int plane = rem / GROUP_ROWS, r = rem % GROUP_ROWS;
  const uint32_t* w = wp + (size_t)(g * GROUP_ROWS + r) * N;
  uint16_t* o = out + (size_t)k * N + n0;
  if (vec) {  // N % 4 == 0: the quad is one aligned 64-bit store
    uint32_t h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = log_bf16_bits((w[n0 + j] >> (8 * plane)) & 0xFFu, bits, lo);
    *reinterpret_cast<uint2*>(o) = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
  } else {
    for (int j = 0; j < 4 && n0 + j < N; ++j)
      o[j] = (uint16_t)log_bf16_bits((w[n0 + j] >> (8 * plane)) & 0xFFu, bits, lo);
  }
}

bool valid(int R, int bits) { return R % GROUP_ROWS == 0 && bits >= 1 && bits <= 6; }

}  // namespace

// R = rows of the packed weight = Kp / 4; K <= Kp is the width of x.
extern "C" int qt_shift_gemm(const void* x, const void* wp, void* out, int M, int N, int K, int R,
                             int bits, int lo, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid(R, bits) || K > R * 4) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  shift_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint32_t*>(wp), static_cast<float*>(out),
      M, N, K, bits, lo);
  return (int)cudaGetLastError();
}

extern "C" int qt_shift_gemm_ws(const void* x, const void* wp, void* out, int M, int N, int K,
                                int R, int bits, int lo, int m_tiles, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid(R, bits) || K > R * 4) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const bool vec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid((N + 63) / 64, (M + 64 * m_tiles - 1) / (64 * m_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* w = static_cast<const uint32_t*>(wp);
  auto* o = static_cast<float*>(out);
  switch (m_tiles) {
    case 1: shift_gemm_ws_kernel<1><<<grid, qt::mma::THREADS, 0, s>>>(xp, w, o, M, N, K, bits, lo, vec); break;
    case 2: shift_gemm_ws_kernel<2><<<grid, qt::mma::THREADS, 0, s>>>(xp, w, o, M, N, K, bits, lo, vec); break;
    case 4: shift_gemm_ws_kernel<4><<<grid, qt::mma::THREADS, 0, s>>>(xp, w, o, M, N, K, bits, lo, vec); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int qt_decode_log(const void* wp, void* out, int R, int N, int bits, int lo, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid(R, bits)) return (int)cudaErrorInvalidValue;
  if (R == 0 || N == 0) return (int)cudaSuccess;
  const size_t quads = (size_t)R * 4 * ((N + 3) / 4);
  const unsigned blocks = (unsigned)((quads + 255) / 256);
  const bool vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 8 == 0);
  decode_log_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wp), static_cast<uint16_t*>(out), R, N, bits, lo, vec);
  return (int)cudaGetLastError();
}
