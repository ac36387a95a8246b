// Shared pieces of the int8 GEMM kernels (binary_gemm, int8_gemm).
//
// One block computes a BM x BN output tile with 256 threads laid out 16 x 16;
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4), so a
// warp reads shared memory without bank conflicts. K is walked in tiles of
// BK int8 values. Shared memory holds both operands as int32 quads of four
// consecutive k values (byte 0 = lowest k), which is what __dp4a consumes:
//   As[m][q] = x[m, k0 + 4q .. k0 + 4q + 3]
//   Bs[q][n] = w[k0 + 4q .. k0 + 4q + 3, n]
// The accumulator is int32, as on the TPU; the epilogue is
// f32(acc) * alpha[n] * row_scale[m], in that order, each factor optional.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace qt {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int QK = BK / 4;
constexpr int THREADS = 256;

__device__ __forceinline__ int32_t pack4(int8_t b0, int8_t b1, int8_t b2, int8_t b3) {
  return (int32_t)((uint32_t)(uint8_t)b0 | ((uint32_t)(uint8_t)b1 << 8) |
                   ((uint32_t)(uint8_t)b2 << 16) | ((uint32_t)(uint8_t)b3 << 24));
}

// Stage x[m0 : m0 + BM, k0 : k0 + BK] (row-major int8, M x K) into As.
// Elements outside M x K read as 0. `aligned` means every row starts on a
// 4-byte boundary, so a whole in-range quad is one 32-bit load.
__device__ __forceinline__ void load_a_tile(int32_t (*As)[QK], const int8_t* __restrict__ x,
                                            int m0, int k0, int M, int K, bool aligned) {
  for (int e = threadIdx.x; e < BM * QK; e += THREADS) {
    const int r = e / QK, q = e % QK;
    const int m = m0 + r, k = k0 + 4 * q;
    int32_t v = 0;
    if (m < M) {
      const int8_t* p = x + (size_t)m * K + k;
      if (aligned && k + 3 < K) {
        v = *reinterpret_cast<const int32_t*>(p);
      } else {
        v = pack4(k < K ? p[0] : 0, k + 1 < K ? p[1] : 0, k + 2 < K ? p[2] : 0,
                  k + 3 < K ? p[3] : 0);
      }
    }
    As[r][q] = v;
  }
}

__device__ __forceinline__ void mma_tile(int32_t (*As)[QK], int32_t (*Bs)[BN], int32_t (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < QK; ++q) {
    int32_t a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][q];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[q][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_tile(const int32_t (&acc)[4][4], const float* __restrict__ alpha,
                                           const float* __restrict__ row_scale, float* __restrict__ out,
                                           int m0, int n0, int M, int N) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = (float)acc[i][j];
      if (alpha != nullptr) v = v * alpha[n];
      if (row_scale != nullptr) v = v * row_scale[m];
      out[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace qt
