// 1-bit weight kernels over the grouped-planar layout of ops/pack.py:
// bit i of word[g * 32 + r, n] holds weight row k = g * 1024 + i * 32 + r,
// bit 1 -> +1 and bit 0 -> -1.
//
// binary_gemm replaces the Pallas kernel
// pytorch_quantize_impls_tpu/kernels/xnor_gemm.py binary_gemm (pallas_call at
// :132): (M, K) int8 activations (±1, or 0 in padding) x packed (Kp/32, N)
// weights -> (M, N) f32 through an int32 accumulator, then
// f32(acc) * alpha[n] * row_scale[m]. It is int8_gemm with the weight tile
// unpacked in shared memory: a block stages one 32-word group (1024 k-rows,
// 8 KB for 64 columns) once and expands it bit plane by bit plane into ±1
// int8 k-quads, so the weights cross device memory at 1 bit each. Bound like
// int8_gemm by the __dp4a rate at serving batch sizes; the activation may
// hold 0, so the XNOR-popcount identity is not used.
//
// decode_binary_weights replaces xnor_gemm.py decode_binary_weights
// (pallas_call at :308): packed (Kp/32, N) -> ±1 int8 (Kp, N). It is an
// elementwise pass bound by device-memory bandwidth (reads 1 bit, writes
// 8 bits per weight); one thread per word writes its 32 int8 values, and
// neighbouring threads take neighbouring columns so every access coalesces.
#include "gemm_tile.cuh"

namespace {

constexpr int GROUP_ROWS = 32;          // words per self-contained group
constexpr int GROUP_K = 32 * GROUP_ROWS;  // k-rows per group

__global__ void __launch_bounds__(qt::THREADS)
binary_gemm_kernel(const int8_t* __restrict__ x, const uint32_t* __restrict__ wp,
                   const float* __restrict__ alpha, const float* __restrict__ row_scale,
                   float* __restrict__ out, int M, int N, int K, bool aligned) {
  __shared__ int32_t As[qt::BM][qt::QK];
  __shared__ int32_t Bs[qt::QK][qt::BN];
  __shared__ uint32_t Ws[GROUP_ROWS][qt::BN];
  const int m0 = blockIdx.y * qt::BM, n0 = blockIdx.x * qt::BN;
  int32_t acc[4][4] = {};
  // Columns k >= K of x are zero, so groups and planes past K add nothing.
  for (int g = 0; g * GROUP_K < K; ++g) {
    for (int e = threadIdx.x; e < GROUP_ROWS * qt::BN; e += qt::THREADS) {
      const int r = e / qt::BN, c = e % qt::BN;
      Ws[r][c] = (n0 + c < N) ? wp[(size_t)(g * GROUP_ROWS + r) * N + n0 + c] : 0u;
    }
    __syncthreads();
    for (int i = 0; i < 32 && g * GROUP_K + i * qt::BK < K; ++i) {
      const int k0 = g * GROUP_K + i * qt::BK;
      qt::load_a_tile(As, x, m0, k0, M, K, aligned);
      // Plane i of rows 4q .. 4q + 3 is weight rows k0 + 4q .. k0 + 4q + 3.
      for (int e = threadIdx.x; e < qt::QK * qt::BN; e += qt::THREADS) {
        const int q = e / qt::BN, c = e % qt::BN;
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) v |= (((Ws[4 * q + j][c] >> i) & 1u) ? 0x01u : 0xFFu) << (8 * j);
        Bs[q][c] = (int32_t)v;
      }
      __syncthreads();
      qt::mma_tile(As, Bs, acc);
      __syncthreads();
    }
  }
  qt::store_tile(acc, alpha, row_scale, out, m0, n0, M, N);
}

__global__ void decode_binary_kernel(const uint32_t* __restrict__ wp, int8_t* __restrict__ out,
                                     int R, int N) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * N) return;
  const int n = (int)(idx % N), row = (int)(idx / N);
  const int g = row / GROUP_ROWS, r = row % GROUP_ROWS;
  const uint32_t word = wp[idx];
  int8_t* o = out + ((size_t)g * GROUP_K + r) * N + n;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[(size_t)i * 32 * N] = ((word >> i) & 1u) ? 1 : -1;
}

}  // namespace

// R = rows of the packed weight = Kp / 32; K <= Kp is the width of x.
extern "C" int qt_binary_gemm(const void* x, const void* wp, const void* alpha, const void* row_scale,
                              void* out, int M, int N, int K, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K > R * 32 || R % GROUP_ROWS != 0) return (int)cudaErrorInvalidValue;
  const bool aligned = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  const dim3 grid((N + qt::BN - 1) / qt::BN, (M + qt::BM - 1) / qt::BM);
  binary_gemm_kernel<<<grid, qt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint32_t*>(wp), static_cast<const float*>(alpha),
      static_cast<const float*>(row_scale), static_cast<float*>(out), M, N, K, aligned);
  return (int)cudaGetLastError();
}

extern "C" int qt_decode_binary(const void* wp, void* out, int R, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R % GROUP_ROWS != 0) return (int)cudaErrorInvalidValue;
  const size_t words = (size_t)R * N;
  const unsigned blocks = (unsigned)((words + 255) / 256);
  decode_binary_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wp), static_cast<int8_t*>(out), R, N);
  return (int)cudaGetLastError();
}
