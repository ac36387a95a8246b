// int8_gemm: (M, K) int8 x (K, N) int8 -> (M, N) f32 through an int32
// accumulator, with the optional alpha[n] / row_scale[m] epilogue.
//
// Replaces the Pallas kernel pytorch_quantize_impls_tpu/kernels/int8_matmul.py
// int8_gemm (pallas_call at :99), the serving path for prepared (decoded ±1)
// binary weights. Bound: at serving batch sizes (M <= 256, N <= 1024,
// K = 4096) the operands are a few MB and the kernel is bound by the integer
// dot-product rate of the CUDA cores (__dp4a, four int8 MACs per
// instruction); at M = 1 it reads the whole weight once and is bound by
// device-memory bandwidth. The design stages 64 x 32 and 32 x 64 int8 tiles
// through shared memory as k-quads and gives each thread a 4 x 4 block of
// accumulators; tensor-core (mma/wgmma) and TMA designs are later work.
#include "gemm_tile.cuh"

namespace {

__device__ __forceinline__ void load_b_tile(int32_t (*Bs)[qt::BN], const int8_t* __restrict__ w,
                                            int k0, int n0, int K, int N) {
  for (int e = threadIdx.x; e < qt::QK * qt::BN; e += qt::THREADS) {
    const int q = e / qt::BN, c = e % qt::BN;
    const int n = n0 + c, k = k0 + 4 * q;
    int8_t b[4] = {0, 0, 0, 0};
    if (n < N) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < K) b[j] = w[(size_t)(k + j) * N + n];
    }
    Bs[q][c] = qt::pack4(b[0], b[1], b[2], b[3]);
  }
}

__global__ void __launch_bounds__(qt::THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ alpha, const float* __restrict__ row_scale,
                 float* __restrict__ out, int M, int N, int K, bool aligned) {
  __shared__ int32_t As[qt::BM][qt::QK];
  __shared__ int32_t Bs[qt::QK][qt::BN];
  const int m0 = blockIdx.y * qt::BM, n0 = blockIdx.x * qt::BN;
  int32_t acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += qt::BK) {
    qt::load_a_tile(As, x, m0, k0, M, K, aligned);
    load_b_tile(Bs, w, k0, n0, K, N);
    __syncthreads();
    qt::mma_tile(As, Bs, acc);
    __syncthreads();
  }
  qt::store_tile(acc, alpha, row_scale, out, m0, n0, M, N);
}

}  // namespace

extern "C" int qt_int8_gemm(const void* x, const void* w, const void* alpha, const void* row_scale,
                            void* out, int M, int N, int K, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  const dim3 grid((N + qt::BN - 1) / qt::BN, (M + qt::BM - 1) / qt::BM);
  int8_gemm_kernel<<<grid, qt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(alpha),
      static_cast<const float*>(row_scale), static_cast<float*>(out), M, N, K, aligned);
  return (int)cudaGetLastError();
}
