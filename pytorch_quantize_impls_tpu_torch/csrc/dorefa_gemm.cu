// DoReFa k-bit weight kernels over the grouped-planar layout of ops/pack.py:
// with f = 32 / BITS codes per word, bit field [BITS * i, BITS * (i + 1)) of
// word[g * 32 + r, n] holds the code c of weight row k = g * 32 f + i * 32 + r.
// A code c in [0, n_w] (n_w = 2^BITS - 1) stands for the centered integer
// d = 2c - n_w, odd and within ±15, so it is int8-exact.
//
// dorefa_gemm replaces the Pallas kernel
// pytorch_quantize_impls_tpu/kernels/packed_matmul.py dorefa_gemm (pallas_call
// at :156): (M, K) int8 activation codes in [0, n_a] x packed (Kp/f, N)
// weight codes -> (M, N) f32 = f32(sum_k a[m, k] d[k, n]) * inv_scale, with
// inv_scale = f32(1 / (n_w n_a)), the same value dorefa_gemm_decoded gives
// int8_gemm as alpha, so the two paths agree bit for bit. It is binary_gemm
// with the unpack widened to BITS-bit fields: a block stages one 32-word group
// (32 f k-rows, 8 KB for 64 columns) in shared memory once, and each of its f
// bit planes is one 32-deep k-tile, expanded into centered int8 k-quads for
// __dp4a. Weights cross device memory at BITS bits each. Rows of the packed
// group past K decode to -n_w; load_a_tile reads the activation columns
// k >= K as 0, which cancels them. Bound by the __dp4a rate at serving
// batch sizes, by the weight bytes at M = 1.
//
// dorefa_gemm_ws replaces the Pallas kernel packed_matmul.py dorefa_gemm_ws
// (pallas_call at :257): dorefa_gemm's contract and epilogue (so it equals
// dorefa_gemm and dorefa_gemm_decoded bit for bit), with each packed weight
// tile decoded once for many M tiles. The schedule is binary_gemm_ws's
// (mma_tile.cuh: ws_gemm): a block takes R M-tiles of 64 rows (m_tiles, R in
// {1, 2, 4}) and 64 columns, decodes each 64-row stage (two bit planes) of
// its weights once into centered int8 in shared memory, and runs all R
// M-tiles against it on the int8 tensor cores (mma.sync m16n8k32), the int32
// accumulators in registers for the whole of K. Decodes per packed weight
// tile: ceil(M / (64 R)) (16 at M = 4096, R = 4). At 4096^3 it is bound by
// the int8 tensor-core rate (0.069 ms at 1979 TOP/s; its 88 MB at 4 bits take
// 0.026 ms), and below that by its unpipelined shared-memory stages.
//
// decode_dorefa_weights replaces packed_matmul.py decode_dorefa_weights
// (pallas_call at :315): packed (Kp/f, N) -> centered int8 (Kp, N). An
// elementwise pass bound by device-memory bandwidth: one thread per output
// quad (4 neighbouring columns of one row), which reads the 4 words that
// hold them and writes one 32-bit word; neighbouring threads take
// neighbouring quads, so loads and stores coalesce.
#include "gemm_tile.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int GROUP_ROWS = 32;  // words per self-contained group

template <int BITS>
__device__ __forceinline__ uint32_t centered_byte(uint32_t word, int plane) {
  constexpr int NW = (1 << BITS) - 1;
  const int c = (int)((word >> (BITS * plane)) & (uint32_t)NW);
  return (uint32_t)(uint8_t)(int8_t)(2 * c - NW);
}

template <int BITS>
__global__ void __launch_bounds__(qt::THREADS)
dorefa_gemm_kernel(const int8_t* __restrict__ x, const uint32_t* __restrict__ wp,
                   float* __restrict__ out, int M, int N, int K, float inv_scale, bool aligned) {
  constexpr int F = 32 / BITS;
  constexpr int GROUP_K = F * GROUP_ROWS;
  static_assert(qt::BK == GROUP_ROWS, "one bit plane of a group is one k-tile");
  __shared__ int32_t As[qt::BM][qt::QK];
  __shared__ int32_t Bs[qt::QK][qt::BN];
  __shared__ uint32_t Ws[GROUP_ROWS][qt::BN];
  const int m0 = blockIdx.y * qt::BM, n0 = blockIdx.x * qt::BN;
  int32_t acc[4][4] = {};
  for (int g = 0; g * GROUP_K < K; ++g) {
    for (int e = threadIdx.x; e < GROUP_ROWS * qt::BN; e += qt::THREADS) {
      const int r = e / qt::BN, c = e % qt::BN;
      Ws[r][c] = (n0 + c < N) ? wp[(size_t)(g * GROUP_ROWS + r) * N + n0 + c] : 0u;
    }
    __syncthreads();
    for (int i = 0; i < F && g * GROUP_K + i * qt::BK < K; ++i) {
      qt::load_a_tile(As, x, m0, g * GROUP_K + i * qt::BK, M, K, aligned);
      // plane i of word rows 4q .. 4q + 3 holds weight rows k0 + 4q .. k0 + 4q + 3
      for (int e = threadIdx.x; e < qt::QK * qt::BN; e += qt::THREADS) {
        const int q = e / qt::BN, c = e % qt::BN;
        uint32_t v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) v |= centered_byte<BITS>(Ws[4 * q + j][c], i) << (8 * j);
        Bs[q][c] = (int32_t)v;
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
      if (n < N) out[(size_t)m * N + n] = (float)acc[i][j] * inv_scale;
    }
  }
}

template <int BITS, int R>
__global__ void __launch_bounds__(qt::mma::THREADS)
dorefa_gemm_ws_kernel(const int8_t* __restrict__ x, const uint32_t* __restrict__ wp,
                      float* __restrict__ out, int M, int N, int K, float inv_scale, bool vec) {
  using namespace qt::mma;
  auto load_a = [&](uint32_t* As, int m0, int k0) {
    load_rows_bytes(As, reinterpret_cast<const uint8_t*>(x), m0, 64 * R, M, k0, K, vec);
  };
  // word q of column c: bit field plane0 + q / 8 of word rows 4 (q % 8) ..
  // + 3, i.e. weight rows k0 + 4q .. k0 + 4q + 3, as centered int8
  auto decode = [](uint32_t* Bs, const uint32_t* Ws, int plane0) {
    for (int e = threadIdx.x; e < 16 * 64; e += THREADS) {
      const int c = e % 64, q = e / 64;
      const int plane = plane0 + (q >> 3), r = 4 * (q & 7);
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) v |= centered_byte<BITS>(Ws[(r + j) * 64 + c], plane) << (8 * j);
      Bs[c * LDW + q] = v;
    }
  };
  auto store = [&](int m, int n, int32_t acc) {
    if (m < M && n < N) out[(size_t)m * N + n] = (float)acc * inv_scale;
  };
  ws_gemm<S8, R>(wp, N, K, (32 / BITS) * GROUP_ROWS, load_a, decode, store);
}

template <int BITS>
__global__ void decode_dorefa_kernel(const uint32_t* __restrict__ wp, int8_t* __restrict__ out,
                                     int R, int N, bool vec) {
  constexpr int F = 32 / BITS;
  constexpr int GROUP_K = F * GROUP_ROWS;
  const int nq = (N + 3) / 4;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)R * F * nq) return;
  const int k = (int)(idx / nq), n0 = 4 * (int)(idx % nq);
  const int g = k / GROUP_K, rem = k % GROUP_K;
  const int plane = rem / GROUP_ROWS, r = rem % GROUP_ROWS;
  const uint32_t* w = wp + (size_t)(g * GROUP_ROWS + r) * N;
  int8_t* o = out + (size_t)k * N + n0;
  if (vec) {  // N % 4 == 0: the quad is one aligned 32-bit word
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) v |= centered_byte<BITS>(w[n0 + j], plane) << (8 * j);
    *reinterpret_cast<uint32_t*>(o) = v;
  } else {
    for (int j = 0; j < 4 && n0 + j < N; ++j) o[j] = (int8_t)centered_byte<BITS>(w[n0 + j], plane);
  }
}

template <int BITS>
cudaError_t launch_gemm(const void* x, const void* wp, void* out, int M, int N, int K,
                        float inv_scale, cudaStream_t stream) {
  const bool aligned = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);
  const dim3 grid((N + qt::BN - 1) / qt::BN, (M + qt::BM - 1) / qt::BM);
  dorefa_gemm_kernel<BITS><<<grid, qt::THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint32_t*>(wp), static_cast<float*>(out),
      M, N, K, inv_scale, aligned);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_gemm_ws(const void* x, const void* wp, void* out, int M, int N, int K,
                           float inv_scale, int m_tiles, cudaStream_t stream) {
  const bool vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const dim3 grid((N + 63) / 64, (M + 64 * m_tiles - 1) / (64 * m_tiles));
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* w = static_cast<const uint32_t*>(wp);
  auto* o = static_cast<float*>(out);
  switch (m_tiles) {
    case 1: dorefa_gemm_ws_kernel<BITS, 1><<<grid, qt::mma::THREADS, 0, stream>>>(xp, w, o, M, N, K, inv_scale, vec); break;
    case 2: dorefa_gemm_ws_kernel<BITS, 2><<<grid, qt::mma::THREADS, 0, stream>>>(xp, w, o, M, N, K, inv_scale, vec); break;
    case 4: dorefa_gemm_ws_kernel<BITS, 4><<<grid, qt::mma::THREADS, 0, stream>>>(xp, w, o, M, N, K, inv_scale, vec); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_decode(const void* wp, void* out, int R, int N, cudaStream_t stream) {
  const size_t quads = (size_t)R * (32 / BITS) * ((N + 3) / 4);
  const unsigned blocks = (unsigned)((quads + 255) / 256);
  const bool vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  decode_dorefa_kernel<BITS><<<blocks, 256, 0, stream>>>(
      static_cast<const uint32_t*>(wp), static_cast<int8_t*>(out), R, N, vec);
  return cudaGetLastError();
}

}  // namespace

// R = rows of the packed weight = Kp / f; K <= Kp is the width of x.
extern "C" int qt_dorefa_gemm(const void* x, const void* wp, void* out, int M, int N, int K,
                              int R, int bits, float inv_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R % GROUP_ROWS != 0 || (bits != 1 && bits != 2 && bits != 4) || K > R * (32 / bits))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return (int)launch_gemm<1>(x, wp, out, M, N, K, inv_scale, s);
    case 2: return (int)launch_gemm<2>(x, wp, out, M, N, K, inv_scale, s);
    default: return (int)launch_gemm<4>(x, wp, out, M, N, K, inv_scale, s);
  }
}

extern "C" int qt_dorefa_gemm_ws(const void* x, const void* wp, void* out, int M, int N, int K,
                                 int R, int bits, float inv_scale, int m_tiles, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R % GROUP_ROWS != 0 || (bits != 1 && bits != 2 && bits != 4) || K > R * (32 / bits))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return (int)launch_gemm_ws<1>(x, wp, out, M, N, K, inv_scale, m_tiles, s);
    case 2: return (int)launch_gemm_ws<2>(x, wp, out, M, N, K, inv_scale, m_tiles, s);
    default: return (int)launch_gemm_ws<4>(x, wp, out, M, N, K, inv_scale, m_tiles, s);
  }
}

extern "C" int qt_decode_dorefa(const void* wp, void* out, int R, int N, int bits, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R % GROUP_ROWS != 0 || (bits != 1 && bits != 2 && bits != 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return (int)launch_decode<1>(wp, out, R, N, s);
    case 2: return (int)launch_decode<2>(wp, out, R, N, s);
    default: return (int)launch_decode<4>(wp, out, R, N, s);
  }
}
