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
// int8_gemm as alpha, so the two paths agree bit for bit. The schedule is
// stream_tile.cuh's: a block owns a BM x 64 output tile (BM 32 or 64) and one
// chunk of K; cp.async keeps two 64-deep stages of activation codes and the
// 32-word groups they need in flight; each stage's two bit planes are decoded
// ONCE into centered int8 (decode_packed_stage) for the int8 tensor cores
// (mma.sync m16n8k32, exact int32 sums). Weights cross device memory at BITS
// bits each: at serving batch sizes those bytes bound it (M = 32, K = 1024,
// N = 4096 at 4 bits: 2.1 MB, 0.6 us at 3.35 TB/s), so where the tile grid
// cannot fill the 132 SMs the launch splits K (kernels/common.py
// stream_plan): each split writes its int32 partial tile to a workspace and
// dorefa_gemm_kernel_sum adds them (exact in any order) and applies the
// epilogue once. At 4096^3 the int8 tensor-core rate bounds it (0.069 ms).
// Rows of the packed group past K decode to -n_w; activation columns k >= K
// read as 0 (cp.async zero-fill), which cancels them.
//
// dorefa_gemm_ws replaces the Pallas kernel packed_matmul.py dorefa_gemm_ws
// (pallas_call at :257): dorefa_gemm's contract and epilogue (so it equals
// dorefa_gemm and dorefa_gemm_decoded bit for bit), with each packed weight
// tile decoded once for R M-tiles of 64 rows (m_tiles, R in {1, 2, 4}). A
// block takes R M-tiles and 128 columns on the weight-stationary s8 tile
// body of packed_ws.cuh (binary_gemm_ws's, at BITS bits): TMA loads x's
// 128-byte stages, a decoder warpgroup turns four bit fields of each
// column's 32 words into the centered int8 weight stage (2c - n_w, four
// bytes at a time with no carry between them) K-major in the 128-byte
// swizzle, and R consumer warpgroups run wgmma m64n128k32 s8 on it, the
// int32 sums in registers for the whole of K. Decodes per packed weight
// tile: ceil(M / (64 R)). At 4096^3 it is bound by the int8 tensor-core
// rate (0.069 ms at 1979 TOP/s; its 88 MB at 4 bits take 0.026 ms).
//
// decode_dorefa_weights replaces packed_matmul.py decode_dorefa_weights
// (pallas_call at :315): packed (Kp/f, N) -> centered int8 (Kp, N), the
// one-pass decode of plane_decode.cuh (each word read once, chunks of 4
// words a thread, a 4-byte store to each bit field's row), which
// prepare() and the packed conv's two-launch route (kernels/common.py
// conv_route) run; the packed conv's fused route decodes inside K5's weight
// stage instead (int8_conv.cu).
#include "mma_tile.cuh"
#include "packed_ws.cuh"
#include "plane_decode.cuh"
#include "stream_tile.cuh"

namespace {

using qt::ws::GROUP_ROWS;  // words per self-contained group

// K6 on stream_tile.cuh's schedule (packed_code_gemm). part: the split's
// workspace of int32 partials (splits, M, N), null when K is not split.
template <int BITS, int BM>
__global__ void __launch_bounds__(qt::mma::THREADS)
dorefa_gemm_kernel(const int8_t* __restrict__ x, const uint32_t* __restrict__ wp,
                   float* __restrict__ out, int32_t* __restrict__ part, int M, int N, int K,
                   float inv_scale, int k_stages, int chunk, int xmode, bool wvec) {
  qt::stream::packed_code_gemm<BITS, BM>(
      x, wp, M, N, K, k_stages, chunk, xmode, wvec, [&](int m, int n, int32_t acc) {
        if (m >= M || n >= N) return;
        if (part)
          part[((size_t)blockIdx.z * M + m) * N + n] = acc;
        else
          out[(size_t)m * N + n] = (float)acc * inv_scale;
      });
}

// The split's second pass: the int32 partials summed (exact in any order),
// then the epilogue once.
__global__ void dorefa_gemm_kernel_sum(const int32_t* __restrict__ part, float* __restrict__ out,
                                       size_t mn, int splits, float inv_scale) {
  qt::stream::sum_splits(part, mn, splits,
                         [&](size_t i, int32_t s) { out[i] = (float)s * inv_scale; });
}

// K11's epilogue: the dequantization, once.
struct DorefaEpilogue {
  float inv_scale;
  __device__ __forceinline__ float operator()(int32_t acc, int, int) const {
    return (float)acc * inv_scale;
  }
};

// K11: packed_ws.cuh's tile body at BITS bits; x: uint8 tensor map (M x K,
// row pitch a multiple of 16 bytes).
template <int BITS, int R>
__global__ void __launch_bounds__(qt::ws::PackedWsTile<BITS, R>::THREADS,
                                  qt::ws::PackedWsTile<BITS, R>::BLOCKS)
dorefa_gemm_ws_kernel(const __grid_constant__ CUtensorMap xmap, const uint32_t* __restrict__ wp,
                      DorefaEpilogue epi, float* __restrict__ out, int M, int N, int K) {
  qt::ws::packed_ws_gemm<BITS, R>(xmap, wp, epi, out, M, N, K);
}

template <int BITS>
__global__ void __launch_bounds__(qt::planes::THREADS)
decode_dorefa_kernel(const uint32_t* __restrict__ wp, int8_t* __restrict__ out, int R, int N,
                     int mode) {
  qt::planes::decode_planes<BITS>(wp, out, R, N, mode);
}

template <int BITS, int BM>
cudaError_t launch_gemm(const void* x, const void* wp, void* out, void* ws, int M, int N, int K,
                        float inv_scale, int splits, int chunk, int device, cudaStream_t stream) {
  constexpr size_t smem = qt::stream::PackedTile<BM, BM * qt::mma::LDW, false>::SMEM;
  constexpr int STAGE_K = qt::mma::STAGE_BYTES;
  static bool smem_set[16] = {};
  const cudaError_t err =
      qt::stream::allow_smem(dorefa_gemm_kernel<BITS, BM>, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  const int xmode = qt::stream::copy_mode(x, K);
  const bool wvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  const dim3 grid((N + qt::stream::BN - 1) / qt::stream::BN, (M + BM - 1) / BM, splits);
  auto* o = static_cast<float*>(out);
  auto* part = static_cast<int32_t*>(ws);
  dorefa_gemm_kernel<BITS, BM><<<grid, qt::mma::THREADS, smem, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const uint32_t*>(wp), o,
      splits > 1 ? part : nullptr, M, N, K, inv_scale, (K + STAGE_K - 1) / STAGE_K,
      chunk / STAGE_K, xmode, wvec);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || splits == 1) return launched;
  const size_t mn = (size_t)M * N;
  dorefa_gemm_kernel_sum<<<qt::stream::sum_blocks(mn), 256, 0, stream>>>(part, o, mn, splits,
                                                                          inv_scale);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_gemm_ws(const void* x, int pitch, const uint32_t* wp, float* out, int M, int N,
                           int K, float inv_scale, int m_tiles, int device, cudaStream_t s) {
  const DorefaEpilogue epi{inv_scale};
  switch (m_tiles) {
    case 1: return qt::ws::launch<BITS, 1>(dorefa_gemm_ws_kernel<BITS, 1>, x, pitch, wp, epi, out, M, N, K, device, s);
    case 2: return qt::ws::launch<BITS, 2>(dorefa_gemm_ws_kernel<BITS, 2>, x, pitch, wp, epi, out, M, N, K, device, s);
    case 4: return qt::ws::launch<BITS, 4>(dorefa_gemm_ws_kernel<BITS, 4>, x, pitch, wp, epi, out, M, N, K, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qt_dorefa_gemm's arguments in one struct, packed by the wrapper
// (kernels/packed_matmul.py): ctypes converts each argument of a call on its
// own, and fifteen of them cost the host more than the launch. R = rows of
// the packed weight = Kp / f; K <= Kp is the width of x. The launch plan
// (bm, splits, chunk: k per split) is kernels/common.py stream_plan's; when
// splits > 1, ws holds splits * M * N int32.
struct DorefaGemmArgs {
  const void* x;
  const void* wp;
  void* out;
  void* ws;
  cudaStream_t stream;
  int M, N, K, R, bits;
  float inv_scale;
  int bm, splits, chunk, device;
};

extern "C" int qt_dorefa_gemm(const DorefaGemmArgs* a) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  const int bits = a->bits;
  const int k_stages = (a->K + qt::mma::STAGE_BYTES - 1) / qt::mma::STAGE_BYTES;
  if (a->R % GROUP_ROWS != 0 || (bits != 1 && bits != 2 && bits != 4) ||
      a->K > a->R * (32 / bits) ||
      !qt::stream::valid_plan(a->bm, a->splits, a->chunk, qt::mma::STAGE_BYTES, k_stages, a->ws))
    return (int)cudaErrorInvalidValue;
  if (a->M == 0 || a->N == 0) return (int)cudaSuccess;
  using Launch = decltype(&launch_gemm<4, 64>);
  static constexpr Launch launches[3][3] = {
      {launch_gemm<1, 32>, launch_gemm<2, 32>, launch_gemm<4, 32>},
      {launch_gemm<1, 64>, launch_gemm<2, 64>, launch_gemm<4, 64>},
      {launch_gemm<1, 128>, launch_gemm<2, 128>, launch_gemm<4, 128>}};
  const Launch f = launches[a->bm == 32 ? 0 : a->bm == 64 ? 1 : 2][bits == 1 ? 0 : bits == 2 ? 1 : 2];
  return (int)f(a->x, a->wp, a->out, a->ws, a->M, a->N, a->K, a->inv_scale, a->splits, a->chunk,
                a->device, a->stream);
}

// x: int8 (M, pitch) with the data in columns [0, K), pitch % 16 == 0,
// 16-byte aligned (what TMA reads); R = rows of the packed weight.
extern "C" int qt_dorefa_gemm_ws(const void* x, const void* wp, void* out, int M, int N, int K,
                                 int pitch, int R, int bits, float inv_scale, int m_tiles,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R % GROUP_ROWS != 0 || (bits != 1 && bits != 2 && bits != 4) || K > R * (32 / bits) ||
      pitch < K || pitch % 16 || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (K == 0) return (int)cudaMemsetAsync(o, 0, (size_t)M * N * sizeof(float), s);
  const auto* w = static_cast<const uint32_t*>(wp);
  switch (bits) {
    case 1: return (int)launch_gemm_ws<1>(x, pitch, w, o, M, N, K, inv_scale, m_tiles, device, s);
    case 2: return (int)launch_gemm_ws<2>(x, pitch, w, o, M, N, K, inv_scale, m_tiles, device, s);
    default: return (int)launch_gemm_ws<4>(x, pitch, w, o, M, N, K, inv_scale, m_tiles, device, s);
  }
}

extern "C" int qt_decode_dorefa(const void* wp, void* out, int R, int N, int bits, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R % GROUP_ROWS != 0 || (bits != 1 && bits != 2 && bits != 4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 1: return (int)qt::planes::launch_decode<1>(decode_dorefa_kernel<1>, wp, out, R, N, s);
    case 2: return (int)qt::planes::launch_decode<2>(decode_dorefa_kernel<2>, wp, out, R, N, s);
    default: return (int)qt::planes::launch_decode<4>(decode_dorefa_kernel<4>, wp, out, R, N, s);
  }
}
