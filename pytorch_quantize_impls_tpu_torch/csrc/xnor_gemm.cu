// 1-bit weight kernels over the grouped-planar layout of ops/pack.py:
// bit i of word[g * 32 + r, n] holds weight row k = g * 1024 + i * 32 + r,
// bit 1 -> +1 and bit 0 -> -1 (the DoReFa layout at one bit: the code c
// stands for 2c - 1).
//
// binary_gemm replaces the Pallas kernel
// pytorch_quantize_impls_tpu/kernels/xnor_gemm.py binary_gemm (pallas_call at
// :132): (M, K) int8 activations (±1, or 0 in padding) x packed (Kp/32, N)
// weights -> (M, N) f32 through an exact int32 sum, then f32(acc) * alpha[n]
// * row_scale[m], in that order, each factor optional. The schedule is
// stream_tile.cuh's, dorefa_gemm's at one bit: a block owns a BM x 64 output
// tile and one chunk of K; cp.async keeps the 64-deep stages of x and the
// 32-word groups they need in flight (a group spans 16 stages); each stage's
// two bit planes are decoded ONCE into ±1 int8 (decode_packed_stage) for the
// int8 tensor cores (mma.sync m16n8k32). Weights cross device memory at 1
// bit each: at serving batch sizes those bytes and the launch bound it, so
// where the tile grid cannot fill the 132 SMs the launch splits K
// (kernels/common.py stream_plan): each split writes its int32 partial tile
// to a workspace and binary_gemm_kernel_sum adds them in index order and
// applies the epilogue once. At 4096^3 the int8 tensor-core rate bounds it
// (1.37e11 operations, 0.069 ms at 1979 TOP/s). Rows of the packed group
// past K decode to -1; activation columns k >= K read as 0 (cp.async
// zero-fill, or plain loads where K's rows are not 4-byte aligned), which
// cancels them. The activation may hold 0, so the XNOR-popcount identity is
// not used.
//
// binary_gemm_ws replaces the Pallas kernel xnor_gemm.py binary_gemm_ws
// (pallas_call at :249): binary_gemm's contract and epilogue, with each
// packed weight tile decoded once for R M-tiles of 64 rows (m_tiles, R in
// {1, 2, 4}; JAX's tiles=). On the TPU a sequential grid carries an (Mp, tn)
// int32 strip in VMEM; here a block takes R M-tiles and 128 columns on the
// weight-stationary s8 tile body of packed_ws.cuh (shared with
// dorefa_gemm_ws at one bit): TMA loads x's 128-byte stages, a decoder
// warpgroup writes the ±1 weight stage K-major in the 128-byte swizzle, R
// consumer warpgroups run wgmma m64n128k32 s8 on it, their int32 sums in
// registers for the whole of K. No split and no atomics: K10 equals K1 bit
// for bit. At 4096^3 the int8 tensor-core rate bounds it (0.069 ms; its
// 86 MB take 0.026 ms).
//
// decode_binary_weights replaces xnor_gemm.py decode_binary_weights
// (pallas_call at :308): packed (Kp/32, N) -> ±1 int8 (Kp, N), reading 1
// bit and writing 8 per weight: plane_decode.cuh's one-pass decode at one
// bit (each word read once, chunks of 4 words a thread, a 4-byte store
// to each of its 32 bit planes' rows). prepare() and the
// packed conv's two-launch route (kernels/common.py conv_route) run it; the
// fused route decodes inside K5's weight stage (int8_conv.cu).
#include "mma_tile.cuh"
#include "packed_ws.cuh"
#include "plane_decode.cuh"
#include "stream_tile.cuh"

// qt_binary_gemm's arguments in one struct, packed by the wrapper
// (kernels/xnor_gemm.py): ctypes converts each argument of a call on its
// own, and a dozen of them cost the host more than the launch. R = rows of
// the packed weight = Kp / 32; K <= Kp is the width of x. The launch plan
// (bm, splits, chunk: k per split) is kernels/common.py stream_plan's; when
// splits > 1, ws holds splits * M * N int32.
struct BinaryGemmArgs {
  const void* x;
  const void* wp;
  const void* alpha;
  const void* row_scale;
  void* out;
  void* ws;
  cudaStream_t stream;
  int M, N, K, R, bm, splits, chunk, device;
};

namespace {

using qt::ws::GROUP_ROWS;  // words per self-contained group

// K1's epilogue: f32(acc) * alpha[n] * row_scale[m], each factor optional.
__device__ __forceinline__ float scaled(int32_t acc, const float* __restrict__ alpha,
                                        const float* __restrict__ row_scale, int m, int n) {
  float v = (float)acc;
  if (alpha != nullptr) v = v * alpha[n];
  if (row_scale != nullptr) v = v * row_scale[m];
  return v;
}

// K1 on stream_tile.cuh's schedule (packed_code_gemm at one bit). part: the
// split's workspace of int32 partials (splits, M, N), null when K is not
// split.
template <int BM>
__global__ void __launch_bounds__(qt::mma::THREADS)
binary_gemm_kernel(const int8_t* __restrict__ x, const uint32_t* __restrict__ wp,
                   const float* __restrict__ alpha, const float* __restrict__ row_scale,
                   float* __restrict__ out, int32_t* __restrict__ part, int M, int N, int K,
                   int k_stages, int chunk, int xmode, bool wvec) {
  qt::stream::packed_code_gemm<1, BM>(
      x, wp, M, N, K, k_stages, chunk, xmode, wvec, [&](int m, int n, int32_t acc) {
        if (m >= M || n >= N) return;
        if (part)
          part[((size_t)blockIdx.z * M + m) * N + n] = acc;
        else
          out[(size_t)m * N + n] = scaled(acc, alpha, row_scale, m, n);
      });
}

// The split's second pass: the int32 partials summed in index order (exact),
// then the epilogue once.
__global__ void binary_gemm_kernel_sum(const int32_t* __restrict__ part,
                                       const float* __restrict__ alpha,
                                       const float* __restrict__ row_scale,
                                       float* __restrict__ out, size_t mn, int N, int splits) {
  qt::stream::sum_splits(part, mn, splits, [&](size_t i, int32_t s) {
    out[i] = scaled(s, alpha, row_scale, (int)(i / N), (int)(i % N));
  });
}

template <int BM>
cudaError_t launch_gemm(const BinaryGemmArgs& a) {
  constexpr size_t smem = qt::stream::PackedTile<BM, BM * qt::mma::LDW, false>::SMEM;
  constexpr int STAGE_K = qt::mma::STAGE_BYTES;
  static bool smem_set[16] = {};
  const cudaError_t err = qt::stream::allow_smem(binary_gemm_kernel<BM>, smem, a.device, smem_set);
  if (err != cudaSuccess) return err;
  const int xmode = qt::stream::copy_mode(a.x, a.K);
  const bool wvec = a.N % 4 == 0 && reinterpret_cast<uintptr_t>(a.wp) % 16 == 0;
  const dim3 grid((a.N + qt::stream::BN - 1) / qt::stream::BN, (a.M + BM - 1) / BM, a.splits);
  const auto* alpha = static_cast<const float*>(a.alpha);
  const auto* row = static_cast<const float*>(a.row_scale);
  auto* out = static_cast<float*>(a.out);
  auto* part = static_cast<int32_t*>(a.ws);
  binary_gemm_kernel<BM><<<grid, qt::mma::THREADS, smem, a.stream>>>(
      static_cast<const int8_t*>(a.x), static_cast<const uint32_t*>(a.wp), alpha, row, out,
      a.splits > 1 ? part : nullptr, a.M, a.N, a.K, (a.K + STAGE_K - 1) / STAGE_K,
      a.chunk / STAGE_K, xmode, wvec);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || a.splits == 1) return launched;
  const size_t mn = (size_t)a.M * a.N;
  binary_gemm_kernel_sum<<<qt::stream::sum_blocks(mn), 256, 0, a.stream>>>(part, alpha, row, out,
                                                                            mn, a.N, a.splits);
  return cudaGetLastError();
}

// K10's epilogue, K1's.
struct BinaryEpilogue {
  const float* alpha;
  const float* row_scale;
  __device__ __forceinline__ float operator()(int32_t acc, int m, int n) const {
    return scaled(acc, alpha, row_scale, m, n);
  }
};

// K10: packed_ws.cuh's tile body at one bit; x: uint8 tensor map (M x K,
// row pitch a multiple of 16 bytes).
template <int R>
__global__ void __launch_bounds__(qt::ws::PackedWsTile<1, R>::THREADS,
                                  qt::ws::PackedWsTile<1, R>::BLOCKS)
binary_gemm_ws_kernel(const __grid_constant__ CUtensorMap xmap, const uint32_t* __restrict__ wp,
                      BinaryEpilogue epi, float* __restrict__ out, int M, int N, int K) {
  qt::ws::packed_ws_gemm<1, R>(xmap, wp, epi, out, M, N, K);
}

__global__ void __launch_bounds__(qt::planes::THREADS)
decode_binary_kernel(const uint32_t* __restrict__ wp, int8_t* __restrict__ out, int R, int N,
                     int mode) {
  qt::planes::decode_planes<1>(wp, out, R, N, mode);
}

}  // namespace

extern "C" int qt_binary_gemm(const BinaryGemmArgs* a) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  const int k_stages = (a->K + qt::mma::STAGE_BYTES - 1) / qt::mma::STAGE_BYTES;
  if (a->K > a->R * 32 || a->R % GROUP_ROWS != 0 ||
      !qt::stream::valid_plan(a->bm, a->splits, a->chunk, qt::mma::STAGE_BYTES, k_stages, a->ws))
    return (int)cudaErrorInvalidValue;
  if (a->M == 0 || a->N == 0) return (int)cudaSuccess;
  const auto f = a->bm == 32 ? launch_gemm<32> : a->bm == 64 ? launch_gemm<64> : launch_gemm<128>;
  return (int)f(*a);
}

// x: int8 (M, pitch) with the data in columns [0, K), pitch % 16 == 0,
// 16-byte aligned (what TMA reads); R = rows of the packed weight.
extern "C" int qt_binary_gemm_ws(const void* x, const void* wp, const void* alpha,
                                 const void* row_scale, void* out, int M, int N, int K, int pitch,
                                 int R, int m_tiles, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K > R * 32 || R % GROUP_ROWS != 0 || pitch < K || pitch % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (K == 0) return (int)cudaMemsetAsync(o, 0, (size_t)M * N * sizeof(float), s);
  const auto* w = static_cast<const uint32_t*>(wp);
  const BinaryEpilogue epi{static_cast<const float*>(alpha), static_cast<const float*>(row_scale)};
  switch (m_tiles) {
    case 1: return (int)qt::ws::launch<1, 1>(binary_gemm_ws_kernel<1>, x, pitch, w, epi, o, M, N, K, device, s);
    case 2: return (int)qt::ws::launch<1, 2>(binary_gemm_ws_kernel<2>, x, pitch, w, epi, o, M, N, K, device, s);
    case 4: return (int)qt::ws::launch<1, 4>(binary_gemm_ws_kernel<4>, x, pitch, w, epi, o, M, N, K, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int qt_decode_binary(const void* wp, void* out, int R, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R % GROUP_ROWS != 0) return (int)cudaErrorInvalidValue;
  return (int)qt::planes::launch_decode<1>(decode_binary_kernel, wp, out, R, N,
                                           static_cast<cudaStream_t>(stream));
}
