// int8_gemm: (M, K) int8 x (K, N) int8 -> (M, N) f32 through an int32
// accumulator, with the optional alpha[n] / row_scale[m] epilogue
// f32(acc) * alpha[n] * row_scale[m], in that order.
//
// Replaces the Pallas kernel pytorch_quantize_impls_tpu/kernels/int8_matmul.py
// int8_gemm (pallas_call at :99), the serving path for prepared (decoded ±1
// or centered DoReFa) weights: the decode LMs' projections at M <= 32, LeNet's
// fc1 and head, the headline's "binary decoded" row at 4096^3.
//
// The schedule is stream_tile.cuh's, on the int8 tensor cores (mma.sync
// m16n8k32, exact int32 sums): a block owns a BM x 64 output tile (BM 32, 64
// or 128) and one chunk of K; cp.async keeps three 64-deep stages of x and
// of the raw int8 weights in flight (16-byte copies along K for x and along
// N for w, zero-filled past M, N and K; 4-byte copies or byte loads where a
// row is not aligned), and each weight stage (64 k-rows x 64 columns) is
// transposed ONCE in shared memory into the K-major layout the fragments
// read (transpose_stage: 4 x 4 byte transposes with __byte_perm; ldmatrix
// .trans moves 16-bit elements and cannot do it for int8). At serving batch
// sizes the weight bytes bound it (M = 32, K = 4096, N = 1024: 4.2 MB, 1.3
// us at 3.35 TB/s), so where the tile grid cannot fill the 132 SMs the
// launch splits K (kernels/common.py stream_plan): each split writes its
// int32 partial tile to a workspace and int8_gemm_kernel_sum adds the
// partials in index order and applies the epilogue once, to the summed
// int32, so two launches give the same bits. At 4096^3 the int8
// tensor-core rate bounds it (0.069 ms).
#include "mma_tile.cuh"
#include "stream_tile.cuh"

namespace {

using qt::mma::STAGE_BYTES;
using qt::mma::THREADS;
using qt::stream::BN;

// The epilogue on an exact sum: f32(acc), then * alpha[n], then *
// row_scale[m], each optional (two products never contract into an FMA).
__device__ __forceinline__ float epilogue(int32_t acc, const float* __restrict__ alpha,
                                          const float* __restrict__ row_scale, int m, int n) {
  float v = (float)acc;
  if (alpha != nullptr) v = v * alpha[n];
  if (row_scale != nullptr) v = v * row_scale[m];
  return v;
}

// part: the split's workspace of int32 partials (splits, M, N), null when
// K is not split. xmode, wmode: qt::stream::copy_mode of x and w.
template <int BM>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ alpha, const float* __restrict__ row_scale,
                 float* __restrict__ out, int32_t* __restrict__ part, int M, int N, int K,
                 int k_stages, int chunk, int xmode, int wmode) {
  const auto* xb = reinterpret_cast<const uint8_t*>(x);
  const auto* wb = reinterpret_cast<const uint8_t*>(w);
  auto load_a = [&](uint32_t* S, int m0, int k0) {
    qt::stream::load_rows<BM>(S, xb, m0, M, k0, K, xmode);
  };
  // a weight group is one stage: k-rows [64 s, 64 s + 64) of w, those < K
  auto load_w = [&](uint32_t* W, int s, int n0) {
    qt::stream::load_stage_bytes<BN>(W, wb, N, n0, wmode, s * STAGE_BYTES, 1,
                                     K - s * STAGE_BYTES);
  };
  auto prep = [](const uint32_t*, const uint32_t* W, int, uint32_t* Bs, uint32_t*) {
    qt::stream::transpose_stage<BN>(Bs, W);
  };
  auto store = [&](int m, int n, int32_t acc) {
    if (m >= M || n >= N) return;
    if (part)
      part[((size_t)blockIdx.z * M + m) * N + n] = acc;
    else
      out[(size_t)m * N + n] = epilogue(acc, alpha, row_scale, m, n);
  };
  qt::stream::stream_gemm<qt::mma::S8, qt::stream::BytesTile<BM, BN>>(1, k_stages, chunk, load_a,
                                                                      load_w, prep, store);
}

// The split's second pass: the int32 partials summed in index order, then
// the epilogue once. A split grid has at most 66 tiles of 64 x 64 (stream_plan),
// so M * N < 2^32 and the output's row and column take 32-bit division.
__global__ void int8_gemm_kernel_sum(const int32_t* __restrict__ part,
                                     const float* __restrict__ alpha,
                                     const float* __restrict__ row_scale, float* __restrict__ out,
                                     int M, int N, int splits) {
  qt::stream::sum_splits(part, (size_t)M * N, splits, [&](size_t i, int32_t s) {
    const unsigned j = (unsigned)i;
    out[i] = epilogue(s, alpha, row_scale, (int)(j / (unsigned)N), (int)(j % (unsigned)N));
  });
}

template <int BM>
cudaError_t launch_gemm(const int8_t* x, const int8_t* w, const float* alpha,
                        const float* row_scale, float* out, int32_t* part, int M, int N, int K,
                        int splits, int chunk, int device, cudaStream_t stream) {
  constexpr size_t smem = qt::stream::BytesTile<BM, BN>::SMEM;
  static bool smem_set[16] = {};
  const cudaError_t err = qt::stream::allow_smem(int8_gemm_kernel<BM>, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_gemm_kernel<BM><<<grid, THREADS, smem, stream>>>(
      x, w, alpha, row_scale, out, splits > 1 ? part : nullptr, M, N, K,
      (K + STAGE_BYTES - 1) / STAGE_BYTES, chunk / STAGE_BYTES, qt::stream::copy_mode(x, K),
      qt::stream::copy_mode(w, N));
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || splits == 1) return launched;
  int8_gemm_kernel_sum<<<qt::stream::sum_blocks((size_t)M * N), 256, 0, stream>>>(
      part, alpha, row_scale, out, M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// qt_int8_gemm's arguments in one struct, packed by the wrapper
// (kernels/int8_matmul.py): ctypes converts each argument of a call on its
// own, and a dozen of them cost the host more than the launch. alpha and
// row_scale may be null. The launch plan (bm, splits, chunk: k per split)
// is kernels/common.py stream_plan's; when splits > 1, ws holds splits * M *
// N int32.
struct Int8GemmArgs {
  const void* x;
  const void* w;
  const void* alpha;
  const void* row_scale;
  void* out;
  void* ws;
  cudaStream_t stream;
  int M, N, K, bm, splits, chunk, device;
};

extern "C" int qt_int8_gemm(const Int8GemmArgs* a) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  const int k_stages = (a->K + STAGE_BYTES - 1) / STAGE_BYTES;
  if (a->M < 0 || a->N < 0 || a->K < 0 ||
      !qt::stream::valid_plan(a->bm, a->splits, a->chunk, STAGE_BYTES, k_stages, a->ws))
    return (int)cudaErrorInvalidValue;
  if (a->M == 0 || a->N == 0) return (int)cudaSuccess;
  using Launch = decltype(&launch_gemm<64>);
  const Launch f = a->bm == 32 ? launch_gemm<32> : a->bm == 64 ? launch_gemm<64> : launch_gemm<128>;
  return (int)f(static_cast<const int8_t*>(a->x), static_cast<const int8_t*>(a->w),
                static_cast<const float*>(a->alpha), static_cast<const float*>(a->row_scale),
                static_cast<float*>(a->out), static_cast<int32_t*>(a->ws), a->M, a->N, a->K,
                a->splits, a->chunk, a->device, a->stream);
}
