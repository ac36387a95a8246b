// The dtype probe's tiled matmul (P1): bf16 on the Hopper tile of
// wgmma_tile.cuh (TMA, wgmma, a warp-specialised ring), int8 and int4 on the
// tensor cores through mma.sync.
//
// Replaces the Pallas kernel scripts/mxu_probe.py pallas_mm (pallas_call at
// :47): a plain tiled matmul, (M, K) @ (K, N) -> (M, N) f32 through an
// accumulator in the operands' accumulate type (bf16 -> f32, int8 and int4 ->
// int32), with no padding, so the shapes must divide the tiles. The TPU grid
// walks K sequentially with a VMEM scratch accumulator; here each block keeps
// its BM x BN accumulator in registers and walks K itself. At 4096^3 the
// work is 1.37e11 operations on 32-96 MB, so it is bound by the tensor
// cores' rate (989 TFLOP/s bf16, 1979 TOP/s int8; the data sheet gives no
// dense int4 rate), not by the bytes.
//
// bf16 (tiled_mm_kernel_wgmma): one producer thread keeps a 4-stage ring of
// TMA loads in flight, x (M, K) as K-major BM x 64 boxes and w (K, N) as
// 64 x 64 boxes read MN-major through the descriptor's transpose bit, both
// in the 128-byte swizzle; one or two consumer warpgroups run wgmma
// m64n128k16 on each stage (Bf16Tile: BM / 64 / CONSUMERS M-tiles and BN /
// 128 column tiles each, 64 or 128 f32 accumulators per thread; setmaxnreg
// gives the two-consumer tiles' consumers 232 registers and the producer
// 40). PTX wgmma has no s4 type, and for int8 it takes only K-major B, so
// int8 and int4 stay on mma_tile.cuh's tiled_mm_kernel: plain synchronous
// stages of 64 bytes of k. int4 operands come packed two per byte, low
// nibble first: x (M, K/2) along K, w (K/2, N) along K (byte [kk, n] holds
// k = 2 kk and 2 kk + 1), so in bytes they run as int8 does.
#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

using qt::mma::tiled_mm_kernel;

// The bf16 tile's plan; kernels/common.py tiled_mm_bf16_plan is its mirror.
template <int BM, int BN>
struct Bf16Tile {
  static constexpr int CONSUMERS = BM >= 128 ? 2 : 1;  // warpgroups of wgmma
  static constexpr int MI = BM / 64 / CONSUMERS;        // 64-row tiles per consumer
  static constexpr int NI = BN / 128;                   // 128-column products per M-tile
  static constexpr int STAGES = 4;
  static constexpr int A_BYTES = BM * qt::wg::ROW_BYTES, B_BYTES = BN * qt::wg::ROW_BYTES;
  static constexpr int B_BOX_BYTES = 64 * qt::wg::ROW_BYTES;  // 64 k-rows x 64 columns
  static constexpr int SMEM = qt::wg::smem_bytes(BM, BN, STAGES, 0);
  static constexpr int THREADS = (CONSUMERS + 1) * qt::wg::WG_THREADS;
  static_assert(BM % 64 == 0 && BM / 64 % CONSUMERS == 0 && BN % 128 == 0);
  static_assert(BM <= 256 && SMEM <= qt::wg::SMEM_LIMIT, "a TMA box has at most 256 rows");
};

template <int BM, int BN>
__global__ void __launch_bounds__(Bf16Tile<BM, BN>::THREADS, 1)
tiled_mm_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, float* __restrict__ out, int N,
                      int K) {
  using T = Bf16Tile<BM, BN>;
  using namespace qt::wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align_atom(smem_raw);
  uint8_t* Bs = As + T::STAGES * T::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + T::STAGES * T::B_BYTES);
  uint64_t* empty = full + T::STAGES;
  const int role = threadIdx.x / WG_THREADS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, stages = (K + STAGE_K - 1) / STAGE_K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * T::CONSUMERS);
    }
    bar_init_fence();
  }
  __syncthreads();
  if (role == T::CONSUMERS) {  // producer: one thread issues every load
    if constexpr (T::CONSUMERS == 2) reg_dealloc<40>();
    if (threadIdx.x % WG_THREADS == 0) {
      for (int s = 0; s < stages; ++s) {
        const int slot = s % T::STAGES;
        if (s >= T::STAGES) bar_wait(&empty[slot], (s / T::STAGES - 1) & 1);
        bar_arrive_tx(&full[slot], T::A_BYTES + T::B_BYTES);
        tma_load_2d(As + slot * T::A_BYTES, &xmap, &full[slot], STAGE_K * s, m0);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(Bs + slot * T::B_BYTES + b * T::B_BOX_BYTES, &wmap, &full[slot], n0 + 64 * b,
                      STAGE_K * s);
      }
    }
  } else {
    if constexpr (T::CONSUMERS == 2) reg_alloc<232>();
    float acc[T::MI][T::NI][64];
    const uint32_t a0 = smem_u32(As), b0 = smem_u32(Bs);
    consume<T::STAGES, T::MI, T::NI, 1>(
        acc, stages, full, empty,
        [&](int slot, int i, int ks) {
          return desc_sw128(a0 + slot * T::A_BYTES + (role * T::MI + i) * 64 * ROW_BYTES + 32 * ks,
                            16, ATOM_BYTES);
        },
        [&](int slot, int j, int ks) {
          return desc_sw128(b0 + slot * T::B_BYTES + j * 2 * T::B_BOX_BYTES + ks * 16 * ROW_BYTES,
                            T::B_BOX_BYTES, ATOM_BYTES);
        });
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j) {
        float* o = out + (size_t)(m0 + (role * T::MI + i) * 64) * N + n0 + j * 128;
        for_each_acc(acc[i][j], [&](int r, int c, float v0, float v1) {
          *reinterpret_cast<float2*>(o + (size_t)r * N + c) = make_float2(v0, v1);
        });
      }
  }
}

template <int BM, int BN>
cudaError_t launch_bf16_tile(const void* x, const void* w, float* out, int M, int N, int K,
                             int device, cudaStream_t s) {
  using T = Bf16Tile<BM, BN>;
  CUtensorMap xmap, wmap;
  cudaError_t err = qt::wg::tile_map(&xmap, 2, x, M, K, K, BM, 64);
  if (err == cudaSuccess) err = qt::wg::tile_map(&wmap, 2, w, K, N, N, 64, 64);
  static bool smem_set[16] = {};
  if (err == cudaSuccess)
    err = qt::wg::allow_smem(tiled_mm_kernel_wgmma<BM, BN>, T::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  tiled_mm_kernel_wgmma<BM, BN><<<dim3(N / BN, M / BM), T::THREADS, T::SMEM, s>>>(xmap, wmap, out,
                                                                                  N, K);
  return cudaGetLastError();
}

// bf16: K counts elements; x 16-byte aligned with K % 8 == 0 and w 16-byte
// aligned with N % 8 == 0 (TMA's rule for a base and a row pitch; the
// tilings' N % BN == 0 gives the latter).
cudaError_t launch_bf16(const void* x, const void* w, float* out, int M, int N, int K, int bm,
                        int bn, int device, cudaStream_t s) {
  if (M % bm || N % bn || K % 32 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch_bf16_tile<128, 128>(x, w, out, M, N, K, device, s);
  if (bm == 128 && bn == 256) return launch_bf16_tile<128, 256>(x, w, out, M, N, K, device, s);
  if (bm == 256 && bn == 128) return launch_bf16_tile<256, 128>(x, w, out, M, N, K, device, s);
  if (bm == 64 && bn == 128) return launch_bf16_tile<64, 128>(x, w, out, M, N, K, device, s);
  return cudaErrorInvalidValue;
}

// KB: bytes of k per row of x.
template <class Op>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N, int KB, int bm, int bn,
                   cudaStream_t s) {
  if (M % bm || N % bn || KB % qt::mma::STAGE_BYTES) return cudaErrorInvalidValue;
  const dim3 grid(N / bn, M / bm);
  const auto* xp = static_cast<const uint8_t*>(x);
  const auto* wq = static_cast<const uint8_t*>(w);
  auto* o = static_cast<float*>(out);
  if (bm == 128 && bn == 128) tiled_mm_kernel<Op, 128, 128><<<grid, qt::mma::THREADS, 0, s>>>(xp, wq, o, M, N, KB);
  else if (bm == 128 && bn == 256) tiled_mm_kernel<Op, 128, 256><<<grid, qt::mma::THREADS, 0, s>>>(xp, wq, o, M, N, KB);
  else if (bm == 256 && bn == 128) tiled_mm_kernel<Op, 256, 128><<<grid, qt::mma::THREADS, 0, s>>>(xp, wq, o, M, N, KB);
  else if (bm == 64 && bn == 128) tiled_mm_kernel<Op, 64, 128><<<grid, qt::mma::THREADS, 0, s>>>(xp, wq, o, M, N, KB);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype 0: bf16 (x, w bf16; the wgmma tile); 1: int8; 2: int4 (packed two
// per byte). K counts elements.
extern "C" int qt_tiled_mm(const void* x, const void* w, void* out, int M, int N, int K, int dtype,
                           int bm, int bn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bf16(x, w, static_cast<float*>(out), M, N, K, bm, bn, device, s);
    case 1: return (int)launch<qt::mma::S8>(x, w, out, M, N, K, bm, bn, s);
    case 2:
      if (K % 2) return (int)cudaErrorInvalidValue;
      return (int)launch<qt::mma::S4>(x, w, out, M, N, K / 2, bm, bn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
