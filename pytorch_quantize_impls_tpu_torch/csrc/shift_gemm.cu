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
// kernel decodes a weight tile to bf16 and feeds the MXU; here the schedule
// is stream_tile.cuh's: a block owns a BM x 64 output tile (BM 32 or 64) and
// one chunk of K, cp.async keeps two 32-deep stages of x (as float32) and
// the 32-word code groups they need in flight, and each stage's byte plane
// is decoded ONCE into bf16 ±2^e (log_bf16_bits) while x's stage is rounded
// to bf16 in shared memory, for the bf16 tensor cores (mma.sync m16n8k16,
// f32 accumulate). At serving batch sizes the code bytes (1 per weight)
// bound it (at M = 32, K = 1024, N = 4096: 4.2 MB, 1.3 us at 3.35 TB/s), so
// where ceil(M / BM) ceil(N / 64) blocks cannot fill the 132 SMs the launch
// splits K (kernels/common.py stream_plan): each split's f32 partial tile
// goes to a workspace and shift_gemm_kernel_sum adds the partials in index
// order, with no atomics, so two launches give the same bits. At 4096^3 the
// bf16 tensor-core rate bounds it (0.139 ms). Products of a bf16 value and
// a power of two are exact; only the order and rounding of the f32 sums
// differ from the plain version. Columns k >= K of x read as 0 (cp.async
// zero-fill), so the -2^lo rows of the last group cancel.
//
// shift_gemm_ws replaces the Pallas kernel shift_matmul.py shift_gemm_ws
// (pallas_call at :205): shift_gemm's contract, with each packed code tile
// decoded to bf16 once for many M tiles, on the Hopper tile of
// wgmma_tile.cuh. As in JAX, the wrapper rounds x to bf16 (one cast, into a
// row pitch of a multiple of 8 for TMA); a block takes R M-tiles of 64 rows
// (m_tiles, R in {1, 2, 4}) and 128 columns and walks K in stages of 64.
// Its last warpgroup is the decoder, one thread per weight column: per
// stage it waits for an empty ring slot, has one thread issue the TMA load
// of the R M-tiles' x (K-major, 128-byte swizzle; rows past M and columns
// past K read as zero, so the -2^lo rows of the last group cancel), decodes
// the stage's two byte planes of its column into bf16 +-2^e (log_bf16_pair,
// two codes per 32-bit operation), written straight into the slot's K-major
// swizzled B tile, and arrives on the slot's full barrier. A thread holds
// the 32 packed words of its column for a 128-row group (two stages) in
// registers and loads the next group's while it decodes. Warpgroups 0 ..
// R-1 are consumers, one per M-tile: wgmma m64n128k16 on every stage, 64
// f32 accumulators per thread for all of K, then a masked store. Every
// block sums its K in one fixed order, with no atomics and no split over
// K, so two launches give the same bits. Products are exact; only the
// order and rounding of the tensor core's f32 sum differ from the plain
// version. Decodes per packed code tile: ceil(M / (64 R)). At 4096^3 it is
// bound by the bf16 tensor-core rate (0.139 ms at 989 TFLOP/s; its 155 MB
// take 0.046 ms); the one decoder warp per SM sub-partition is what holds
// it back (PERF.md): a stage's decode takes about as long as R = 4
// M-tiles' products, so R = 4 is the default.
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
#include <type_traits>

#include "cuda_error.cuh"
#include "mma_tile.cuh"
#include "stream_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int GROUP_ROWS = 32;  // words per self-contained group
constexpr int GROUP_K = 128;    // k-rows per group: 4 codes per word
constexpr int STAGE_K = qt::mma::STAGE_BYTES / 2;  // bf16 k per stage: one byte plane

// bf16 bit pattern (low 16 bits) of the code in the low byte of `c`
__device__ __forceinline__ uint32_t log_bf16_bits(uint32_t c, int bits, int lo) {
  const uint32_t neg = 1u - ((c >> (bits + 1)) & 1u);
  const uint32_t idx = c & ((1u << (bits + 1)) - 1u);
  return ((neg << 15) | ((uint32_t)((int)idx + lo + 127) << 7)) & 0xFFFFu;
}

// word q of column c of the stage: byte plane `plane` of word rows 2q and
// 2q + 1, i.e. weight rows k0 + 2q (low half) and k0 + 2q + 1 (high half),
// as bf16
__device__ __forceinline__ void decode_log_stage(uint32_t* Bs, const uint32_t* Ws, int plane,
                                                 int bits, int lo) {
  for (int e = threadIdx.x; e < 16 * 64; e += qt::mma::THREADS) {
    const int c = e % 64, q = e / 64;
    const uint32_t lo16 = log_bf16_bits((Ws[2 * q * 64 + c] >> (8 * plane)) & 0xFFu, bits, lo);
    const uint32_t hi16 = log_bf16_bits((Ws[(2 * q + 1) * 64 + c] >> (8 * plane)) & 0xFFu, bits, lo);
    Bs[c * qt::mma::LDW + q] = lo16 | (hi16 << 16);
  }
}

// K8 on stream_tile.cuh's schedule. A ring slot holds the stage's BM rows
// of x as float32 (STAGE_K floats each); prep rounds them to bf16 into As.
// part: the split's workspace of float32 partials (splits, M, N), null
// when K is not split.
template <int BM>
__global__ void __launch_bounds__(qt::mma::THREADS)
shift_gemm_kernel(const float* __restrict__ x, const uint32_t* __restrict__ wp,
                  float* __restrict__ out, float* __restrict__ part, int M, int N, int K, int bits,
                  int lo, int k_stages, int chunk, bool xvec, bool wvec) {
  using namespace qt::mma;
  using qt::stream::cp_async16;
  using qt::stream::cp_async4;
  // xvec: K % 4 == 0 and x 16-byte aligned, so 4 floats are one copy
  auto load_a = [&](uint32_t* S, int m0, int k0) {
    float* f = reinterpret_cast<float*>(S);
    if (xvec) {
      for (int e = threadIdx.x; e < BM * STAGE_K / 4; e += THREADS) {
        const int r = e / (STAGE_K / 4), c = 4 * (e % (STAGE_K / 4));
        const bool in = m0 + r < M && k0 + c < K;
        cp_async16(f + r * STAGE_K + c, in ? x + (size_t)(m0 + r) * K + k0 + c : x, in ? 16 : 0);
      }
    } else {
      for (int e = threadIdx.x; e < BM * STAGE_K; e += THREADS) {
        const int r = e / STAGE_K, c = e % STAGE_K;
        const bool in = m0 + r < M && k0 + c < K;
        cp_async4(f + r * STAGE_K + c, in ? x + (size_t)(m0 + r) * K + k0 + c : x, in ? 4 : 0);
      }
    }
  };
  auto prep = [&](const uint32_t* S, const uint32_t* W, int plane, uint32_t* Bs, uint32_t* As) {
    decode_log_stage(Bs, W, plane, bits, lo);
    const float* f = reinterpret_cast<const float*>(S);
    for (int e = threadIdx.x; e < BM * STAGE_K / 4; e += THREADS) {
      const int r = e / (STAGE_K / 4), c = e % (STAGE_K / 4);
      const float4 v = *reinterpret_cast<const float4*>(f + r * STAGE_K + 4 * c);
      *reinterpret_cast<uint2*>(As + r * LDW + 2 * c) =
          make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
    }
  };
  float* dst = part ? part + (size_t)blockIdx.z * M * N : out;
  auto store = [&](int m, int n, float acc) {
    if (m < M && n < N) dst[(size_t)m * N + n] = acc;
  };
  auto load_w = [&](uint32_t* W, int g, int n0) { qt::stream::load_words(W, wp, g, n0, N, wvec); };
  qt::stream::stream_gemm<BF16, qt::stream::PackedTile<BM, BM * STAGE_K, true>>(
      GROUP_K / STAGE_K, k_stages, chunk, load_a, load_w, prep, store);
}

__global__ void shift_gemm_kernel_sum(const float* __restrict__ part, float* __restrict__ out,
                                      size_t mn, int splits) {
  qt::stream::sum_splits(part, mn, splits, [&](size_t i, float s) { out[i] = s; });
}

template <int BM>
cudaError_t launch_gemm(const float* x, const uint32_t* wp, float* out, float* part, int M, int N,
                        int K, int bits, int lo, int splits, int chunk, int device,
                        cudaStream_t s) {
  constexpr size_t smem = qt::stream::PackedTile<BM, BM * STAGE_K, true>::SMEM;
  static bool smem_set[16] = {};
  const cudaError_t err = qt::stream::allow_smem(shift_gemm_kernel<BM>, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  const bool xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool wvec = N % 4 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;
  const dim3 grid((N + qt::stream::BN - 1) / qt::stream::BN, (M + BM - 1) / BM, splits);
  shift_gemm_kernel<BM><<<grid, qt::mma::THREADS, smem, s>>>(
      x, wp, out, splits > 1 ? part : nullptr, M, N, K, bits, lo, (K + STAGE_K - 1) / STAGE_K,
      chunk / STAGE_K, xvec, wvec);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || splits == 1) return launched;
  const size_t mn = (size_t)M * N;
  shift_gemm_kernel_sum<<<qt::stream::sum_blocks(mn), 256, 0, s>>>(part, out, mn, splits);
  return cudaGetLastError();
}

// Two codes, in bytes 0 and 2 of v (bytes 1 and 3 are ignored), -> their
// bf16 bit patterns in the two 16-bit lanes: log_bf16_bits on both at once,
// in 6 integer operations per pair with the byte selection. sign_shift =
// 14 - bits moves each code's sign bit (bit bits + 1) to bit 15 of its lane;
// bias7 = ((lo + 127) mod 512) << 7 in both lanes. A carry out of the low
// lane lands in bit 16, which the mask clears, so each lane keeps bits 7..15
// of (idx + lo + 127) << 7, as log_bf16_bits's & 0xFFFF does.
__device__ __forceinline__ uint32_t log_bf16_pair(uint32_t v, int sign_shift, uint32_t idx_mask,
                                                  uint32_t bias7) {
  const uint32_t e = (v & idx_mask) * 128u + bias7;
  return ((~(v << sign_shift) & 0x80008000u) | e) & 0xFF80FF80u;
}

// K12's tile; kernels/common.py shift_ws_plan is its mirror.
template <int R>
struct ShiftWsTile {
  static constexpr int BN = 128;                   // output columns per block
  static constexpr int STAGES = 4;
  static constexpr int BLOCKS = R == 1 ? 2 : 1;    // blocks per SM
  static constexpr int A_BYTES = 64 * R * qt::wg::ROW_BYTES;
  static constexpr int B_BYTES = BN * qt::wg::ROW_BYTES;
  static constexpr int SMEM = qt::wg::smem_bytes(64 * R, BN, STAGES, 0);
  static constexpr int THREADS = (R + 1) * qt::wg::WG_THREADS;
  static_assert(qt::wg::STAGE_K * 2 == GROUP_K, "a group's words serve two stages");
  static_assert(64 * R <= 256 && SMEM <= qt::wg::SMEM_LIMIT, "a TMA box has at most 256 rows");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "BLOCKS blocks share an SM's 228 KB");
};

// x: bf16 tensor map (M x K, row pitch a multiple of 8).
template <int R>
__global__ void __launch_bounds__(ShiftWsTile<R>::THREADS, ShiftWsTile<R>::BLOCKS)
shift_gemm_ws_kernel(const __grid_constant__ CUtensorMap xmap, const uint32_t* __restrict__ wp,
                     float* __restrict__ out, int M, int N, int K, int bits, int lo) {
  using T = ShiftWsTile<R>;
  using namespace qt::wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align_atom(smem_raw);
  uint8_t* Bs = As + T::STAGES * T::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + T::STAGES * T::B_BYTES);
  uint64_t* empty = full + T::STAGES;
  const int role = threadIdx.x / WG_THREADS;
  const int m0 = blockIdx.y * 64 * R, n0 = blockIdx.x * T::BN;
  const int stages = (K + qt::wg::STAGE_K - 1) / qt::wg::STAGE_K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      bar_init(&full[s], WG_THREADS + 1);  // the decoders, and the TMA's bytes
      bar_init(&empty[s], 4 * R);
    }
    bar_init_fence();
  }
  __syncthreads();
  if (role == R) {  // the decoder warpgroup; thread t decodes weight column n0 + t
    const int t = threadIdx.x % WG_THREADS;
    const int sign_shift = 14 - bits;
    const uint32_t idx_mask = ((1u << (bits + 1)) - 1u) * 0x00010001u;
    const uint32_t bias7 = (((uint32_t)(lo + 127) & 0x1FFu) << 7) * 0x00010001u;
    // the 32 words of column n0 + t in group g, loaded a group ahead and
    // unconditionally, so that nothing waits on them until they are
    // decoded: past N they repeat column N - 1 (whose outputs are not
    // stored), past the last group they repeat it (and are not decoded)
    const int last_group = (stages - 1) / 2;
    auto load_group = [&](uint32_t (&w)[GROUP_ROWS], int g) {
      const uint32_t* src = wp + (size_t)min(g, last_group) * GROUP_ROWS * N + min(n0 + t, N - 1);
#pragma unroll
      for (int r = 0; r < GROUP_ROWS; ++r) w[r] = __ldg(src + (size_t)r * N);
    };
    // stage s, half HALF of its group: wait for its slot, load its x, and
    // decode: k = 64 s + 32 p + r is byte plane 2 HALF + p of word row r;
    // the 8 consecutive k of rows 8 j .. 8 j + 8 are swizzled chunk 4 p + j
    // of the weight tile's row t
    auto stage = [&](auto half, const uint32_t (&w)[GROUP_ROWS], int s) {
      constexpr int HALF = decltype(half)::value;
      const int slot = s % T::STAGES;
      if (s >= T::STAGES) bar_wait(&empty[slot], (s / T::STAGES - 1) & 1);
      if (t == 0) {
        bar_arrive_tx(&full[slot], T::A_BYTES);
        tma_load_2d(As + slot * T::A_BYTES, &xmap, &full[slot], qt::wg::STAGE_K * s, m0);
      }
      uint8_t* B = Bs + slot * T::B_BYTES;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          constexpr uint32_t plane0 = 2 * HALF;
          const uint32_t sel = (plane0 + p) | ((plane0 + p + 4) << 8);
          uint32_t q[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            q[i] = log_bf16_pair(__byte_perm(w[8 * j + 2 * i], w[8 * j + 2 * i + 1], sel),
                                 sign_shift, idx_mask, bias7);
          *reinterpret_cast<uint4*>(B + swizzle128(t, 4 * p + j)) = make_uint4(q[0], q[1], q[2], q[3]);
        }
      fence_async_shared();
      bar_arrive(&full[slot]);
    };
    // group g from the words w, while group g + 1's load into w_next
    auto group = [&](const uint32_t (&w)[GROUP_ROWS], uint32_t (&w_next)[GROUP_ROWS], int g) {
      load_group(w_next, g + 1);
      stage(std::integral_constant<int, 0>(), w, 2 * g);
      if (2 * g + 1 < stages) stage(std::integral_constant<int, 1>(), w, 2 * g + 1);
    };
    uint32_t w0[GROUP_ROWS], w1[GROUP_ROWS];
    load_group(w0, 0);
    for (int g = 0; 2 * g < stages; g += 2) {
      group(w0, w1, g);
      if (2 * (g + 1) < stages) group(w1, w0, g + 1);
    }
  } else {  // consumer warpgroup `role`: M-tile rows m0 + 64 role .. + 64
    float acc[1][1][64];
    const uint32_t a0 = smem_u32(As) + role * 64 * ROW_BYTES, b0 = smem_u32(Bs);
    consume<T::STAGES, 1, 1, 0>(
        acc, stages, full, empty,
        [&](int slot, int, int ks) { return desc_sw128(a0 + slot * T::A_BYTES + 32 * ks, 16, ATOM_BYTES); },
        [&](int slot, int, int ks) { return desc_sw128(b0 + slot * T::B_BYTES + 32 * ks, 16, ATOM_BYTES); });
    const int mt = m0 + 64 * role;
    const bool pairs = N % 2 == 0;
    for_each_acc(acc[0][0], [&](int r, int c, float v0, float v1) {
      const int m = mt + r, n = n0 + c;
      if (m >= M || n >= N) return;
      float* o = out + (size_t)m * N + n;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (n + 1 < N) o[1] = v1;
      }
    });
  }
}

template <int R>
cudaError_t launch_ws(const void* xb, const uint32_t* wp, float* out, int M, int N, int K,
                      int pitch, int bits, int lo, int device, cudaStream_t s) {
  using T = ShiftWsTile<R>;
  CUtensorMap xmap;
  cudaError_t err = qt::wg::tile_map(&xmap, 2, xb, M, K, pitch, 64 * R, qt::wg::STAGE_K);
  static bool smem_set[16] = {};
  if (err == cudaSuccess)
    err = qt::wg::allow_smem(shift_gemm_ws_kernel<R>, T::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + 64 * R - 1) / (64 * R));
  shift_gemm_ws_kernel<R><<<grid, T::THREADS, T::SMEM, s>>>(xmap, wp, out, M, N, K, bits, lo);
  return cudaGetLastError();
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

// qt_shift_gemm's arguments in one struct, packed by the wrapper
// (kernels/shift_matmul.py): ctypes converts each argument of a call on its
// own, and fifteen of them cost the host more than the launch. R = rows of
// the packed weight = Kp / 4; K <= Kp is the width of x. The launch plan
// (bm, splits, chunk: k per split) is kernels/common.py stream_plan's; when
// splits > 1, ws holds splits * M * N floats.
struct ShiftGemmArgs {
  const float* x;
  const uint32_t* wp;
  float* out;
  float* ws;
  cudaStream_t stream;
  int M, N, K, R, bits, lo, bm, splits, chunk, device;
};

extern "C" int qt_shift_gemm(const ShiftGemmArgs* a) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return (int)err;
  const int k_stages = (a->K + STAGE_K - 1) / STAGE_K;
  if (!valid(a->R, a->bits) || a->K > a->R * 4 ||
      !qt::stream::valid_plan(a->bm, a->splits, a->chunk, STAGE_K, k_stages, a->ws))
    return (int)cudaErrorInvalidValue;
  if (a->M == 0 || a->N == 0) return (int)cudaSuccess;
  const auto f = a->bm == 32 ? launch_gemm<32> : a->bm == 64 ? launch_gemm<64> : launch_gemm<128>;
  return (int)f(a->x, a->wp, a->out, a->ws, a->M, a->N, a->K, a->bits, a->lo, a->splits, a->chunk,
                a->device, a->stream);
}

// x: bf16 (M, pitch) with the data in columns [0, K), pitch % 8 == 0,
// 16-byte aligned (what TMA reads); R = rows of the packed weight.
extern "C" int qt_shift_gemm_ws(const void* x, const void* wp, void* out, int M, int N, int K,
                                int pitch, int R, int bits, int lo, int m_tiles, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!valid(R, bits) || K > R * 4 || pitch < K || pitch % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (K == 0) return (int)cudaMemsetAsync(o, 0, (size_t)M * N * sizeof(float), s);
  const auto* w = static_cast<const uint32_t*>(wp);
  switch (m_tiles) {
    case 1: return (int)launch_ws<1>(x, w, o, M, N, K, pitch, bits, lo, device, s);
    case 2: return (int)launch_ws<2>(x, w, o, M, N, K, pitch, bits, lo, device, s);
    case 4: return (int)launch_ws<4>(x, w, o, M, N, K, pitch, bits, lo, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
