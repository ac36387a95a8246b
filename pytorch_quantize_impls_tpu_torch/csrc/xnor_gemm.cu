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
// Hopper tile of wgmma_tile.cuh, s8 path: TMA loads x's 128-byte stages
// (128 int8 of k) in the 128-byte swizzle, one decoder warpgroup writes the
// ±1 weight stage K-major into the same swizzle (thread t owns column n0 +
// t and holds its group's 32 words in registers, a group ahead), and R
// consumer warpgroups run wgmma m64n128k32 s8 on it, their int32 sums in
// registers for the whole of K. No split and no atomics: K10 equals K1 bit
// for bit. Decodes per packed weight tile: ceil(M / (64 R)). At 4096^3 the
// int8 tensor-core rate bounds it (0.069 ms; its 86 MB take 0.026 ms).
//
// decode_binary_weights replaces xnor_gemm.py decode_binary_weights
// (pallas_call at :308): packed (Kp/32, N) -> ±1 int8 (Kp, N). It is an
// elementwise pass bound by device-memory bandwidth (reads 1 bit, writes
// 8 bits per weight); one thread per word writes its 32 int8 values, and
// neighbouring threads take neighbouring columns so every access coalesces.
#include <type_traits>

#include "mma_tile.cuh"
#include "stream_tile.cuh"
#include "wgmma_tile.cuh"

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

constexpr int GROUP_ROWS = 32;            // words per self-contained group
constexpr int GROUP_K = 32 * GROUP_ROWS;  // k-rows per group

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

// Four bytes b in {0, 1} -> the int8 2b - 1 in each (1 or -1): b * 0xFE
// carries nothing into the next byte, and its complement is 0x01 or 0xFF.
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t b) { return ~(b * 0xFEu); }

// K10's tile; kernels/common.py binary_ws_plan is its mirror.
template <int R>
struct BinaryWsTile {
  static constexpr int BN = 128;                   // output columns per block
  static constexpr int STAGE_K = qt::wg::ROW_BYTES;  // int8 k per stage
  static constexpr int STAGES = 4;
  static constexpr int BLOCKS = R == 1 ? 2 : 1;    // blocks per SM
  static constexpr int A_BYTES = 64 * R * qt::wg::ROW_BYTES;
  static constexpr int B_BYTES = BN * qt::wg::ROW_BYTES;
  static constexpr int SMEM = qt::wg::smem_bytes(64 * R, BN, STAGES, 0);
  static constexpr int THREADS = (R + 1) * qt::wg::WG_THREADS;
  static constexpr int SPG = GROUP_K / STAGE_K;    // stages per group: 4 bit planes each
  static_assert(SPG == 8 && BN == qt::wg::WG_THREADS, "a decoder thread per column, 8 stages a group");
  static_assert(64 * R <= 256 && SMEM <= qt::wg::SMEM_LIMIT, "a TMA box has at most 256 rows");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "BLOCKS blocks share an SM's 228 KB");
};

// x: uint8 tensor map (M x K, row pitch a multiple of 16 bytes).
template <int R>
__global__ void __launch_bounds__(BinaryWsTile<R>::THREADS, BinaryWsTile<R>::BLOCKS)
binary_gemm_ws_kernel(const __grid_constant__ CUtensorMap xmap, const uint32_t* __restrict__ wp,
                      const float* __restrict__ alpha, const float* __restrict__ row_scale,
                      float* __restrict__ out, int M, int N, int K) {
  using T = BinaryWsTile<R>;
  using namespace qt::wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align_atom(smem_raw);
  uint8_t* Bs = As + T::STAGES * T::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + T::STAGES * T::B_BYTES);
  uint64_t* empty = full + T::STAGES;
  const int role = threadIdx.x / WG_THREADS;
  const int m0 = blockIdx.y * 64 * R, n0 = blockIdx.x * T::BN;
  const int stages = (K + T::STAGE_K - 1) / T::STAGE_K;
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
    // the 32 words of column n0 + t in group g, loaded a group ahead and
    // unconditionally, so that nothing waits on them until they are
    // decoded: past N they repeat column N - 1 (whose outputs are not
    // stored), past the last group they repeat it (and are not decoded)
    const int last_group = (stages - 1) / T::SPG;
    auto load_group = [&](uint32_t (&w)[GROUP_ROWS], int g) {
      const uint32_t* src = wp + (size_t)min(g, last_group) * GROUP_ROWS * N + min(n0 + t, N - 1);
#pragma unroll
      for (int r = 0; r < GROUP_ROWS; ++r) w[r] = __ldg(src + (size_t)r * N);
    };
    // stage s, the S-th of its group: wait for its slot, load its x, and
    // decode: k = 128 s' + 32 p + r (s' = S) is bit plane 4 S + p of word r,
    // in byte S / 2 of the word; the 16 k of words 16 h .. 16 h + 15 at
    // plane p are swizzled chunk 2 p + h of the weight tile's row t, word u
    // of the chunk holding words 16 h + 4 u .. + 3
    auto stage = [&](auto s_in_group, const uint32_t (&w)[GROUP_ROWS], int s) {
      constexpr int S = decltype(s_in_group)::value;
      constexpr uint32_t sel = (S / 2) | ((S / 2 + 4) << 4);  // byte S / 2 of two words
      constexpr int shift = 4 * (S & 1);
      const int slot = s % T::STAGES;
      if (s >= T::STAGES) bar_wait(&empty[slot], (s / T::STAGES - 1) & 1);
      if (t == 0) {
        bar_arrive_tx(&full[slot], T::A_BYTES);
        tma_load_2d(As + slot * T::A_BYTES, &xmap, &full[slot], T::STAGE_K * s, m0);
      }
      uint8_t* B = Bs + slot * T::B_BYTES;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t q[4][4];  // [plane p][word u of the chunk]
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = 16 * h + 4 * u;
          // byte j: byte S / 2 of word r + j
          const uint32_t b = __byte_perm(__byte_perm(w[r], w[r + 1], sel),
                                         __byte_perm(w[r + 2], w[r + 3], sel), 0x5410);
#pragma unroll
          for (int p = 0; p < 4; ++p) q[p][u] = pm1_bytes((b >> (shift + p)) & 0x01010101u);
        }
#pragma unroll
        for (int p = 0; p < 4; ++p)
          *reinterpret_cast<uint4*>(B + swizzle128(t, 2 * p + h)) =
              make_uint4(q[p][0], q[p][1], q[p][2], q[p][3]);
      }
      fence_async_shared();
      bar_arrive(&full[slot]);
    };
    // group g from the words w, while group g + 1's load into w_next
    auto group = [&](const uint32_t (&w)[GROUP_ROWS], uint32_t (&w_next)[GROUP_ROWS], int g) {
      load_group(w_next, g + 1);
      const int s0 = T::SPG * g;
      stage(std::integral_constant<int, 0>(), w, s0);
      if (s0 + 1 < stages) stage(std::integral_constant<int, 1>(), w, s0 + 1);
      if (s0 + 2 < stages) stage(std::integral_constant<int, 2>(), w, s0 + 2);
      if (s0 + 3 < stages) stage(std::integral_constant<int, 3>(), w, s0 + 3);
      if (s0 + 4 < stages) stage(std::integral_constant<int, 4>(), w, s0 + 4);
      if (s0 + 5 < stages) stage(std::integral_constant<int, 5>(), w, s0 + 5);
      if (s0 + 6 < stages) stage(std::integral_constant<int, 6>(), w, s0 + 6);
      if (s0 + 7 < stages) stage(std::integral_constant<int, 7>(), w, s0 + 7);
    };
    uint32_t w0[GROUP_ROWS], w1[GROUP_ROWS];
    load_group(w0, 0);
    for (int g = 0; T::SPG * g < stages; g += 2) {
      group(w0, w1, g);
      if (T::SPG * (g + 1) < stages) group(w1, w0, g + 1);
    }
  } else {  // consumer warpgroup `role`: M-tile rows m0 + 64 role .. + 64
    int32_t acc[1][1][64];
    const uint32_t a0 = smem_u32(As) + role * 64 * ROW_BYTES, b0 = smem_u32(Bs);
    consume<T::STAGES, 1, 1, 0>(
        acc, stages, full, empty,
        [&](int slot, int, int ks) { return desc_sw128(a0 + slot * T::A_BYTES + 32 * ks, 16, ATOM_BYTES); },
        [&](int slot, int, int ks) { return desc_sw128(b0 + slot * T::B_BYTES + 32 * ks, 16, ATOM_BYTES); });
    const int mt = m0 + 64 * role;
    const bool pairs = N % 2 == 0;
    for_each_acc(acc[0][0], [&](int r, int c, int32_t v0, int32_t v1) {
      const int m = mt + r, n = n0 + c;
      if (m >= M || n >= N) return;
      float* o = out + (size_t)m * N + n;
      const float f0 = scaled(v0, alpha, row_scale, m, n);
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(f0, scaled(v1, alpha, row_scale, m, n + 1));
      } else {
        o[0] = f0;
        if (n + 1 < N) o[1] = scaled(v1, alpha, row_scale, m, n + 1);
      }
    });
  }
}

template <int R>
cudaError_t launch_ws(const void* x, const uint32_t* wp, const float* alpha, const float* row,
                      float* out, int M, int N, int K, int pitch, int device, cudaStream_t s) {
  using T = BinaryWsTile<R>;
  CUtensorMap xmap;
  cudaError_t err = qt::wg::tile_map(&xmap, 1, x, M, K, pitch, 64 * R, T::STAGE_K);
  static bool smem_set[16] = {};
  if (err == cudaSuccess)
    err = qt::wg::allow_smem(binary_gemm_ws_kernel<R>, T::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + 64 * R - 1) / (64 * R));
  binary_gemm_ws_kernel<R><<<grid, T::THREADS, T::SMEM, s>>>(xmap, wp, alpha, row, out, M, N, K);
  return cudaGetLastError();
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
  const auto* a = static_cast<const float*>(alpha);
  const auto* rs = static_cast<const float*>(row_scale);
  switch (m_tiles) {
    case 1: return (int)launch_ws<1>(x, w, a, rs, o, M, N, K, pitch, device, s);
    case 2: return (int)launch_ws<2>(x, w, a, rs, o, M, N, K, pitch, device, s);
    case 4: return (int)launch_ws<4>(x, w, a, rs, o, M, N, K, pitch, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
