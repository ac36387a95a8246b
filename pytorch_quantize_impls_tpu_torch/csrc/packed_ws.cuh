// The weight-stationary s8 tile body of the packed-weight GEMMs
// binary_gemm_ws (K10, xnor_gemm.cu: 1-bit weights) and dorefa_gemm_ws
// (K11, dorefa_gemm.cu: 1-, 2- or 4-bit DoReFa codes) on the Hopper tile of
// wgmma_tile.cuh. The two differ only in BITS and in the epilogue.
//
// Layout (ops/pack.py, grouped-planar): with f = 32 / BITS codes per word,
// bit field i ([BITS i, BITS i + BITS)) of word[g * 32 + r, n] holds the
// code c of weight row k = g * 32 f + 32 i + r; c stands for the centered
// integer d = 2c - (2^BITS - 1) (odd, |d| <= 15; at one bit ±1).
//
// A block takes R M-tiles of 64 rows (m_tiles, R in {1, 2, 4}) and 128
// columns. TMA loads x's 128-byte stages (128 int8 of k) in the 128-byte
// swizzle; one decoder warpgroup writes the weight stage K-major into the
// same swizzle (thread t owns column n0 + t and holds its group's 32 words
// in registers, a group ahead); one consumer warpgroup per M-tile, at most
// two (R = 4: two M-tiles each, as Bf16Tile's), run wgmma m64n128k32 s8 on
// it, their int32 sums in registers for the whole of K. Two consumers keep
// the block at 384 threads, whose 168 registers a thread hold the
// decoder's two groups of words without spilling (640 threads leave 96).
// A 128-deep stage is four bit fields of the 32 words, so a group spans
// SPG = 8 / BITS stages. No split and no atomics: two launches give the
// same bits.
// Decodes per packed weight tile: ceil(M / (64 R)). At 4096^3 the int8
// tensor-core rate bounds it (1.37e11 operations, 0.069 ms at 1979 TOP/s).
// Rows of the packed group past K decode to some d; x's columns past K read
// as zero (the tensor map is K wide), which cancels them.
#pragma once

#include <type_traits>
#include <utility>

#include "wgmma_tile.cuh"

namespace qt {
namespace ws {

constexpr int GROUP_ROWS = 32;  // words per self-contained group

// The tile of BITS-bit weights and R M-tiles; kernels/common.py
// packed_ws_plan is its mirror.
template <int BITS, int R>
struct PackedWsTile {
  static constexpr int BN = 128;                     // output columns per block
  static constexpr int STAGE_K = wg::ROW_BYTES;      // int8 k per stage
  static constexpr int STAGES = 4;
  static constexpr int BLOCKS = R == 1 ? 2 : 1;      // blocks per SM
  static constexpr int A_BYTES = 64 * R * wg::ROW_BYTES;
  static constexpr int B_BYTES = BN * wg::ROW_BYTES;
  static constexpr int SMEM = wg::smem_bytes(64 * R, BN, STAGES, 0);
  static constexpr int CONSUMERS = R < 2 ? R : 2;    // warpgroups of wgmma
  static constexpr int MI = R / CONSUMERS;            // 64-row M-tiles per consumer
  static constexpr int THREADS = (CONSUMERS + 1) * wg::WG_THREADS;
  static constexpr int SPG = 32 * GROUP_ROWS / BITS / STAGE_K;  // stages per group
  static_assert(BITS == 1 || BITS == 2 || BITS == 4, "1-, 2- or 4-bit codes");
  static_assert(SPG * BITS == 8 && BN == wg::WG_THREADS, "a decoder thread per column");
  static_assert(64 * R <= 256 && SMEM <= wg::SMEM_LIMIT, "a TMA box has at most 256 rows");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "BLOCKS blocks share an SM's 228 KB");
};

// Four BITS-bit codes c, one in the low bits of each byte, as the centered
// int8 2c - n_w in each byte (n_w = 2^BITS - 1): 2c + 128 - n_w lies in
// [113, 143], so no byte carries into the next, and flipping each byte's
// top bit takes the 128 off again.
template <int BITS>
__device__ __forceinline__ uint32_t centered_bytes(uint32_t c) {
  constexpr uint32_t NW = (1u << BITS) - 1;
  return (2 * c + (0x80u - NW) * 0x01010101u) ^ 0x80808080u;
}

// f(integral_constant<int, I>) for I = 0 .. N - 1, each I a constant.
template <class F, int... I>
__device__ __forceinline__ void static_for(F f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>()), ...);
}

// The block's part of out (M x N) = x (M x K int8, tensor map xmap) @ the
// decoded BITS-bit words wp (rows of N words); out[m, n] = epi(acc, m, n).
template <int BITS, int R, class Epi>
__device__ __forceinline__ void packed_ws_gemm(const CUtensorMap& xmap,
                                               const uint32_t* __restrict__ wp, Epi epi,
                                               float* __restrict__ out, int M, int N, int K) {
  using T = PackedWsTile<BITS, R>;
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
      bar_init(&empty[s], 4 * T::CONSUMERS);
    }
    bar_init_fence();
  }
  __syncthreads();
  if (role == T::CONSUMERS) {  // the decoder warpgroup; thread t decodes weight column n0 + t
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
    // decode: k = 128 S + 32 p + r is field 4 S + p of word r, at bit
    // `bit` = BITS (4 S + p) of the word, in its byte bit / 8; the 16 k of
    // words 16 h .. 16 h + 15 at field 4 S + p are swizzled chunk 2 p + h of
    // the weight tile's row t, word u of the chunk holding words 16 h + 4 u
    // .. + 3 (fields in one byte share its gather)
    auto stage = [&](auto s_in_group, const uint32_t (&w)[GROUP_ROWS], int s) {
      constexpr int S = decltype(s_in_group)::value;
      constexpr uint32_t MASK = ((1u << BITS) - 1) * 0x01010101u;
      const int slot = s % T::STAGES;
      if (s >= T::STAGES) bar_wait(&empty[slot], (s / T::STAGES - 1) & 1);
      if (t == 0) {
        bar_arrive_tx(&full[slot], T::A_BYTES);
        tma_load_2d(As + slot * T::A_BYTES, &xmap, &full[slot], T::STAGE_K * s, m0);
      }
      uint8_t* B = Bs + slot * T::B_BYTES;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t q[4][4];  // [field p][word u of the chunk]
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = 16 * h + 4 * u;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int bit = BITS * (4 * S + p);
            const uint32_t sel = (bit / 8) | ((bit / 8 + 4) << 4);  // that byte of two words
            // byte j: byte bit / 8 of word r + j
            const uint32_t b = __byte_perm(__byte_perm(w[r], w[r + 1], sel),
                                           __byte_perm(w[r + 2], w[r + 3], sel), 0x5410);
            q[p][u] = centered_bytes<BITS>((b >> (bit % 8)) & MASK);
          }
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
      static_for(
          [&](auto S) {
            constexpr int I = decltype(S)::value;
            if (s0 + I < stages) stage(S, w, s0 + I);
          },
          std::make_integer_sequence<int, T::SPG>());
    };
    uint32_t w0[GROUP_ROWS], w1[GROUP_ROWS];
    load_group(w0, 0);
    for (int g = 0; T::SPG * g < stages; g += 2) {
      group(w0, w1, g);
      if (T::SPG * (g + 1) < stages) group(w1, w0, g + 1);
    }
  } else {  // consumer warpgroup `role`: M-tiles role MI .. + MI
    int32_t acc[T::MI][1][64];
    const uint32_t a0 = smem_u32(As) + role * T::MI * 64 * ROW_BYTES, b0 = smem_u32(Bs);
    consume<T::STAGES, T::MI, 1, 0>(
        acc, stages, full, empty,
        [&](int slot, int i, int ks) {
          return desc_sw128(a0 + slot * T::A_BYTES + i * 64 * ROW_BYTES + 32 * ks, 16, ATOM_BYTES);
        },
        [&](int slot, int, int ks) { return desc_sw128(b0 + slot * T::B_BYTES + 32 * ks, 16, ATOM_BYTES); });
    const bool pairs = N % 2 == 0;
#pragma unroll
    for (int i = 0; i < T::MI; ++i) {
      const int mt = m0 + 64 * (role * T::MI + i);
      for_each_acc(acc[i][0], [&](int r, int c, int32_t v0, int32_t v1) {
        const int m = mt + r, n = n0 + c;
        if (m >= M || n >= N) return;
        float* o = out + (size_t)m * N + n;
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(epi(v0, m, n), epi(v1, m, n + 1));
        } else {
          o[0] = epi(v0, m, n);
          if (n + 1 < N) o[1] = epi(v1, m, n + 1);
        }
      });
    }
  }
}

// Launch `kernel`, a __global__ wrapper of packed_ws_gemm<BITS, R, Epi>,
// for out (M x N); x: int8 (M, pitch) with the data in columns [0, K),
// 16-byte aligned with pitch % 16 == 0 (what TMA reads).
template <int BITS, int R, class Epi>
cudaError_t launch(void (*kernel)(const CUtensorMap, const uint32_t*, Epi, float*, int, int, int),
                   const void* x, int pitch, const uint32_t* wp, Epi epi, float* out, int M,
                   int N, int K, int device, cudaStream_t s) {
  using T = PackedWsTile<BITS, R>;
  CUtensorMap xmap;
  cudaError_t err = wg::tile_map(&xmap, 1, x, M, K, pitch, 64 * R, T::STAGE_K);
  static bool smem_set[16] = {};
  if (err == cudaSuccess) err = wg::allow_smem(kernel, T::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + 64 * R - 1) / (64 * R));
  kernel<<<grid, T::THREADS, T::SMEM, s>>>(xmap, wp, epi, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace ws
}  // namespace qt
