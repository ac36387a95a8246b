// The streamed schedule of the tensor-core GEMMs whose weights stream from
// device memory once per output tile: the packed-weight GEMMs shift_gemm
// (K8), dorefa_gemm (K6) and binary_gemm (K1), out (M x N) = x (M x K) @
// decode(packed words), and the raw int8 GEMM int8_gemm (K3) and implicit-GEMM conv
// int8_conv2d (K5), on the tensor cores (mma.sync, mma_tile.cuh).
//
// A block owns a BM x BN output tile (BM = 32, 64 or 128, BN = 64 or 128;
// 8 warps as 2 x 4 or 4 x 2, with MF 16-row and NF 8-column fragments each)
// and walks one contiguous chunk of K's stages (STAGE_BYTES = 64 bytes of k
// each). When the tile grid alone cannot fill the card, the launch splits K
// into gridDim.z such chunks; each block then writes its partial tile to a
// workspace (S, M, N) and a second kernel sums the S partials in index order
// (sum_splits), so two launches give the same bits.
//
// Shared memory (dynamic, in 32-bit words; Tile below):
//   ring  RING slots of A_WORDS: the stage's activation rows, filled by
//         cp.async (load_a); stage t + RING - 2 is in flight while stage t
//         is multiplied and t + 1 prepared
//   Wg    W_SLOTS slots of W_SLOT_WORDS weights, filled by cp.async
//         (load_w) with the first stage of each weight group: 2 slots of a
//         32 x 64 packed-word group (K1, K6, K8: a group spans >= 2 stages), or
//         RING slots of one raw int8 stage each (K3, K5: a group is a stage,
//         64 k-rows x BN bytes, RAW_PAD bytes of pad a row)
//   Bs    2 x (BN x LDW) prepared weights, one stage each: decoded (K1, K6, K8)
//         or transposed to K-major (K3, K5: transpose_stage)
//   As    2 x (BM x LDW) activations in the MMA's type, where the ring holds
//         another (CONVERT: float32 x rounded to bf16 by prep)
// One __syncthreads per stage: after it, stage t + 1 has landed and every
// warp has finished stage t - 1, so its ring slot, Bs and As buffers take
// the next loads and preps. Wg's slot for group g is rewritten (group
// g + W_SLOTS) at the issue of stage (g + W_SLOTS) spg, RING - 1 stages
// ahead, after the prep of g's last stage (g + 1) spg - 1 when
// (W_SLOTS - 1) spg >= 2: 2 slots of groups of >= 2 stages, or RING slots of
// one stage.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace qt {
namespace stream {

using mma::LDW;
using mma::STAGE_BYTES;
using mma::THREADS;

constexpr int BN = 64;          // output columns per block of K1, K3, K6 and K8
constexpr int RING = 4;         // activation stages in shared memory
constexpr int GROUP_ROWS = 32;  // words per self-contained packed group
constexpr int W_WORDS = GROUP_ROWS * BN;
constexpr int RAW_PAD = 16;     // bytes of pad per k-row of a raw int8 weight stage
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block on the H100

// Words per k-row and per slot of a raw int8 weight stage of `bn` columns.
__host__ __device__ constexpr int raw_row_words(int bn) { return (bn + RAW_PAD) / 4; }
__host__ __device__ constexpr int raw_stage_words(int bn) {
  return STAGE_BYTES * raw_row_words(bn);
}

// One instance's tile: its shape, its warps' fragment grid (WM warps along M,
// 8 / WM along N; MF x NF fragments each, WM 16-row fragments apart) and its
// shared memory in bytes (the layout above).
template <int BM_, int BN_, int A_WORDS_, int W_SLOTS_, int W_SLOT_WORDS_, bool CONVERT_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, A_WORDS = A_WORDS_;
  static constexpr int W_SLOTS = W_SLOTS_, W_SLOT_WORDS = W_SLOT_WORDS_;
  static constexpr bool CONVERT = CONVERT_;
  static constexpr int WM = BM >= 64 ? 4 : 2, MF = BM / (16 * WM), NF = BN / (8 / WM) / 8;
  static constexpr size_t SMEM = 4 * ((size_t)RING * A_WORDS + (size_t)W_SLOTS * W_SLOT_WORDS +
                                      2 * BN * LDW + (CONVERT ? 2 * BM * LDW : 0));
  static_assert(MF >= 1 && NF >= 1 && SMEM <= SMEM_LIMIT, "no such streamed tile");
};

// K1, K6 and K8: packed 32-word groups of 64 columns, two slots.
template <int BM, int A_WORDS, bool CONVERT>
using PackedTile = Tile<BM, BN, A_WORDS, 2, W_WORDS, CONVERT>;
// K3 and K5: raw int8 weights, one stage a slot, RING slots; the ring holds
// BM activation rows of LDW words, which the MMA reads in place.
template <int BM, int BN_>
using BytesTile = Tile<BM, BN_, BM * LDW, RING, raw_stage_words(BN_), false>;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (4) bytes from global src to shared dst: the first src_bytes are read,
// the rest are zero-filled; src_bytes = 0 reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy packed word rows [32 g, 32 g + 32) x columns [n0, n0 + 64) of wp (R x
// N) into W (32 x 64); columns >= N read as 0. `vec`: N % 4 == 0 and wp
// 16-byte aligned, so four neighbouring columns are one 16-byte copy.
__device__ __forceinline__ void load_words(uint32_t* W, const uint32_t* __restrict__ wp, int g,
                                           int n0, int N, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < W_WORDS / 4; e += THREADS) {
      const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
      const bool in = n0 + c < N;
      cp_async16(W + r * BN + c, in ? wp + (size_t)(g * GROUP_ROWS + r) * N + n0 + c : wp,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < W_WORDS; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const bool in = n0 + c < N;
      cp_async4(W + r * BN + c, in ? wp + (size_t)(g * GROUP_ROWS + r) * N + n0 + c : wp,
                in ? 4 : 0);
    }
  }
}

// Four BITS-bit codes c, one in the low bits of each byte, as the centered
// int8 2c - n_w in each byte (n_w = 2^BITS - 1), carry-free as in
// packed_ws.cuh's centered_bytes (K10's and K11's decoder, whose header
// does not include this one): 2c + 128 - n_w lies in [113, 143], so no
// byte carries into the next, and flipping each byte's top bit takes the
// 128 off again.
template <int BITS>
__device__ __forceinline__ uint32_t centered_bytes4(uint32_t c) {
  constexpr uint32_t NW = (1u << BITS) - 1;
  return (2 * c + (0x80u - NW) * 0x01010101u) ^ 0x80808080u;
}

// Bit field i of four packed words of BITS-bit codes c, as the centered
// int8 2c - (2^BITS - 1) of word j in byte j: ±1 at one bit (binary_gemm),
// odd and within ±15 at up to four (dorefa_gemm).
template <int BITS>
__device__ __forceinline__ uint32_t field_bytes(const uint32_t (&w)[4], int i) {
  constexpr uint32_t NW = (1u << BITS) - 1;
  uint32_t o = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) o |= ((w[j] >> (BITS * i)) & NW) << (8 * j);
  return centered_bytes4<BITS>(o);
}

// A packed group's stage, centered int8, into Bs (64 columns x LDW words,
// K-major): word q of column c holds weight rows k0 + 4q .. + 3, bit field
// plane0 + q / 8 of word rows 4 (q % 8) .. + 3 of Ws (a 32 x 64 group,
// load_words). One thread reads the four words of rows 4j .. 4j + 3 of a
// column once and writes both planes' words (q = j and j + 8).
template <int BITS>
__device__ __forceinline__ void decode_packed_stage(uint32_t* Bs, const uint32_t* Ws, int plane0) {
  for (int e = threadIdx.x; e < 8 * BN; e += THREADS) {
    const int c = e % BN, j = e / BN;
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = Ws[(4 * j + i) * BN + c];
#pragma unroll
    for (int p = 0; p < 2; ++p) Bs[c * LDW + 8 * p + j] = field_bytes<BITS>(w, plane0 + p);
  }
}

// The widest copy a row-major byte matrix p with rows of `row_bytes`
// takes: 16 (cp.async of 16 bytes) where every row starts 16-byte aligned,
// 4 where every row starts 4-byte aligned, else 1 (plain byte loads).
inline int copy_mode(const void* p, long row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (row_bytes % 16 == 0 && a % 16 == 0) return 16;
  return row_bytes % 4 == 0 && a % 4 == 0 ? 4 : 1;
}

// Copy bytes [k0, k0 + 64) of rows [m0, m0 + BM) of the row-major byte
// matrix x (M rows of K bytes) into S (BM x LDW words); bytes past K and
// rows past M read as 0. mode 16: K % 16 == 0 and x 16-byte aligned, one
// cp.async of 16 bytes per 16; mode 4: K % 4 == 0 and x 4-byte aligned, of
// 4 bytes; else plain byte loads, one word a thread, which the next
// barrier publishes.
template <int BM>
__device__ __forceinline__ void load_rows(uint32_t* S, const uint8_t* __restrict__ x, int m0,
                                          int M, int k0, int K, int mode) {
  if (mode == 16) {
    for (int e = threadIdx.x; e < BM * 4; e += THREADS) {
      const int r = e >> 2, c = 16 * (e & 3);
      const bool in = m0 + r < M && k0 + c < K;
      cp_async16(S + r * LDW + c / 4, in ? x + (size_t)(m0 + r) * K + k0 + c : x, in ? 16 : 0);
    }
  } else if (mode == 4) {
    for (int e = threadIdx.x; e < BM * 16; e += THREADS) {
      const int r = e >> 4, c = 4 * (e & 15);
      const bool in = m0 + r < M && k0 + c < K;
      cp_async4(S + r * LDW + c / 4, in ? x + (size_t)(m0 + r) * K + k0 + c : x, in ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BM * 16; e += THREADS) {
      const int r = e >> 4, k = k0 + 4 * (e & 15);
      uint32_t v = 0u;
      if (m0 + r < M) {
        const uint8_t* p = x + (size_t)(m0 + r) * K;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < K) v |= (uint32_t)p[k + i] << (8 * i);
      }
      S[r * LDW + (e & 15)] = v;
    }
  }
}

// Copy one raw int8 weight stage, k-rows kl = 0 .. 63 x columns [n0, n0 +
// BN_) of w (row-major, N bytes a row), into W (raw_row_words(BN_) words a
// k-row): k-row kl reads row row0 + kl * row_step of w for kl < rows, and
// is 0 from there on; columns past N read as 0. mode 16: N % 16 == 0 and w
// 16-byte aligned (one cp.async per 16 bytes); mode 4: N % 4 == 0 and w
// 4-byte aligned; else plain byte loads, which the next barrier publishes.
template <int BN_>
__device__ __forceinline__ void load_stage_bytes(uint32_t* W, const uint8_t* __restrict__ w,
                                                 int N, int n0, int mode, long row0,
                                                 int row_step, int rows) {
  constexpr int RW = raw_row_words(BN_);
  if (mode == 16) {
    for (int e = threadIdx.x; e < STAGE_BYTES * BN_ / 16; e += THREADS) {
      const int kl = e / (BN_ / 16), c = 16 * (e % (BN_ / 16));
      const bool in = kl < rows && n0 + c < N;
      const uint8_t* src = w + (size_t)(row0 + (long)kl * row_step) * N + n0 + c;
      cp_async16(W + kl * RW + c / 4, in ? src : w, in ? 16 : 0);
    }
  } else if (mode == 4) {
    for (int e = threadIdx.x; e < STAGE_BYTES * BN_ / 4; e += THREADS) {
      const int kl = e / (BN_ / 4), c = 4 * (e % (BN_ / 4));
      const bool in = kl < rows && n0 + c < N;
      const uint8_t* src = w + (size_t)(row0 + (long)kl * row_step) * N + n0 + c;
      cp_async4(W + kl * RW + c / 4, in ? src : w, in ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < STAGE_BYTES * BN_ / 4; e += THREADS) {
      const int kl = e / (BN_ / 4), c = 4 * (e % (BN_ / 4));
      uint32_t v = 0u;
      if (kl < rows) {
        const uint8_t* p = w + (size_t)(row0 + (long)kl * row_step) * N;
        for (int i = 0; i < 4 && n0 + c + i < N; ++i) v |= (uint32_t)p[n0 + c + i] << (8 * i);
      }
      W[kl * RW + c / 4] = v;
    }
  }
}

// A raw int8 weight stage W (load_stage_bytes) into Bs[n][kb], the K-major
// layout mma_tile.cuh's fragments read: word q of column n holds k-rows 4q ..
// 4q + 3. One unit is 4 k-rows x 4 columns (column quad u, k-row quad q): a
// word of each row, transposed in registers with __byte_perm (ldmatrix
// .trans moves 16-bit elements and cannot do it for int8); a warp takes 8
// column quads x 4 k-row quads. Its shared-memory accesses are free of bank
// conflicts: the lanes of k-quads 2 and 3 read their rows in the order 2, 3,
// 0, 1 (j ^ rr, rr = 2), and each lane writes its four columns in the order
// i ^ rot, rot = (u / 2) % 4; the selectors absorb both orders.
template <int BN_>
__device__ __forceinline__ void transpose_stage(uint32_t* Bs, const uint32_t* W) {
  constexpr int RW = raw_row_words(BN_), NB = BN_ / 32;
  const int lane = threadIdx.x & 31, rr = (lane >> 3) & 2, rot = (lane >> 1) & 3;
  // first level, pair p: rows (a, a + 1) interleaved at columns {2 (p ^ (rot
  // / 2)), + 1}; second level: column c of the four rows from the pair of
  // rows (rr, rr + 1) and the pair (rr ^ 2, (rr ^ 2) + 1), for c even / odd
  const uint32_t s1[2] = {rot & 2 ? 0x7362u : 0x5140u, rot & 2 ? 0x5140u : 0x7362u};
  const uint32_t even = rr ? 0x1054u : 0x5410u, odd = rr ? 0x3276u : 0x7632u;
  const uint32_t s2[2] = {rot & 1 ? odd : even, rot & 1 ? even : odd};  // write h of a pair
  for (int e = threadIdx.x; e < 16 * (BN_ / 4); e += THREADS) {
    const int sub = e & 31, blk = e >> 5;
    const int u = (blk % NB) * 8 + (sub & 7), q = (blk / NB) * 4 + (sub >> 3);
    uint32_t L[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) L[j] = W[(4 * q + (j ^ rr)) * RW + u];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t t01 = __byte_perm(L[0], L[1], s1[p]), t23 = __byte_perm(L[2], L[3], s1[p]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        Bs[(4 * u + ((2 * p + h) ^ rot)) * LDW + q] = __byte_perm(t01, t23, s2[h]);
    }
  }
}

// The main loop of the block that owns output tile (m_tile, n_tile) over
// its chunk: stages [blockIdx.z * chunk, + chunk) of the k_stages that
// cover K, each STAGE_BYTES / Op::ELEM_BYTES deep; spg stages per weight
// group. load_a(slot, m0, k0) issues the copies
// of the stage at k0 for rows [m0, m0 + BM) into a ring slot (activations k
// >= K and rows >= M as 0); load_w(slot, g, n0) those of weight group g for
// columns [n0, n0 + BN) into a Wg slot; prep(slot, W, stage in group, Bs,
// As) prepares the stage's weights from its group's slot W into Bs (and,
// CONVERT, the ring slot into As). Leaves the block's sums in acc, which
// warp (wm, wn) holds for rows m0 + 16 wm + 16 WM i and columns n0 + 8 NF wn
// + 8 j (mma::for_each_acc); the ring and Bs are still being read by other
// warps when it returns.
template <class Op, class T, class LoadA, class LoadW, class Prep>
__device__ __forceinline__ void stream_mainloop(int m_tile, int n_tile, int spg, int k_stages,
                                                int chunk, LoadA load_a, LoadW load_w, Prep prep,
                                                typename Op::acc_t (&acc)[T::MF][T::NF][4]) {
  constexpr int STAGE_K = STAGE_BYTES / Op::ELEM_BYTES;
  constexpr int BM = T::BM, BN_ = T::BN;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;
  uint32_t* Wg = ring + RING * T::A_WORDS;
  uint32_t* Bs = Wg + T::W_SLOTS * T::W_SLOT_WORDS;
  uint32_t* As = Bs + 2 * BN_ * LDW;
  const int n0 = n_tile * BN_, m0 = m_tile * BM;
  const int s0 = blockIdx.z * chunk, g0 = s0 / spg;
  const int n_stages = min(chunk, k_stages - s0);
  const int warp = threadIdx.x >> 5, wm = warp % T::WM, wn = warp / T::WM;
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  auto words = [&](int s) {
    return Wg + ((unsigned)(s / spg - g0) % T::W_SLOTS) * T::W_SLOT_WORDS;
  };
  // one commit group per stage, empty past the chunk, so wait_group counts stages
  auto issue = [&](int t) {
    if (t < n_stages) {
      const int s = s0 + t;
      if (t == 0 || s % spg == 0) load_w(words(s), s / spg, n0);
      load_a(ring + (t % RING) * T::A_WORDS, m0, s * STAGE_K);
    }
    cp_async_commit();
  };
  auto prep_stage = [&](int t) {
    const int s = s0 + t;
    prep(ring + (t % RING) * T::A_WORDS, words(s), s % spg, Bs + (t & 1) * BN_ * LDW,
         As + (t & 1) * BM * LDW);
  };

#pragma unroll
  for (int t = 0; t < RING - 1; ++t) issue(t);
  cp_async_wait<RING - 2>();
  __syncthreads();
  if (n_stages > 0) prep_stage(0);
  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<RING - 3>();  // stage t + 1 has landed
    __syncthreads();
    issue(t + RING - 1);  // into stage t - 1's slot
    if (t + 1 < n_stages) prep_stage(t + 1);
    const uint32_t* A = T::CONVERT ? As + (t & 1) * BM * LDW : ring + (t % RING) * T::A_WORDS;
    mma::warp_stage_ldsm<Op, T::MF, T::NF>(A, Bs + (t & 1) * BN_ * LDW, acc, 16 * wm,
                                           16 * T::WM, T::NF * 8 * wn);
  }
}

// stream_mainloop over tile (blockIdx.y, blockIdx.x), then store(row, col,
// acc) for every output of the tile (rows and columns past the edge
// included: store masks them).
template <class Op, class T, class LoadA, class LoadW, class Prep, class Store>
__device__ __forceinline__ void stream_gemm(int spg, int k_stages, int chunk, LoadA load_a,
                                            LoadW load_w, Prep prep, Store store) {
  typename Op::acc_t acc[T::MF][T::NF][4];
  stream_mainloop<Op, T>(blockIdx.y, blockIdx.x, spg, k_stages, chunk, load_a, load_w, prep, acc);
  const int warp = threadIdx.x >> 5, wm = warp % T::WM, wn = warp / T::WM;
  mma::for_each_acc<T::MF, T::NF>(acc, blockIdx.y * T::BM + 16 * wm, 16 * T::WM,
                                  blockIdx.x * T::BN + T::NF * 8 * wn, store);
}

// The packed-code GEMM on this schedule (K1 at one bit, K6 at two or four):
// x (M rows of K int8, copied in load_rows's `xmode`) times the
// grouped-planar BITS-bit codes wp (load_words, `wvec`), each stage's two
// bit fields decoded once into centered int8 (decode_packed_stage) for
// mma.sync; store(row, col, acc) as stream_gemm's.
template <int BITS, int BM, class Store>
__device__ __forceinline__ void packed_code_gemm(const int8_t* __restrict__ x,
                                                 const uint32_t* __restrict__ wp, int M, int N,
                                                 int K, int k_stages, int chunk, int xmode,
                                                 bool wvec, Store store) {
  const auto* xb = reinterpret_cast<const uint8_t*>(x);
  auto load_a = [&](uint32_t* S, int m0, int k0) { load_rows<BM>(S, xb, m0, M, k0, K, xmode); };
  auto load_w = [&](uint32_t* W, int g, int n0) { load_words(W, wp, g, n0, N, wvec); };
  // stage s of a group: bit fields 2s and 2s + 1
  auto prep = [](const uint32_t*, const uint32_t* W, int stage, uint32_t* Bs, uint32_t*) {
    decode_packed_stage<BITS>(Bs, W, 2 * stage);
  };
  constexpr int GROUP_K = (32 / BITS) * GROUP_ROWS;
  stream_gemm<mma::S8, PackedTile<BM, BM * LDW, false>>(GROUP_K / STAGE_BYTES, k_stages, chunk,
                                                        load_a, load_w, prep, store);
}

// The split's second pass: out[i] = sum over z of part[z][i] (part: S
// partials of mn outputs each), z = 0 .. S - 1 in index order, so two
// launches give the same bits; write(i, sum) stores it. One thread per
// output; the loads of eight splits are in flight at once.
template <class T, class Write>
__device__ __forceinline__ void sum_splits(const T* __restrict__ part, size_t mn, int splits,
                                           Write write) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    T s = part[i];
#pragma unroll 8
    for (int z = 1; z < splits; ++z) s += part[(size_t)z * mn + i];
    write(i, s);
  }
}

// Blocks of 256 threads for sum_splits over mn outputs: one per 256, at most
// 8 per SM.
inline unsigned sum_blocks(size_t mn) {
  const size_t blocks = (mn + 255) / 256;
  return (unsigned)(blocks < 1056 ? blocks : 1056);
}

// Raise `kernel`'s dynamic shared-memory limit to `bytes`, once per device
// (`done`: the caller's flags, one per device index below 16).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, int device, bool (&done)[16]) {
  if (device >= 0 && device < 16 && done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && device >= 0 && device < 16) done[device] = true;
  return err;
}

// Checks of a launch plan (BM, splits, chunk in k) for k_stages stages:
// every split's chunk is non-empty and together they cover the stages; a
// split has a workspace.
inline bool valid_plan(int bm, int splits, int chunk_k, int stage_k, int k_stages,
                       const void* ws) {
  if ((bm != 32 && bm != 64 && bm != 128) || splits < 1 || chunk_k < 0 || chunk_k % stage_k != 0)
    return false;
  if (splits > 1 && ws == nullptr) return false;
  const long chunk = chunk_k / stage_k;
  if (k_stages == 0) return splits == 1;
  return chunk * splits >= k_stages && chunk * (splits - 1) < k_stages;
}

}  // namespace stream
}  // namespace qt
