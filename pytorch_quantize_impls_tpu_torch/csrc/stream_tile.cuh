// The streamed schedule of the packed-weight GEMMs shift_gemm (K8) and
// dorefa_gemm (K6): out (M x N) = x (M x K) @ decode(packed words), on the
// tensor cores (mma.sync, mma_tile.cuh), for the serving batch sizes, where
// the output grid is small and the packed weights are the bytes that count.
//
// A block owns a BM x 64 output tile (BM = 32, 64 or 128; 8 warps as 2 x 4,
// 4 x 2 or 4 x 2 with two 16-row fragments each) and walks one
// contiguous chunk of K's stages (STAGE_BYTES = 64 bytes of k each). When
// the tile grid alone cannot fill the card, the launch splits K into
// gridDim.z such chunks; each block then writes its partial tile to a
// workspace (S, M, N) and a second kernel sums the S partials in index order
// (sum_splits), so two launches give the same bits.
//
// Shared memory (dynamic, in 32-bit words):
//   ring  RING slots of A_WORDS: the stage's activation rows, filled by
//         cp.async (load_a); stage t + RING - 2 is in flight while stage t
//         is multiplied and t + 1 decoded
//   Wg    2 x (32 x 64) packed words: the group of the stages being decoded
//         and the next one, filled by cp.async with the first stage of each
//   Bs    2 x (64 x LDW) decoded weights, one stage each
//   As    2 x (BM x LDW) activations in the MMA's type, where the ring holds
//         another (CONVERT: float32 x rounded to bf16 by prep)
// One __syncthreads per stage: after it, stage t + 1 has landed and every
// warp has finished stage t - 1, so its ring slot, Bs and As buffers take
// the next loads and decodes. Wg's slot for group g is rewritten (group
// g + 2) only after the last decode of g: a group has >= 2 stages.
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

constexpr int BN = 64;          // output columns per block
constexpr int RING = 4;         // activation stages in shared memory
constexpr int GROUP_ROWS = 32;  // words per self-contained packed group
constexpr int W_WORDS = GROUP_ROWS * BN;

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

template <int BM, int A_WORDS, bool CONVERT>
constexpr size_t smem_bytes() {
  return 4 * ((size_t)RING * A_WORDS + 2 * W_WORDS + 2 * BN * LDW + (CONVERT ? 2 * BM * LDW : 0));
}

// The block's chunk: stages [blockIdx.z * chunk, + chunk) of the k_stages
// that cover K, each STAGE_BYTES / Op::ELEM_BYTES deep; spg stages per packed
// group (>= 2). load_a(slot, m0, k0) issues the copies of the stage at k0
// for rows [m0, m0 + BM) into a ring slot (activations k >= K and rows >= M
// as 0); prep(slot, W, stage in group, Bs, As) decodes the stage's weights
// from its group's words W into Bs (and, CONVERT, the slot into As);
// store(row, col, acc) writes one output (rows and columns past the edge
// included: store masks them).
template <class Op, int BM, int A_WORDS, bool CONVERT, class LoadA, class Prep, class Store>
__device__ __forceinline__ void stream_gemm(const uint32_t* __restrict__ wp, int N, int spg,
                                            int k_stages, int chunk, bool wvec, LoadA load_a,
                                            Prep prep, Store store) {
  constexpr int STAGE_K = STAGE_BYTES / Op::ELEM_BYTES;
  // 8 warps as WM (M) x 8 / WM (N); each MF 16-row fragments, WM 16 rows
  // apart, times NF 8-column ones
  constexpr int WM = BM >= 64 ? 4 : 2, MF = BM / (16 * WM), NF = BN / (8 / WM) / 8;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;
  uint32_t* Wg = ring + RING * A_WORDS;
  uint32_t* Bs = Wg + 2 * W_WORDS;
  uint32_t* As = Bs + 2 * BN * LDW;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int s0 = blockIdx.z * chunk, g0 = s0 / spg;
  const int T = min(chunk, k_stages - s0);
  const int warp = threadIdx.x >> 5, wm = warp % WM, wn = warp / WM;
  typename Op::acc_t acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  auto words = [&](int s) { return Wg + ((s / spg - g0) & 1) * W_WORDS; };
  // one commit group per stage, empty past the chunk, so wait_group counts stages
  auto issue = [&](int t) {
    if (t < T) {
      const int s = s0 + t;
      if (t == 0 || s % spg == 0) load_words(words(s), wp, s / spg, n0, N, wvec);
      load_a(ring + (t % RING) * A_WORDS, m0, s * STAGE_K);
    }
    cp_async_commit();
  };
  auto prep_stage = [&](int t) {
    const int s = s0 + t;
    prep(ring + (t % RING) * A_WORDS, words(s), s % spg, Bs + (t & 1) * BN * LDW,
         As + (t & 1) * BM * LDW);
  };

#pragma unroll
  for (int t = 0; t < RING - 1; ++t) issue(t);
  cp_async_wait<RING - 2>();
  __syncthreads();
  if (T > 0) prep_stage(0);
  for (int t = 0; t < T; ++t) {
    cp_async_wait<RING - 3>();  // stage t + 1 has landed
    __syncthreads();
    issue(t + RING - 1);  // into stage t - 1's slot
    if (t + 1 < T) prep_stage(t + 1);
    const uint32_t* A = CONVERT ? As + (t & 1) * BM * LDW : ring + (t % RING) * A_WORDS;
    mma::warp_stage<Op, MF, NF>(A, Bs + (t & 1) * BN * LDW, acc, 16 * wm, 16 * WM, NF * 8 * wn);
  }
  mma::for_each_acc<MF, NF>(acc, m0 + 16 * wm, 16 * WM, n0 + NF * 8 * wn, store);
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
