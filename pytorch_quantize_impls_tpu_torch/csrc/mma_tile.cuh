// Warp-level tensor-core tiles (mma.sync) shared by the tiled matmul of the
// dtype probe (mxu_probe.cu) and the weight-stationary GEMMs
// (binary_gemm_ws, dorefa_gemm_ws, shift_gemm_ws).
//
// Shared memory holds both operands k-contiguous, one row per output row (A)
// or output column (B), STAGE_BYTES = 64 bytes of k per stage, each row
// padded to LDW = 20 words so that the eight rows a fragment load touches
// fall in distinct banks:
//   A[m][kb] = x[m0 + m, k0 + kb]      (byte kb of row m)
//   B[n][kb] = w[k0 + kb, n0 + n]      (the transpose: k runs along the row)
// One stage is two 32-byte k-steps. In bytes, a 32-byte k-step has the same
// fragment layout for all three instructions used here (PTX ISA, "Matrix
// fragments for mma.m16n8k*"): with lane = 4 gid + tig,
//   A regs: (row gid, word tig) (row gid + 8, word tig) (row gid, word tig + 4)
//           (row gid + 8, word tig + 4)
//   B regs: (col gid, word tig) (col gid, word tig + 4)
//   C regs: (row gid, cols 2 tig, 2 tig + 1) (row gid + 8, the same cols)
// and a 32-bit word holds 4 int8, 8 int4 (low nibble first) or 2 bf16
// (lower k in the low half) consecutive k values.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace qt {
namespace mma {

constexpr int THREADS = 256;      // 8 warps
constexpr int STAGE_BYTES = 64;   // k bytes per shared-memory stage
constexpr int LDW = 20;           // words per shared row: 16 data + 4 pad

// int8 x int8 -> int32, k = 32; the int32 sum is exact
struct S8 {
  using acc_t = int32_t;
  static constexpr int ELEM_BYTES = 1;
  __device__ __forceinline__ static void run(int32_t (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// int4 x int4 -> int32, k = 64 (two values per byte, low nibble first); the
// int32 sum is exact. In bytes its fragments are S8's.
struct S4 {
  using acc_t = int32_t;
  static constexpr int ELEM_BYTES = 1;
  __device__ __forceinline__ static void run(int32_t (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// bf16 x bf16 -> f32, k = 16; products are exact, the f32 sum is the
// tensor core's
struct BF16 {
  using acc_t = float;
  static constexpr int ELEM_BYTES = 2;
  __device__ __forceinline__ static void run(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// One stage of a warp's MF x NF grid of 16 x 8 output fragments: fragment
// (i, j) covers A rows arow0 + i * astep .. + 16 and B columns
// bcol0 + 8 j .. + 8 of the shared tiles As, Bs (LDW words per row).
template <class Op, int MF, int NF>
__device__ __forceinline__ void warp_stage(const uint32_t* As, const uint32_t* Bs,
                                           typename Op::acc_t (&acc)[MF][NF][4], int arow0,
                                           int astep, int bcol0) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int kw = 8 * ks + tig;
    uint32_t b[NF][2];
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const uint32_t* p = Bs + (bcol0 + 8 * j + gid) * LDW + kw;
      b[j][0] = p[0];
      b[j][1] = p[4];
    }
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      const uint32_t* p = As + (arow0 + i * astep + gid) * LDW + kw;
      const uint32_t a[4] = {p[0], p[8 * LDW], p[4], p[8 * LDW + 4]};
#pragma unroll
      for (int j = 0; j < NF; ++j) Op::run(acc[i][j], a, b[j]);
    }
  }
}

// Calls f(row, col, value) for every accumulator element of warp_stage's grid.
template <int MF, int NF, class T, class F>
__device__ __forceinline__ void for_each_acc(const T (&acc)[MF][NF][4], int arow0, int astep,
                                             int bcol0, F f) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        f(arow0 + i * astep + gid + 8 * (c >> 1), bcol0 + 8 * j + 2 * tig + (c & 1), acc[i][j][c]);
}

// Stage bytes [kb0, kb0 + 64) of rows [m0, m0 + rows) of a row-major byte
// matrix x (M rows of KB bytes) into S; bytes outside read as 0. `vec`: KB
// % 16 == 0 and x 16-byte aligned, so a whole in-range chunk is one load.
__device__ __forceinline__ void load_rows_bytes(uint32_t* S, const uint8_t* __restrict__ x,
                                                int m0, int rows, int M, int kb0, int KB,
                                                bool vec) {
  for (int e = threadIdx.x; e < rows * 4; e += THREADS) {
    const int r = e >> 2, c = e & 3;
    const int m = m0 + r, kb = kb0 + 16 * c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m < M) {
      const uint8_t* p = x + (size_t)m * KB + kb;
      if (vec && kb + 16 <= KB) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        for (int i = 0; i < 16 && kb + i < KB; ++i) w[i >> 2] |= (uint32_t)p[i] << (8 * (i & 3));
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(S + r * LDW + 4 * c) = v;
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Stage columns [k0, k0 + 32) of rows [m0, m0 + rows) of a row-major float32
// matrix x (M x K) into S as bf16 (round to nearest even, as PyTorch's and
// XLA's convert); elements outside read as 0. `vec`: K % 4 == 0 and x
// 16-byte aligned.
__device__ __forceinline__ void load_rows_f32_as_bf16(uint32_t* S, const float* __restrict__ x,
                                                      int m0, int rows, int M, int k0, int K,
                                                      bool vec) {
  for (int e = threadIdx.x; e < rows * 8; e += THREADS) {
    const int r = e >> 3, c = e & 7;
    const int m = m0 + r, k = k0 + 4 * c;
    float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m < M) {
      const float* p = x + (size_t)m * K + k;
      if (vec && k + 4 <= K) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
      } else {
        for (int i = 0; i < 4 && k + i < K; ++i) f[i] = p[i];
      }
    }
    *reinterpret_cast<uint2*>(S + r * LDW + 2 * c) =
        make_uint2(bf16_pair(f[0], f[1]), bf16_pair(f[2], f[3]));
  }
}

// Stage the transpose of rows [kr0, kr0 + 64 / EB) of a row-major matrix w
// (N elements of EB bytes per row; N % (4 / EB) == 0, w 4-byte aligned) for
// columns [n0, n0 + cols), cols % 32 == 0, into S: word q of column n holds
// rows kr0 + q (4 / EB) ... One unit is 4 / EB rows x 4 / EB columns, read
// as one 32-bit word per row (8 neighbouring lanes cover 32 contiguous bytes
// of a row) and transposed in registers.
template <int EB>
__device__ __forceinline__ void load_cols_transposed(uint32_t* S, const uint8_t* __restrict__ w,
                                                     int kr0, int n0, int cols, int N) {
  constexpr int RU = 4 / EB;
  const int cu = cols / RU, nb = cu / 8;
  for (int e = threadIdx.x; e < 16 * cu; e += THREADS) {
    const int sub = e & 31, blk = e >> 5;
    const int u = (blk % nb) * 8 + (sub & 7), q = (blk / nb) * 4 + (sub >> 3);
    const int n = n0 + RU * u, k = kr0 + RU * q;
    uint32_t r[RU];
#pragma unroll
    for (int j = 0; j < RU; ++j)
      r[j] = *reinterpret_cast<const uint32_t*>(w + ((size_t)(k + j) * N + n) * EB);
    uint32_t* s = S + RU * u * LDW + q;
    if constexpr (EB == 1) {  // 4 x 4 bytes
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
      s[0] = __byte_perm(t0, t1, 0x5410);
      s[LDW] = __byte_perm(t0, t1, 0x7632);
      s[2 * LDW] = __byte_perm(t2, t3, 0x5410);
      s[3 * LDW] = __byte_perm(t2, t3, 0x7632);
    } else {  // 2 x 2 halves
      s[0] = __byte_perm(r[0], r[1], 0x5410);
      s[LDW] = __byte_perm(r[0], r[1], 0x7632);
    }
  }
}

// The tiled matmul of the dtype probe: out (M x N, f32) = x (M x KB bytes,
// row-major) @ w (KB / EB rows x N, row-major), with elements of EB bytes
// (int8: 1; bf16: 2; int4: two per byte, low nibble first along K for x and
// along the rows for w, passed as EB = 1). A block computes a BM x BN tile
// and walks K in 64-byte stages, both operands staged in shared memory with
// plain 16-byte (A) and 4-byte (B, transposed in registers) loads; 8 warps
// as 2 (M) x 4 (N), each an (BM / 32) x (BN / 32) grid of fragments, the
// accumulator in registers in Op's type, cast to f32 at the end. No padding:
// M % BM == N % BN == KB % 64 == 0 (the caller checks).
template <class Op, int EB, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
tiled_mm_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                float* __restrict__ out, int M, int N, int KB) {
  constexpr int MF = BM / 32, NF = BN / 32;
  __shared__ __align__(16) uint32_t As[BM * LDW];
  __shared__ __align__(16) uint32_t Bs[BN * LDW];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, arow0 = (warp >> 2) * (BM / 2), bcol0 = (warp & 3) * (BN / 4);
  typename Op::acc_t acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
  for (int kb0 = 0; kb0 < KB; kb0 += STAGE_BYTES) {
    load_rows_bytes(As, x, m0, BM, M, kb0, KB, true);
    load_cols_transposed<EB>(Bs, w, kb0 / EB, n0, BN, N);
    __syncthreads();
    warp_stage<Op, MF, NF>(As, Bs, acc, arow0, 16, bcol0);
    __syncthreads();
  }
  for_each_acc<MF, NF>(acc, m0 + arow0, 16, n0 + bcol0,
                       [&](int r, int c, auto v) { out[(size_t)r * N + c] = (float)v; });
}

// The weight-stationary schedule of binary_gemm_ws, dorefa_gemm_ws and
// shift_gemm_ws. A block owns output columns [n0, n0 + 64) and R M-tiles of
// 64 rows, [m0, m0 + 64 R). Walking K one 64-byte stage at a time, it
//   - stages the packed words of the stage's 32-word group for its 64
//     columns (8 KB) in Ws when the stage enters a new group,
//   - decodes that stage's bit planes ONCE into the k-contiguous tile Bs
//     (decode(Bs, Ws, first plane of the stage)),
//   - loads the stage of all R M-tiles (load_a(As, m0, k0)) and runs every
//     one of them against Bs before it moves on.
// Its 64 R x 64 accumulators stay in registers for the whole of K: 8 warps
// as 4 (M) x 2 (N), warp (wm, wn) holding rows r * 64 + 16 wm .. + 16 of
// every M-tile r and columns 32 wn .. + 32. So each packed weight tile is
// decoded ceil(M / (64 R)) times. store(row, col, acc) writes one output.
template <class Op, int R, class LoadA, class Decode, class Store>
__device__ __forceinline__ void ws_gemm(const uint32_t* __restrict__ wp, int N, int K,
                                        int group_k, LoadA load_a, Decode decode, Store store) {
  constexpr int BN = 64, STAGE_K = STAGE_BYTES / Op::ELEM_BYTES;
  __shared__ __align__(16) uint32_t As[64 * R * LDW];
  __shared__ __align__(16) uint32_t Bs[BN * LDW];
  __shared__ uint32_t Ws[32 * BN];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 64 * R;
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  typename Op::acc_t acc[R][4][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
  // Activation columns k >= K read as 0, so the stages past K add nothing.
  for (int k0 = 0; k0 < K; k0 += STAGE_K) {
    const int in_group = k0 % group_k;
    if (in_group == 0) {  // the previous decode's reads ended at its barrier
      const int g = k0 / group_k;
      for (int e = threadIdx.x; e < 32 * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        Ws[e] = (n0 + c < N) ? wp[(size_t)(g * 32 + r) * N + n0 + c] : 0u;
      }
      __syncthreads();
    }
    load_a(As, m0, k0);
    decode(Bs, Ws, in_group / 32);
    __syncthreads();
    warp_stage<Op, R, 4>(As, Bs, acc, 16 * wm, 64, 32 * wn);
    __syncthreads();
  }
  for_each_acc<R, 4>(acc, m0 + 16 * wm, 64, n0 + 32 * wn, store);
}

}  // namespace mma
}  // namespace qt
