// Warp-level tensor-core fragments (mma.sync) of the streamed GEMMs and conv
// (stream_tile.cuh: binary_gemm, dorefa_gemm, shift_gemm, int8_gemm,
// int8_conv2d). The weight-stationary GEMMs and the dtype probe's tiled
// matmul run on the Hopper tile of wgmma_tile.cuh instead.
//
// Shared memory holds both operands k-contiguous, one row per output row (A)
// or output column (B), STAGE_BYTES = 64 bytes of k per stage, each row
// padded to LDW = 20 words so that the eight rows a fragment load touches
// fall in distinct banks:
//   A[m][kb] = x[m0 + m, k0 + kb]      (byte kb of row m)
//   B[n][kb] = w[k0 + kb, n0 + n]      (the transpose: k runs along the row)
// One stage is two 32-byte k-steps. In bytes, a 32-byte k-step has the same
// fragment layout for both instructions used here (PTX ISA, "Matrix
// fragments for mma.m16n8k*"): with lane = 4 gid + tig,
//   A regs: (row gid, word tig) (row gid + 8, word tig) (row gid, word tig + 4)
//           (row gid + 8, word tig + 4)
//   B regs: (col gid, word tig) (col gid, word tig + 4)
//   C regs: (row gid, cols 2 tig, 2 tig + 1) (row gid + 8, the same cols)
// and a 32-bit word holds 4 int8 or 2 bf16 (lower k in the low half)
// consecutive k values.
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

// Four 8 x 8 matrices of 16-bit elements from shared memory: lanes 8 i ..
// 8 i + 7 give the addresses of matrix i's 8 rows (16 bytes each, 16-byte
// aligned); lane l gets the 32-bit word l % 4 of row l / 4 of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// One stage of a warp's MF x NF grid of 16 x 8 output fragments (the
// streamed schedule, stream_tile.cuh), the fragments loaded by ldmatrix:
// fragment (i, j) covers A rows arow0 + i * astep .. + 16 and B columns
// bcol0 + 8 j .. + 8 of the shared tiles As, Bs (LDW words per row). In
// 32-bit words, the A fragment of a 16-row tile is the four 8 x 4-word
// matrices (rows 0-7, words 0-3), (rows 8-15, words 0-3), (rows 0-7, words
// 4-7), (rows 8-15, words 4-7), and two B fragments are (columns 0-7 of
// fragment j, words 0-3), (words 4-7), and the same of fragment j + 1. One
// instruction per four registers; at LDW = 20 the eight rows of a matrix
// fall in distinct banks. NF is even.
template <class Op, int MF, int NF>
__device__ __forceinline__ void warp_stage_ldsm(const uint32_t* As, const uint32_t* Bs,
                                                typename Op::acc_t (&acc)[MF][NF][4], int arow0,
                                                int astep, int bcol0) {
  static_assert(NF % 2 == 0, "ldmatrix.x4 loads two B fragments");
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
  const uint32_t* a0 = As + (arow0 + (mi & 1) * 8 + r) * LDW + (mi >> 1) * 4;
  const uint32_t* b0 = Bs + (bcol0 + (mi >> 1) * 8 + r) * LDW + (mi & 1) * 4;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t b[NF][2];
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      uint32_t d[4];
      ldsm_x4(d, b0 + 8 * j * LDW + 8 * ks);
      b[j][0] = d[0];
      b[j][1] = d[1];
      b[j + 1][0] = d[2];
      b[j + 1][1] = d[3];
    }
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      uint32_t a[4];
      ldsm_x4(a, a0 + i * astep * LDW + 8 * ks);
#pragma unroll
      for (int j = 0; j < NF; ++j) Op::run(acc[i][j], a, b[j]);
    }
  }
}

// Calls f(row, col, value) for every accumulator element of warp_stage_ldsm's grid.
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

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

}  // namespace mma
}  // namespace qt
