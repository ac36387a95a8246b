// Hopper GEMM tile: TMA loads, wgmma and a warp-specialised ring of
// shared-memory stages (sm_90a), over two operand types: bf16 x bf16 -> f32
// (m64n128k16) and s8 x s8 -> s32 (m64n128k32). The accumulator's type picks
// the instruction. Kernels on it: on the bf16 path the dtype probe's tiled
// matmul (P1 bf16, mxu_probe.cu) and the weight-stationary shift GEMM (K12,
// shift_gemm.cu); on the s8 path P1's int8 and int4 (mxu_probe.cu: a
// transposer warpgroup writes w K-major) and the weight-stationary packed
// GEMMs binary_gemm_ws (K10, xnor_gemm.cu) and dorefa_gemm_ws (K11,
// dorefa_gemm.cu), which share packed_ws.cuh's tile body.
//
// A stage holds 128 bytes of k (STAGE_K = 64 bf16, or 128 int8) for every
// row of the block's A tile (output rows, k contiguous) and of its B tile,
// each row 128 bytes in the
// 128-byte swizzle that TMA writes (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma
// reads: within an atom of 8 rows x 128 bytes (1024 bytes, 1024-aligned),
// the 16-byte chunk c of row r sits at r * 128 + ((c ^ r) * 16)
// (swizzle128 below; kernels/common.py swizzle128 is its Python mirror).
// Warpgroups (128 threads) take roles for the kernel's lifetime:
//   - one producer thread (P1 bf16), or a decoder or transposer warpgroup
//     (K10-K12, P1 int8/int4), waits until a slot is empty and issues its
//     TMA loads, which complete on the slot's "full" mbarrier with their
//     byte count; decoders and transposers also write B (and P1 int4's A)
//     into the slot and then arrive on the same barrier;
//   - consumer warpgroups wait until a slot is full, issue the stage's
//     wgmma.mma_async products (four k-steps of 32 bytes: m64n128k16 in
//     bf16, m64n128k32 in s8), keep one
//     stage's products in flight (wgmma.wait_group 1) and release the
//     previous slot on its "empty" mbarrier.
// The accumulators stay in registers for all of K, and every output is
// summed in one fixed order (no split over K, no atomics), so two launches
// give the same bits.
//
// Operand layouts for wgmma (PTX ISA, "Matrix Descriptor Format"; CUTLASS's
// canonical GMMA layouts, in 16-byte units T = 8 bf16):
//   K-major, 128B swizzle: ((8, m), (T, 2k)) : ((8T, SBO), (1, T)); SBO =
//     1024 bytes from one 8-row atom to the next; a k-step (16 bf16, 32
//     int8) moves the start address by 32 bytes inside the atom (the
//     hardware applies the swizzle to the final address). A always, and the
//     B that K10-K12 decode and P1 int8/int4 transpose. PTX allows no
//     transpose for .s8: both s8 operands are K-major.
//   MN-major, 128B swizzle: ((T, 8, m), (8, k)) : ((1, T, LBO), (8T, SBO));
//     one TMA box of 64 k-rows x 64 columns (8 KB) per atom column, LBO =
//     8192 bytes to the next 64 columns, SBO = 1024 bytes to the next 8
//     k-rows; a k-step moves the start by 16 rows (2048 bytes). P1's B = w
//     (K, N) row-major, with the descriptor's transpose bit.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace qt {
namespace wg {

constexpr int WG_THREADS = 128;       // threads per warpgroup
constexpr int STAGE_K = 64;           // bf16 k per stage
constexpr int ROW_BYTES = 128;        // one row of a stage: 64 bf16 or 128 int8, one swizzle span
constexpr int K_STEPS = 4;            // wgmma k-steps of 32 bytes per stage
constexpr int ATOM_BYTES = 1024;      // 8 rows x 128 bytes: the swizzle's period
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory a block may use (227 KB)

// Dynamic shared memory of a ring of `stages` stages with a_rows rows of A
// and b_rows rows of B each, plus `extra` bytes and two mbarriers per stage,
// and 1024 bytes of slack to align the first slot to the swizzle atom.
// kernels/common.py wgmma_smem_bytes is its mirror.
constexpr int smem_bytes(int a_rows, int b_rows, int stages, int extra) {
  return ATOM_BYTES + stages * (a_rows + b_rows) * ROW_BYTES + extra + 2 * stages * 8;
}

// Byte offset of the 16-byte chunk `chunk` (0..7) of row `row` of a tile of
// 128-byte rows in the 128-byte swizzle.
__host__ __device__ constexpr int swizzle128(int row, int chunk) {
  return row * ROW_BYTES + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint8_t* align_atom(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((ATOM_BYTES - (a & (ATOM_BYTES - 1))) & (ATOM_BYTES - 1));
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}

// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. Each try suspends
// the thread until the phase completes or WAIT_HINT_NS pass, so waiting
// warps take no issue slots from the warps they wait for (K12's decoder
// shares its SM sub-partitions with four consumer warps). A wait that never
// ends (a ring out of step) traps after WAIT_LIMIT_NS, so the launch fails
// with an error instead of holding the card.
constexpr uint32_t WAIT_HINT_NS = 1000000;
constexpr uint64_t WAIT_LIMIT_NS = 4000000000ull;
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity), "r"(WAIT_HINT_NS)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) start = now;
    else if (now - start > WAIT_LIMIT_NS) __trap();
  }
}

// --- TMA ---------------------------------------------------------------------

// Box (c0, c1) (innermost coordinate first) of the tensor map into dst; the
// bytes complete on `bar`. Elements outside the tensor read as zero.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Generic-proxy writes to shared memory (the decoders and transposers) made
// visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads') over `threads` threads:
// one warpgroup syncs its own warps, the others run on.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1); byte
// offsets lbo and sbo as the layouts above give them.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 64 accumulator registers of an m64n128 product, as asm operands %0 ..
// %63 with the constraint C ("+f" or "+r").
#define QT_WG_D64(C)                                                                             \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]), C(d[9]),     \
      C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]), C(d[18]), \
      C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), \
      C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]), C(d[36]), \
      C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]), C(d[43]), C(d[44]), C(d[45]), \
      C(d[46]), C(d[47]), C(d[48]), C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), \
      C(d[55]), C(d[56]), C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])
#define QT_WG_D64_LIST                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "            \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "            \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32, 64 registers a thread) += A (64 x 16, bf16) B (16 x
// 128, bf16), both from shared memory; TRANS_B = 1: B is MN-major.
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " QT_WG_D64_LIST
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : QT_WG_D64("+f")
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// d (64 x 128, s32, 64 registers a thread) += A (64 x 32, s8) B (32 x 128,
// s8), both K-major in shared memory; the int32 sums are exact.
__device__ __forceinline__ void mma_m64n128k32(int32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " QT_WG_D64_LIST
      ", %64, %65, p;\n}\n"
      : QT_WG_D64("+r")
      : "l"(da), "l"(db), "r"(1));
}

// One 32-byte k-step into the accumulator d: bf16 into f32, s8 into s32.
template <int TRANS_B>
__device__ __forceinline__ void mma_k_step(float (&d)[64], uint64_t da, uint64_t db) {
  mma_m64n128k16<TRANS_B>(d, da, db);
}
template <int TRANS_B>
__device__ __forceinline__ void mma_k_step(int32_t (&d)[64], uint64_t da, uint64_t db) {
  static_assert(TRANS_B == 0, "wgmma has no transpose for s8: B is K-major");
  mma_m64n128k32(d, da, db);
}

// Register budgets of a warpgroup (setmaxnreg): the producer gives back what
// the consumers take. Must sit at the top of a role's branch, which never
// rejoins the other's.
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The consumer warpgroup's side of the ring over `stages` stages: wait for
// slot s % STAGES, run its MI x NI m64n128 products of each 32-byte k-step
// (descriptors desc_a(slot, mi, ks), desc_b(slot, ni, ks); Acc float: bf16
// operands, int32_t: s8), keep one stage's products in flight, and release
// the previous slot with one arrival per warp (empty barriers count 4 per
// consumer warpgroup).
template <int STAGES, int MI, int NI, int TRANS_B, class Acc, class DescA, class DescB>
__device__ __forceinline__ void consume(Acc (&acc)[MI][NI][64], int stages, uint64_t* full,
                                        uint64_t* empty, DescA desc_a, DescB desc_b) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int c = 0; c < 64; ++c) acc[i][j][c] = 0;
      fence_acc(acc[i][j]);
    }
  const bool lead = (threadIdx.x & 31) == 0;
  for (int s = 0; s < stages; ++s) {
    const int slot = s % STAGES;
    bar_wait(&full[slot], (s / STAGES) & 1);
    mma_fence();
#pragma unroll
    for (int ks = 0; ks < K_STEPS; ++ks)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_k_step<TRANS_B>(acc[i][j], desc_a(slot, i, ks), desc_b(slot, j, ks));
    mma_commit();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) fence_acc(acc[i][j]);
    mma_wait<1>();
    if (s > 0 && lead) bar_arrive(&empty[(s - 1) % STAGES]);
  }
  mma_wait<0>();
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) fence_acc(acc[i][j]);
}

// f(row, col, v0, v1) for each pair of neighbouring columns (col, col + 1)
// of a warpgroup's m64n128 accumulator: warp w holds rows 16 w .. + 16,
// lane 4 g + t rows 16 w + g and + 8, columns 8 j + 2 t, + 1 (j < 16).
template <class Acc, class F>
__device__ __forceinline__ void for_each_acc(const Acc (&d)[64], F f) {
  const int t = threadIdx.x % WG_THREADS, lane = t & 31;
  const int r = 16 * (t >> 5) + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    f(r, 8 * j + c, d[4 * j], d[4 * j + 1]);
    f(r + 8, 8 * j + c, d[4 * j + 2], d[4 * j + 3]);
  }
}

// --- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so the library links nothing beyond the runtime.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a row-major matrix of bf16 (elem_bytes 2) or uint8
// (elem_bytes 1) elements (rows x cols, `pitch` elements from one row to
// the next; base 16-byte aligned, pitch * elem_bytes % 16 == 0), read in
// boxes of box_rows x box_cols (at most 256 each); swizzled: in the
// 128-byte swizzle (box_cols * elem_bytes = 128), else row after row as
// they are (box_cols * elem_bytes % 16 == 0). Elements outside the matrix
// read as zero.
inline cudaError_t tile_map(CUtensorMap* map, int elem_bytes, const void* base, int rows,
                            int cols, int pitch, int box_rows, int box_cols,
                            bool swizzled = true) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzled ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Set a kernel's dynamic shared-memory limit once per device.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int device, bool (&done)[16]) {
  if (device >= 0 && device < 16 && done[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < 16) done[device] = true;
  return err;
}

}  // namespace wg
}  // namespace qt
