// Hopper bf16 x bf16 -> f32 GEMM tile: TMA loads, wgmma and a
// warp-specialised ring of shared-memory stages (sm_90a). Two kernels run on
// it: the bf16 path of the dtype probe's tiled matmul (P1, mxu_probe.cu) and
// the weight-stationary shift GEMM (K12, shift_gemm.cu).
//
// A stage holds STAGE_K = 64 bf16 of k for every row of the block's A tile
// (output rows, k contiguous) and of its B tile, each row 128 bytes in the
// 128-byte swizzle that TMA writes (CU_TENSOR_MAP_SWIZZLE_128B) and wgmma
// reads: within an atom of 8 rows x 128 bytes (1024 bytes, 1024-aligned),
// the 16-byte chunk c of row r sits at r * 128 + ((c ^ r) * 16)
// (swizzle128 below; kernels/common.py swizzle128 is its Python mirror).
// Warpgroups (128 threads) take roles for the kernel's lifetime:
//   - one producer thread (P1), or K12's decoder warpgroup, waits until a
//     slot is empty and issues its TMA loads, which complete on the slot's
//     "full" mbarrier with their byte count; K12's decoders also write the
//     decoded B into the slot and then arrive on the same barrier;
//   - consumer warpgroups wait until a slot is full, issue the stage's
//     wgmma.mma_async m64n128k16 products (four 16-deep k-steps), keep one
//     stage's products in flight (wgmma.wait_group 1) and release the
//     previous slot on its "empty" mbarrier.
// The f32 accumulators stay in registers for all of K, and every output is
// summed in one fixed order (no split over K, no atomics), so two launches
// give the same bits.
//
// Operand layouts for wgmma (PTX ISA, "Matrix Descriptor Format"; CUTLASS's
// canonical GMMA layouts, in 16-byte units T = 8 bf16):
//   K-major, 128B swizzle: ((8, m), (T, 2k)) : ((8T, SBO), (1, T)); SBO =
//     1024 bytes from one 8-row atom to the next; a 16-deep k-step moves the
//     start address by 32 bytes inside the atom (the hardware applies the
//     swizzle to the final address). A always, and K12's decoded B.
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
constexpr int ROW_BYTES = 128;        // one row of a stage: 64 bf16, one swizzle span
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

// Generic-proxy writes to shared memory (K12's decoder) made visible to the
// async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// d (64 x 128, f32, 64 registers a thread) += A (64 x 16, bf16) B (16 x
// 128, bf16), both from shared memory; TRANS_B = 1: B is MN-major.
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
    "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
    "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
    "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
    "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
    "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
      "+f"(d[63])
    : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
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
// slot s % STAGES, run its MI x NI m64n128k16 products of each 16-deep
// k-step (descriptors desc_a(slot, mi, ks), desc_b(slot, ni, ks)), keep one
// stage's products in flight, and release the previous slot with one
// arrival per warp (empty barriers count 4 per consumer warpgroup).
template <int STAGES, int MI, int NI, int TRANS_B, class DescA, class DescB>
__device__ __forceinline__ void consume(float (&acc)[MI][NI][64], int stages, uint64_t* full,
                                        uint64_t* empty, DescA desc_a, DescB desc_b) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
#pragma unroll
      for (int c = 0; c < 64; ++c) acc[i][j][c] = 0.0f;
      fence_acc(acc[i][j]);
    }
  const bool lead = (threadIdx.x & 31) == 0;
  for (int s = 0; s < stages; ++s) {
    const int slot = s % STAGES;
    bar_wait(&full[slot], (s / STAGES) & 1);
    mma_fence();
#pragma unroll
    for (int ks = 0; ks < STAGE_K / 16; ++ks)
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_m64n128k16<TRANS_B>(acc[i][j], desc_a(slot, i, ks), desc_b(slot, j, ks));
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
template <class F>
__device__ __forceinline__ void for_each_acc(const float (&d)[64], F f) {
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

// Tensor map of a row-major bf16 matrix (rows x cols, `pitch` elements from
// one row to the next; base 16-byte aligned, pitch % 8 == 0), read in boxes
// of box_rows x box_cols (box_cols * 2 = 128 bytes) in the 128-byte swizzle;
// elements outside the matrix read as zero.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int pitch,
                            int box_rows, int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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
