// The dtype probe's tiled matmul (P1), on the tensor cores through mma.sync.
//
// Replaces the Pallas kernel scripts/mxu_probe.py pallas_mm (pallas_call at
// :47): a plain tiled matmul, (M, K) @ (K, N) -> (M, N) f32 through an
// accumulator in the operands' accumulate type (bf16 -> f32, int8 and int4 ->
// int32), with no padding, so the shapes must divide the tiles. The TPU grid
// walks K sequentially with a VMEM scratch accumulator; here each block keeps
// its BM x BN accumulator in registers and walks K itself
// (mma_tile.cuh: tiled_mm_kernel). At 4096^3 the work is 1.37e11 operations
// on 32-96 MB, so it is bound by the tensor cores' rate (989 TFLOP/s bf16,
// 1979 TOP/s int8; the data sheet gives no dense int4 rate), not by the
// bytes; mma.sync with unpipelined loads reaches only part of it (wgmma, TMA
// and a pipeline are later work). int4 operands come packed two per byte, low
// nibble first: x (M, K/2) along K, w (K/2, N) along K (byte [kk, n] holds
// k = 2 kk and 2 kk + 1), so in bytes they run as int8 does (EB = 1).
#include "mma_tile.cuh"

namespace {

using qt::mma::tiled_mm_kernel;

// KB: bytes of k per row of x.
template <class Op, int EB>
cudaError_t launch(const void* x, const void* w, void* out, int M, int N, int KB, int bm, int bn,
                   cudaStream_t s) {
  if (M % bm || N % bn || KB % qt::mma::STAGE_BYTES) return cudaErrorInvalidValue;
  const dim3 grid(N / bn, M / bm);
  const auto* xp = static_cast<const uint8_t*>(x);
  const auto* wq = static_cast<const uint8_t*>(w);
  auto* o = static_cast<float*>(out);
  if (bm == 128 && bn == 128) tiled_mm_kernel<Op, EB, 128, 128><<<grid, qt::mma::THREADS, 0, s>>>(xp, wq, o, M, N, KB);
  else if (bm == 128 && bn == 256) tiled_mm_kernel<Op, EB, 128, 256><<<grid, qt::mma::THREADS, 0, s>>>(xp, wq, o, M, N, KB);
  else if (bm == 256 && bn == 128) tiled_mm_kernel<Op, EB, 256, 128><<<grid, qt::mma::THREADS, 0, s>>>(xp, wq, o, M, N, KB);
  else if (bm == 64 && bn == 128) tiled_mm_kernel<Op, EB, 64, 128><<<grid, qt::mma::THREADS, 0, s>>>(xp, wq, o, M, N, KB);
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype 0: bf16 (x, w bf16); 1: int8; 2: int4 (packed two per byte). K
// counts elements.
extern "C" int qt_tiled_mm(const void* x, const void* w, void* out, int M, int N, int K, int dtype,
                           int bm, int bn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<qt::mma::BF16, 2>(x, w, out, M, N, 2 * K, bm, bn, s);
    case 1: return (int)launch<qt::mma::S8, 1>(x, w, out, M, N, K, bm, bn, s);
    case 2:
      if (K % 2) return (int)cudaErrorInvalidValue;
      return (int)launch<qt::mma::S4, 1>(x, w, out, M, N, K / 2, bm, bn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
