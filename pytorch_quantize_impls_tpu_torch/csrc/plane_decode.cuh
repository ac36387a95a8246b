// The one-pass decode of grouped-planar packed weights (ops/pack.py) into
// centered int8 codes 2c - (2^BITS - 1), row-major (R F, N): the body of
// decode_binary_weights (K2, one bit: ±1, xnor_gemm.cu) and
// decode_dorefa_weights (K7, 1, 2 or 4 bits, dorefa_gemm.cu). Word (32 g +
// r, n) holds bit field i (i < F = 32 / BITS) of weight row 32 F g + 32 i +
// r, so every word feeds F output rows.
//
// An elementwise pass bound by device memory, and at the port's shapes
// (tens to hundreds of KB) by the launch itself: ~1.1 us of device time for
// the smallest launch on the H100 against a bytes bound of ~0.3 us. So each
// word is loaded once by each thread that needs it and each byte written
// once, in wide accesses: a thread takes a chunk of 4 neighbouring words
// of one packed row (one 16-byte load) and up to eight of their bit fields
// (Fields: all of them at four bits, one of two or four field octets at
// two or one bit, so a 1-bit weight spreads over four times the threads
// and SMs), and writes each field's 4 bytes with one 4-byte store.
// Neighbouring threads take neighbouring chunks, so every warp's loads and
// each of its stores cover contiguous bytes. Ragged or unaligned arrays
// (mode 1) take the same chunks with word loads and byte stores. A thread
// per chunk, on 32-bit indices (launch_decode refuses larger arrays).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "stream_tile.cuh"

namespace qt {
namespace planes {

constexpr int THREADS = 256;
constexpr int WIDTH = 4;  // words a chunk

// Bit fields of a word, those one thread writes, and the field octets.
template <int BITS>
struct Fields {
  static constexpr int F = 32 / BITS, PER = F < 8 ? F : 8, OCTETS = F / PER;
};

// The access mode: 4 (N % 4 == 0, wp 16-byte and out 4-byte aligned), else
// 1.
inline int decode_mode(const void* wp, const void* out, int N) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(wp), b = reinterpret_cast<uintptr_t>(out);
  return N % 4 == 0 && a % 16 == 0 && b % 4 == 0 ? 4 : 1;
}

template <int BITS>
__device__ __forceinline__ void decode_planes(const uint32_t* __restrict__ wp,
                                              int8_t* __restrict__ out, int R, int N, int mode) {
  using Fd = Fields<BITS>;
  constexpr int GROUP_K = Fd::F * stream::GROUP_ROWS;
  const unsigned chunks = (N + WIDTH - 1) / WIDTH;
  const unsigned it = blockIdx.x * blockDim.x + threadIdx.x;
  if (it >= (unsigned)R * chunks * Fd::OCTETS) return;
  const unsigned rest = it / chunks, row = rest / Fd::OCTETS;
  const int n0 = (int)(it % chunks) * WIDTH, f0 = (int)(rest % Fd::OCTETS) * Fd::PER;
  const unsigned g = row / stream::GROUP_ROWS, r = row % stream::GROUP_ROWS;
  const uint32_t* src = wp + (size_t)row * N + n0;
  // the output row of field f0 + i: dst + 32 i N
  int8_t* dst = out + ((size_t)g * GROUP_K + r + 32 * f0) * N + n0;
  uint32_t w[4];
  if (mode == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
#pragma unroll
    for (int i = 0; i < Fd::PER; ++i)
      *reinterpret_cast<uint32_t*>(dst + (size_t)i * 32 * N) = stream::field_bytes<BITS>(w, f0 + i);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = n0 + j < N ? __ldg(src + j) : 0u;
#pragma unroll
    for (int i = 0; i < Fd::PER; ++i) {
      const uint32_t o = stream::field_bytes<BITS>(w, f0 + i);
      for (int j = 0; j < 4 && n0 + j < N; ++j)
        dst[(size_t)i * 32 * N + j] = (int8_t)(o >> (8 * j));
    }
  }
}

// Launch kernel(wp, out, R, N, mode), a BITS-bit decode of R rows of N
// words on `stream`; refuses arrays past 32-bit thread indices.
template <int BITS, class Kernel>
inline cudaError_t launch_decode(Kernel kernel, const void* wp, void* out, int R, int N,
                                 cudaStream_t stream) {
  const size_t items = (size_t)R * ((N + WIDTH - 1) / WIDTH) * Fields<BITS>::OCTETS;
  if (items >= ((size_t)1 << 31)) return cudaErrorInvalidValue;
  const unsigned blocks = items ? (unsigned)((items + THREADS - 1) / THREADS) : 1;
  kernel<<<blocks, THREADS, 0, stream>>>(static_cast<const uint32_t*>(wp),
                                         static_cast<int8_t*>(out), R, N, decode_mode(wp, out, N));
  return cudaGetLastError();
}

}  // namespace planes
}  // namespace qt
