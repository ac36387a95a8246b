// decode_attention: one-token attention over the int8-quantized KV cache.
//
//   q (B, H, HD) f32; k/v codes (B, H, CL, HD) int8; k/v scales (B, H, CL) f32;
//   mask bias (B, CL) f32, 0 where a position may be attended, -1e30 where not.
//   s_j   = (q . k_j) * k_scale_j * rsqrt(HD) + bias_j
//   p_j   = exp(s_j - max_j s_j)
//   out   = (sum_j (p_j * v_scale_j) * v_j) / sum_j p_j          (B, H, HD) f32
//
// Replaces the Pallas kernel pytorch_quantize_impls_tpu/kernels/decode_attention.py
// decode_attention (pallas_call at :113), the s == 1 attention of the fused
// decode step (infer/fused_decode.py). The dequantization scales fold into the
// score and probability vectors, so the cache is never dequantized to a copy.
//
// Bound: device-memory bytes. Each (b, h) reads its CL x HD code rows twice
// over (K, then V) and does 4 flops per code byte, far below the ~590 int8
// or f32 operations per byte at which the H100's compute would bind. At the
// serving model's b = 32, h = 8, CL = 1024, HD = 128 a full cache is 64 MiB of
// codes, about 21 us at 3.35 TB/s.
//
// Design (simple first): one block of 256 threads per (b, h); the grid is B*H
// blocks, so at b = 1 only H = 8 of the 132 SMs work (a split over CL with an
// online-softmax combine is later work). The bias row is staged in shared
// memory as the initial scores. Each lane loads 16 codes (one int4) of a row,
// HD/16 lanes cover a row and a warp covers 32/(HD/16) rows per load; every
// lane keeps U = 4 loads in flight. Rows that the mask excludes (bias <=
// -1e30) are not read: their score stays the bias, which is the plain
// formula's value to the last bit whenever |q.k * k_scale * rsqrt(HD)| is
// below half an ulp of 1e30 (~3.8e22). V rows whose probability is exactly 0
// are skipped too. So the kernel reads only the cache a slot has written.
// Subnormal p are flushed to 0, as XLA computes them on the CPU and the TPU
// (a context that is exactly 0 there must not pick up subnormal terms here,
// since a sign is taken on it). Scores and probabilities stay in shared
// memory (CL floats); reductions are warp shuffles and a fixed-order pass
// over the warps' partial sums, with no atomics, so two runs give the same
// bits. Everything is f32.
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int U = 4;  // row loads in flight per lane
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// 16 int8 codes packed in an int4 -> floats, lowest address first
__device__ __forceinline__ void unpack16(const int4& w, float (&c)[16]) {
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[4 * i + j] = (float)((int)((unsigned)words[i] << (24 - 8 * j)) >> 24);
}

// Block-wide max or sum; every thread gets the result, combined in one fixed
// order. `scratch` holds NWARPS floats and is free again on return.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(FULL, v, o);
    v = IS_MAX ? fmaxf(v, other) : v + other;
  }
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < NWARPS; ++w) r = IS_MAX ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();
  return r;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                        const float* __restrict__ ks, const int8_t* __restrict__ vc,
                        const float* __restrict__ vs, const float* __restrict__ bias,
                        float* __restrict__ out, int H, int CL) {
  constexpr int LPR = HD / 16;  // lanes per cache row
  constexpr int R = 32 / LPR;   // rows per warp load
  constexpr int STEP = NWARPS * R * U;
  extern __shared__ float smem[];
  float* s = smem;         // CL scores, then probabilities
  float* red = smem + CL;  // NWARPS x HD partial contexts; reduction scratch

  const int bh = blockIdx.x, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPR, rsub = lane / LPR;
  const size_t row0 = (size_t)bh * CL;  // first cache row of this (b, h)

  for (int j = threadIdx.x; j < CL; j += THREADS) s[j] = bias[(size_t)b * CL + j];
  float qr[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qr[i] = q[(size_t)bh * HD + sub * 16 + i];
  const float rs = rsqrtf((float)HD);
  __syncthreads();

  // scores: s_j = (q . k_j) * k_scale_j * rsqrt(HD) + bias_j on live rows
  for (int j0 = warp * R * U; j0 < CL; j0 += STEP) {
    int4 w[U];
    float sc[U];
    int j[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      j[u] = j0 + u * R + rsub;
      live[u] = j[u] < CL && s[j[u]] > MASKED;
      w[u] = make_int4(0, 0, 0, 0);
      sc[u] = 0.f;
      if (live[u]) {
        w[u] = *reinterpret_cast<const int4*>(kc + (row0 + j[u]) * HD + sub * 16);
        sc[u] = ks[row0 + j[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float c[16];
      unpack16(w[u], c);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) dot = fmaf(qr[i], c[i], dot);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
      if (live[u] && sub == 0) s[j[u]] = dot * sc[u] * rs + s[j[u]];
    }
  }
  __syncthreads();

  // stable softmax numerator in place, and its sum
  float m = -INFINITY;
  for (int j = threadIdx.x; j < CL; j += THREADS) m = fmaxf(m, s[j]);
  m = block_reduce<true>(m, red);
  float sum = 0.f;
  for (int j = threadIdx.x; j < CL; j += THREADS) {
    float p = expf(s[j] - m);
    p = p < FLT_MIN ? 0.f : p;  // flush subnormals, as XLA does
    s[j] = p;
    sum += p;
  }
  const float denom = block_reduce<false>(sum, red);  // its barrier publishes s

  // context: sum_j (p_j * v_scale_j) * v_j over rows with p_j != 0
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int j0 = warp * R * U; j0 < CL; j0 += STEP) {
    int4 w[U];
    float pv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * R + rsub;
      w[u] = make_int4(0, 0, 0, 0);
      pv[u] = 0.f;
      if (j < CL && s[j] != 0.f) {
        w[u] = *reinterpret_cast<const int4*>(vc + (row0 + j) * HD + sub * 16);
        pv[u] = s[j] * vs[row0 + j];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float c[16];
      unpack16(w[u], c);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(pv[u], c[i], acc[i]);
    }
  }
  // lanes with the same `sub` hold the same 16 dims of different rows
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += __shfl_xor_sync(FULL, acc[i], o);
  if (rsub == 0)
#pragma unroll
    for (int i = 0; i < 16; ++i) red[warp * HD + sub * 16 + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) c += red[w * HD + d];
    out[(size_t)bh * HD + d] = c / denom;
  }
}

template <int HD>
cudaError_t launch(const float* q, const int8_t* kc, const float* ks, const int8_t* vc,
                   const float* vs, const float* bias, float* out, int B, int H, int CL,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)CL + (size_t)NWARPS * HD);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  decode_attention_kernel<HD><<<B * H, THREADS, smem, stream>>>(q, kc, ks, vc, vs, bias, out, H, CL);
  return cudaGetLastError();
}

}  // namespace

// HD must be one of 16, 32, 64, 128, 256 and the code tensors 16-byte
// aligned (the wrapper checks both); returns a CUDA error code.
extern "C" int qt_decode_attention(const void* q, const void* kc, const void* ks, const void* vc,
                                   const void* vs, const void* bias, void* out, int B, int H,
                                   int CL, int HD, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* q_ = static_cast<const float*>(q);
  const auto* kc_ = static_cast<const int8_t*>(kc);
  const auto* ks_ = static_cast<const float*>(ks);
  const auto* vc_ = static_cast<const int8_t*>(vc);
  const auto* vs_ = static_cast<const float*>(vs);
  const auto* bias_ = static_cast<const float*>(bias);
  auto* out_ = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: err = launch<16>(q_, kc_, ks_, vc_, vs_, bias_, out_, B, H, CL, st); break;
    case 32: err = launch<32>(q_, kc_, ks_, vc_, vs_, bias_, out_, B, H, CL, st); break;
    case 64: err = launch<64>(q_, kc_, ks_, vc_, vs_, bias_, out_, B, H, CL, st); break;
    case 128: err = launch<128>(q_, kc_, ks_, vc_, vs_, bias_, out_, B, H, CL, st); break;
    case 256: err = launch<256>(q_, kc_, ks_, vc_, vs_, bias_, out_, B, H, CL, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
