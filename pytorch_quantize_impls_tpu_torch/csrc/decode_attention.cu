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
// codes, about 21 us at 3.35 TB/s; at the engine's cursors (17-160 live rows)
// the live rows are a tenth of that, and what costs is the chain of dependent
// loads and barriers each (b, h) walks, and the instructions spent on rows
// that are not live, not bytes.
//
// Design: one launch, a thread-block cluster of C blocks per (b, h), split
// over CL (kernels/common.py attention_plan sets C and the rows each block
// owns; the wrapper passes them in).
// - The cache is cut into load rounds of ROWS rows (16 codes, one int4, per
//   lane; HD/16 lanes to a row). Rank r of a cluster owns rounds r, r + C,
//   r + 2C, ..., so the cluster's first rounds cover the head of the cache,
//   where the engine's live rows are. A pass keeps U = 4 rounds in flight.
// - Each block stages its rows' bias in shared memory as the initial scores,
//   notes its last round with a live row, and scores the live rows only; a
//   round with no live row in a warp costs a vote. Rows that the mask
//   excludes (bias <= -1e30) are not read: their score stays the bias, which
//   is the plain formula's value to the last bit whenever |q.k * k_scale *
//   rsqrt(HD)| is below half an ulp of 1e30 (~3.8e22).
// - The global max goes through distributed shared memory: each warp leaves
//   its max, a cluster barrier, and every warp reads all C x 8 maxima. A max
//   does not depend on order, so every block holds the row max M to the last
//   bit.
// - p_j = exp(s_j - M) with the global M, flushed to 0 below FLT_MIN, as XLA
//   computes it on the CPU and the TPU (a context that is exactly 0 there
//   must not pick up subnormal terms here, since a sign is taken on it; so
//   no chunk-local max rescales anything). A masked row has p = 0 once M >
//   -1e30, without the exp (the same bits). Each block sums its p and its
//   partial context over rows with p != 0; a fully masked row has p = 1 on
//   every position, and its context is the mean of v_scale * v over all CL.
// - Each block writes its (sum p, partial context) into the blocks that
//   combine them (rank r owns output dimensions [r HD / C, (r + 1) HD / C));
//   after a second cluster barrier, rank r sums the C partials in rank order
//   from its own shared memory and writes its dimensions. No block reads
//   another's shared memory after the second barrier (the maxima were read
//   before it), so no third barrier is needed before a block exits.
// Reductions are warp shuffles and fixed-order passes, with no atomics, so
// two runs give the same bits. Everything is f32. The launch bounds hold a
// thread to 64 registers, so that four blocks share an SM: at b = 32 the
// default plan's 512 blocks then run in one wave.
#include <cfloat>
#include <cmath>
#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "cuda_error.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int U = 4;             // rounds in flight per pass
constexpr int MIN_BLOCKS = 4;    // blocks an SM: 64 registers a thread
constexpr int MAX_CLUSTER = 16;  // blocks per (b, h), at most
// floats in shared memory beside the contexts and scores: the cluster's
// block sums (MAX_CLUSTER); this block's warp maxima, warp sums, maxima over
// masked rows and last live rounds (NWARPS each)
constexpr int SCALARS = MAX_CLUSTER + 4 * NWARPS;
constexpr int SMEM_LIMIT = 232448;             // dynamic shared memory one block may use on the H100
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory of a block that owns `chunk` rows (kernels/common.py
// attention_smem_bytes), in floats: NWARPS x HD warp contexts, the C
// partial contexts of this block's HD / C dimensions (HD), SCALARS, `chunk`
// scores.
constexpr size_t smem_bytes(int hd, int chunk) {
  return sizeof(float) * ((size_t)(NWARPS + 1) * hd + SCALARS + (size_t)chunk);
}

// 16 int8 codes packed in an int4 -> floats, lowest address first
__device__ __forceinline__ void unpack16(const int4& w, float (&c)[16]) {
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[4 * i + j] = (float)((int)((unsigned)words[i] << (24 - 8 * j)) >> 24);
}

// The cluster barrier in two halves (every thread of every block reaches
// both): arrive releases this thread's earlier memory accesses to the
// cluster, wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int HD>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
decode_attention_kernel(const float* __restrict__ q, const int8_t* __restrict__ kc,
                        const float* __restrict__ ks, const int8_t* __restrict__ vc,
                        const float* __restrict__ vs, const float* __restrict__ bias,
                        float* __restrict__ out, int H, int CL, int chunk) {
  constexpr int LPR = HD / 16;      // lanes per cache row
  constexpr int R = 32 / LPR;       // rows per warp load
  constexpr int ROWS = NWARPS * R;  // rows of one load round of the block
  extern __shared__ float smem[];
  float* red = smem;                // NWARPS x HD
  float* comb = red + NWARPS * HD;  // C x HD / C, from each rank
  float* csum = comb + HD;          // MAX_CLUSTER, from each rank
  float* wmax = csum + MAX_CLUSTER; // NWARPS each:
  float* wsum = wmax + NWARPS;
  float* wmasked = wsum + NWARPS;
  int* wlast = reinterpret_cast<int*>(wmasked + NWARPS);
  float* s = smem + (NWARPS + 1) * HD + SCALARS;  // chunk scores

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / C, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % LPR, rsub = lane / LPR;
  const int slot = warp * R + rsub;     // this lane's row within a round
  const size_t row0 = (size_t)bh * CL;  // first cache row of this (b, h)
  const int rounds = chunk / ROWS;
  // cache row of slot `sl` of this block's round k
  const auto pos = [&](int k, int sl) { return (k * C + rank) * ROWS + sl; };

  // stage the bias; note the last round with a live row and the max over
  // the masked rows
  int last = -1;
  float mm = -INFINITY;
  for (int i = threadIdx.x; i < chunk; i += THREADS) {
    const int j = pos(i / ROWS, i % ROWS);
    const float v = j < CL ? bias[(size_t)b * CL + j] : -INFINITY;  // -inf: no such position
    s[i] = v;
    if (v > MASKED) last = i / ROWS;
    else mm = fmaxf(mm, v);
  }
  float qr[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) qr[i] = q[(size_t)bh * HD + sub * 16 + i];
  const float rs = rsqrtf((float)HD);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    last = max(last, __shfl_xor_sync(FULL, last, o));
    mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, o));
  }
  if (lane == 0) {
    wlast[warp] = last;
    wmasked[warp] = mm;
  }
  __syncthreads();
  float m = -INFINITY;  // this lane's max: the masked rows', then its live scores
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    last = max(last, wlast[w]);
    m = fmaxf(m, wmasked[w]);
  }
  const int live_rounds = last + 1;

  // scores s_i = (q . k_j) * k_scale_j * rsqrt(HD) + bias_j on live rows
  for (int k0 = 0; k0 < live_rounds; k0 += U) {
    int4 w[U];
    float sc[U], sb[U];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sb[u] = k0 + u < rounds ? s[(k0 + u) * ROWS + slot] : -INFINITY;
      live[u] = sb[u] > MASKED;
      w[u] = make_int4(0, 0, 0, 0);
      sc[u] = 0.f;
      if (live[u]) {
        const size_t row = row0 + pos(k0 + u, slot);
        w[u] = *reinterpret_cast<const int4*>(kc + row * HD + sub * 16);
        sc[u] = ks[row];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!__any_sync(FULL, live[u])) continue;  // a round with no live row costs nothing more
      float c[16];
      unpack16(w[u], c);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) dot = fmaf(qr[k], c[k], dot);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(FULL, dot, o);
      if (live[u]) {
        const float si = dot * sc[u] * rs + sb[u];
        if (sub == 0) s[(k0 + u) * ROWS + slot] = si;
        m = fmaxf(m, si);
      }
    }
  }

  // the row max over the cluster, through distributed shared memory (read
  // only after the first barrier: then every block of the cluster has started)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  if (lane == 0) wmax[warp] = m;
  cluster_arrive();
  cluster_wait();
  float M = -INFINITY;
  for (int k = lane; k < C * NWARPS; k += 32)
    M = fmaxf(M, *cluster.map_shared_rank(wmax + k % NWARPS, k / NWARPS));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
  // A score <= -1e30 has p = 0 once M > -1e30: s - M is below -7e22, and exp
  // of that is 0. Only a fully masked row needs the rounds past the last live one.
  const bool row_masked = !(M > MASKED);
  const int p_rounds = row_masked ? rounds : live_rounds;

  // p = exp(s - M), flushed; sum p and sum_j (p_j * v_scale_j) * v_j over p_j != 0
  float acc[16], psum = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.f;
  for (int k0 = 0; k0 < p_rounds; k0 += U) {
    int4 w[U];
    float pv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = k0 + u < rounds ? pos(k0 + u, slot) : CL;
      float p = 0.f;
      if (j < CL) {
        const float sv = s[(k0 + u) * ROWS + slot];
        if (sv > MASKED || row_masked) {
          p = expf(sv - M);
          p = p < FLT_MIN ? 0.f : p;  // flush subnormals, as XLA does
        }
      }
      if (sub == 0) psum += p;  // each row once
      w[u] = make_int4(0, 0, 0, 0);
      pv[u] = 0.f;
      if (p != 0.f) {
        const size_t row = row0 + j;
        w[u] = *reinterpret_cast<const int4*>(vc + row * HD + sub * 16);
        pv[u] = p * vs[row];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!__any_sync(FULL, pv[u] != 0.f)) continue;
      float c[16];
      unpack16(w[u], c);
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = fmaf(pv[u], c[k], acc[k]);
    }
  }
  // lanes with the same `sub` hold the same 16 dims of different rows
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(FULL, psum, o);
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] += __shfl_xor_sync(FULL, acc[k], o);
  if (rsub == 0)
#pragma unroll
    for (int k = 0; k < 16; ++k) red[warp * HD + sub * 16 + k] = acc[k];
  if (lane == 0) wsum[warp] = psum;
  __syncthreads();
  // this block's partials into the ranks that combine them (every block has
  // started: the first barrier is behind), dimension d to rank d / (HD / C),
  // the sum p to every rank
  const int per = HD / C;
  for (int d = threadIdx.x; d < HD; d += THREADS) {
    float c = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) c += red[w * HD + d];
    *cluster.map_shared_rank(comb + rank * per + d % per, d / per) = c;
  }
  if (threadIdx.x < C) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) t += wsum[w];
    *cluster.map_shared_rank(csum + rank, threadIdx.x) = t;
  }
  cluster_arrive();
  cluster_wait();

  // rank r sums the C partials of its HD / C dimensions in rank order
  if (threadIdx.x < per) {
    float den = 0.f, ctx = 0.f;
    for (int c = 0; c < C; ++c) {
      den += csum[c];
      ctx += comb[c * per + threadIdx.x];
    }
    out[(size_t)bh * HD + rank * per + threadIdx.x] = ctx / den;
  }
}

template <int HD>
cudaError_t launch(const float* q, const int8_t* kc, const float* ks, const int8_t* vc,
                   const float* vs, const float* bias, float* out, int B, int H, int CL, int C,
                   int chunk, int smem, cudaStream_t stream) {
  constexpr int ROWS = NWARPS * 32 / (HD / 16);
  if (chunk <= 0 || chunk % ROWS || (long long)C * chunk < CL ||
      (size_t)smem != smem_bytes(HD, chunk) || smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  const auto kernel = decode_attention_kernel<HD>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  if (C > 8) {  // 16: beyond the portable cluster size
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = (unsigned)C;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * C));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, kc, ks, vc, vs, bias, out, H, CL, chunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// HD must be one of 16, 32, 64, 128, 256 and the code tensors 16-byte
// aligned (the wrapper checks both); C (one of 1, 2, 4, 8, 16), chunk and
// smem are kernels/common.py attention_plan's, checked here against the
// layout. Returns a CUDA error code.
extern "C" int qt_decode_attention(const void* q, const void* kc, const void* ks, const void* vc,
                                   const void* vs, const void* bias, void* out, int B, int H,
                                   int CL, int HD, int C, int chunk, int smem, int device,
                                   void* stream) {
  if (C != 1 && C != 2 && C != 4 && C != 8 && C != 16) return (int)cudaErrorInvalidValue;
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
#define QT_LAUNCH(D) \
  launch<D>(q_, kc_, ks_, vc_, vs_, bias_, out_, B, H, CL, C, chunk, smem, st)
  switch (HD) {
    case 16: err = QT_LAUNCH(16); break;
    case 32: err = QT_LAUNCH(32); break;
    case 64: err = QT_LAUNCH(64); break;
    case 128: err = QT_LAUNCH(128); break;
    case 256: err = QT_LAUNCH(256); break;
    default: err = cudaErrorInvalidValue;
  }
#undef QT_LAUNCH
  return (int)err;
}
