// The dtype probe's tiled matmul (P1) on the Hopper tile of wgmma_tile.cuh
// (TMA, wgmma, a warp-specialised ring): bf16 on its bf16 path, int8 and
// int4 on its s8 path.
//
// Replaces the Pallas kernel scripts/mxu_probe.py pallas_mm (pallas_call at
// :47): a plain tiled matmul, (M, K) @ (K, N) -> (M, N) f32 through an
// accumulator in the operands' accumulate type (bf16 -> f32, int8 and int4 ->
// int32), with no padding, so the shapes must divide the tiles. The TPU grid
// walks K sequentially with a VMEM scratch accumulator; here each block keeps
// its BM x BN accumulator in registers and walks K itself. At 4096^3 the
// work is 1.37e11 operations on 32-96 MB, so it is bound by the tensor
// cores' rate (989 TFLOP/s bf16, 1979 TOP/s int8; the data sheet gives no
// dense int4 rate), not by the bytes.
//
// bf16 (tiled_mm_kernel_wgmma): one producer thread keeps a 4-stage ring of
// TMA loads in flight, x (M, K) as K-major BM x 64 boxes and w (K, N) as
// 64 x 64 boxes read MN-major through the descriptor's transpose bit, both
// in the 128-byte swizzle; one or two consumer warpgroups run wgmma
// m64n128k16 on each stage (Bf16Tile: BM / 64 / CONSUMERS M-tiles and BN /
// 128 column tiles each, 64 or 128 f32 accumulators per thread; setmaxnreg
// gives the two-consumer tiles' consumers 232 registers and the producer
// 40).
//
// int8 and int4 (tiled_mm_kernel_s8): PTX wgmma takes .s8 operands only
// K-major and has no s4 type, and TMA cannot transpose bytes, so a
// transposer warpgroup writes B. Per stage of 128 k, TMA brings w's rows
// (128 k-rows x BN columns, MN-major; int4: 64 rows of packed pairs) into a
// staging slot, unswizzled; the transposer turns 4 x 4 byte blocks with
// __byte_perm (bank-conflict-free: each lane's column order is rotated, the
// selectors absorb it) and writes 16-byte chunks of 16 k at swizzle128(n,
// chunk) of the K-major B stage, then fences and arrives on the slot's full
// barrier; Bf16Tile's consumer warpgroups run m64n128k32 s8 products on
// the ring (S8Tile). int8 x arrives by TMA as
// K-major 128-byte boxes in the 128-byte swizzle, straight into the ring.
// int4 operands come packed two per byte, low nibble first: x (M, K/2)
// along K, w (K/2, N) along K (byte [kk, n] holds k = 2 kk and 2 kk + 1);
// x's stage (BM rows x 64 bytes) is staged beside w's, and the transposer
// sign-extends every nibble of both into a byte as it writes the s8 stages.
// The staging ring is shallower than the wgmma ring where shared memory
// runs short (S8Tile: 227 KB at most).
#include "cuda_error.cuh"
#include "wgmma_tile.cuh"

namespace {

// The bf16 tile's plan; kernels/common.py tiled_mm_bf16_plan is its mirror.
template <int BM, int BN>
struct Bf16Tile {
  static constexpr int CONSUMERS = BM >= 128 ? 2 : 1;  // warpgroups of wgmma
  static constexpr int MI = BM / 64 / CONSUMERS;        // 64-row tiles per consumer
  static constexpr int NI = BN / 128;                   // 128-column products per M-tile
  static constexpr int STAGES = 4;
  static constexpr int A_BYTES = BM * qt::wg::ROW_BYTES, B_BYTES = BN * qt::wg::ROW_BYTES;
  static constexpr int B_BOX_BYTES = 64 * qt::wg::ROW_BYTES;  // 64 k-rows x 64 columns
  static constexpr int SMEM = qt::wg::smem_bytes(BM, BN, STAGES, 0);
  static constexpr int THREADS = (CONSUMERS + 1) * qt::wg::WG_THREADS;
  static_assert(BM % 64 == 0 && BM / 64 % CONSUMERS == 0 && BN % 128 == 0);
  static_assert(BM <= 256 && SMEM <= qt::wg::SMEM_LIMIT, "a TMA box has at most 256 rows");
};

template <int BM, int BN>
__global__ void __launch_bounds__(Bf16Tile<BM, BN>::THREADS, 1)
tiled_mm_kernel_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, float* __restrict__ out, int N,
                      int K) {
  using T = Bf16Tile<BM, BN>;
  using namespace qt::wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align_atom(smem_raw);
  uint8_t* Bs = As + T::STAGES * T::A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + T::STAGES * T::B_BYTES);
  uint64_t* empty = full + T::STAGES;
  const int role = threadIdx.x / WG_THREADS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, stages = (K + STAGE_K - 1) / STAGE_K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * T::CONSUMERS);
    }
    bar_init_fence();
  }
  __syncthreads();
  if (role == T::CONSUMERS) {  // producer: one thread issues every load
    if constexpr (T::CONSUMERS == 2) reg_dealloc<40>();
    if (threadIdx.x % WG_THREADS == 0) {
      for (int s = 0; s < stages; ++s) {
        const int slot = s % T::STAGES;
        if (s >= T::STAGES) bar_wait(&empty[slot], (s / T::STAGES - 1) & 1);
        bar_arrive_tx(&full[slot], T::A_BYTES + T::B_BYTES);
        tma_load_2d(As + slot * T::A_BYTES, &xmap, &full[slot], STAGE_K * s, m0);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(Bs + slot * T::B_BYTES + b * T::B_BOX_BYTES, &wmap, &full[slot], n0 + 64 * b,
                      STAGE_K * s);
      }
    }
  } else {
    if constexpr (T::CONSUMERS == 2) reg_alloc<232>();
    float acc[T::MI][T::NI][64];
    const uint32_t a0 = smem_u32(As), b0 = smem_u32(Bs);
    consume<T::STAGES, T::MI, T::NI, 1>(
        acc, stages, full, empty,
        [&](int slot, int i, int ks) {
          return desc_sw128(a0 + slot * T::A_BYTES + (role * T::MI + i) * 64 * ROW_BYTES + 32 * ks,
                            16, ATOM_BYTES);
        },
        [&](int slot, int j, int ks) {
          return desc_sw128(b0 + slot * T::B_BYTES + j * 2 * T::B_BOX_BYTES + ks * 16 * ROW_BYTES,
                            T::B_BOX_BYTES, ATOM_BYTES);
        });
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j) {
        float* o = out + (size_t)(m0 + (role * T::MI + i) * 64) * N + n0 + j * 128;
        for_each_acc(acc[i][j], [&](int r, int c, float v0, float v1) {
          *reinterpret_cast<float2*>(o + (size_t)r * N + c) = make_float2(v0, v1);
        });
      }
  }
}

template <int BM, int BN>
cudaError_t launch_bf16_tile(const void* x, const void* w, float* out, int M, int N, int K,
                             int device, cudaStream_t s) {
  using T = Bf16Tile<BM, BN>;
  CUtensorMap xmap, wmap;
  cudaError_t err = qt::wg::tile_map(&xmap, 2, x, M, K, K, BM, 64);
  if (err == cudaSuccess) err = qt::wg::tile_map(&wmap, 2, w, K, N, N, 64, 64);
  static bool smem_set[16] = {};
  if (err == cudaSuccess)
    err = qt::wg::allow_smem(tiled_mm_kernel_wgmma<BM, BN>, T::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  tiled_mm_kernel_wgmma<BM, BN><<<dim3(N / BN, M / BM), T::THREADS, T::SMEM, s>>>(xmap, wmap, out,
                                                                                  N, K);
  return cudaGetLastError();
}

// bf16: K counts elements; x 16-byte aligned with K % 8 == 0 and w 16-byte
// aligned with N % 8 == 0 (TMA's rule for a base and a row pitch; the
// tilings' N % BN == 0 gives the latter).
cudaError_t launch_bf16(const void* x, const void* w, float* out, int M, int N, int K, int bm,
                        int bn, int device, cudaStream_t s) {
  if (M % bm || N % bn || K % 32 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch_bf16_tile<128, 128>(x, w, out, M, N, K, device, s);
  if (bm == 128 && bn == 256) return launch_bf16_tile<128, 256>(x, w, out, M, N, K, device, s);
  if (bm == 256 && bn == 128) return launch_bf16_tile<256, 128>(x, w, out, M, N, K, device, s);
  if (bm == 64 && bn == 128) return launch_bf16_tile<64, 128>(x, w, out, M, N, K, device, s);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of an s8 tile of bm + bn rows a stage with
// `stages` stages in the wgmma ring and `stg` staging slots of stg_bytes
// (and one mbarrier each).
constexpr int s8_smem(int bm, int bn, int stg_bytes, int stages, int stg) {
  return qt::wg::smem_bytes(bm, bn, stages, stg * (stg_bytes + 8));
}

// The s8 tile's plan; kernels/common.py tiled_mm_s8_plan is its mirror.
// Stages of 128 k: the wgmma ring holds STAGES of x (A, BM rows) and of
// the transposed w (B, BN rows), 128 bytes a row; the staging ring holds
// STG of w's rows as TMA brings them (int4: and x's packed rows). STAGES is
// 4 where two staging slots still fit, else 3; STG then as many as fit, at
// most 4. The consumers are Bf16Tile's: two warpgroups (one for BM = 64),
// each running MI x NI m64n128 products (64 or 128 int32 accumulators a
// thread, within the 168 registers of 384 threads), and one transposer
// warpgroup.
template <int BM, int BN, bool INT4>
struct S8Tile {
  static constexpr int STAGE_K = qt::wg::ROW_BYTES;           // k per stage
  static constexpr int CONSUMERS = BM >= 128 ? 2 : 1;           // warpgroups of wgmma
  static constexpr int MI = BM / 64 / CONSUMERS;               // 64-row tiles per consumer
  static constexpr int NI = BN / 128;                          // 128-column products per M-tile
  static constexpr int A_BYTES = BM * qt::wg::ROW_BYTES, B_BYTES = BN * qt::wg::ROW_BYTES;
  static constexpr int W_ROWS = INT4 ? STAGE_K / 2 : STAGE_K;  // w's rows per stage
  static constexpr int W_BYTES = W_ROWS * BN;
  static constexpr int X_BYTES = INT4 ? BM * STAGE_K / 2 : 0;  // int4: x's packed stage
  static constexpr int STG_BYTES = W_BYTES + X_BYTES;
  static constexpr int LIMIT = qt::wg::SMEM_LIMIT;
  static constexpr int STAGES = s8_smem(BM, BN, STG_BYTES, 4, 2) <= LIMIT ? 4 : 3;
  static constexpr int STG = s8_smem(BM, BN, STG_BYTES, STAGES, 4) <= LIMIT   ? 4
                             : s8_smem(BM, BN, STG_BYTES, STAGES, 3) <= LIMIT ? 3
                                                                              : 2;
  static constexpr int SMEM = s8_smem(BM, BN, STG_BYTES, STAGES, STG);
  static constexpr int THREADS = (CONSUMERS + 1) * qt::wg::WG_THREADS;
  static_assert(BM % 64 == 0 && BM / 64 % CONSUMERS == 0 && MI * NI <= 2 && BN % 128 == 0);
  static_assert(BM <= 256 && BN <= 256, "a TMA box has at most 256 rows");
  static_assert(SMEM <= LIMIT, "no such s8 tile");
};

// Four int8 bytes b of the 4 x 4 block rows L[0..3] (row j, byte i: column
// i) -> column c's four bytes, rows 0..3, as word c ^ rot, for the
// lane's rotation rot (0..3): the first level pairs rows (0, 1) and (2, 3)
// at the columns {2 (p ^ (rot / 2)), + 1} (selector s1[p]), the second
// takes a column of the pair (s2[h]).
struct Transpose4 {
  uint32_t s1[2], s2[2];
  __device__ __forceinline__ explicit Transpose4(int rot) {
    s1[0] = rot & 2 ? 0x7362u : 0x5140u;
    s1[1] = rot & 2 ? 0x5140u : 0x7362u;
    s2[0] = rot & 1 ? 0x7632u : 0x5410u;
    s2[1] = rot & 1 ? 0x5410u : 0x7632u;
  }
  __device__ __forceinline__ void operator()(uint32_t (&out)[4], const uint32_t (&L)[4]) const {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t t01 = __byte_perm(L[0], L[1], s1[p]), t23 = __byte_perm(L[2], L[3], s1[p]);
#pragma unroll
      for (int h = 0; h < 2; ++h) out[2 * p + h] = __byte_perm(t01, t23, s2[h]);
    }
  }
};

// Four bytes of eight packed int4 values (byte j: k = 2j low nibble, 2j + 1
// high) -> two words of their sign-extended bytes in k order: with each
// nibble's sign bit flipped, y = x ^ 8, the byte (y + 0x78) ^ 0x80 is x - 16
// for x >= 8 and x otherwise, and y + 0x78 < 0x100 carries nothing.
__device__ __forceinline__ uint2 int4_bytes(uint32_t v) {
  const uint32_t e = v ^ 0x88888888u;
  const uint32_t lo = ((e & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
  const uint32_t hi = (((e >> 4) & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
  return make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
}

// x: TMA map of int8 x (M x K) as K-major BM x 128 boxes in the 128-byte
// swizzle, or int4 (M x K/2 bytes) as BM x 64 boxes unswizzled; w: of w (K
// x N bytes; int4 K/2 x N) as W_ROWS x BN boxes unswizzled.
template <int BM, int BN, bool INT4>
__global__ void __launch_bounds__(S8Tile<BM, BN, INT4>::THREADS, 1)
tiled_mm_kernel_s8(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   float* __restrict__ out, int N, int K) {
  using T = S8Tile<BM, BN, INT4>;
  using namespace qt::wg;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* As = align_atom(smem_raw);
  uint8_t* Bs = As + T::STAGES * T::A_BYTES;
  uint8_t* Stg = Bs + T::STAGES * T::B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Stg + T::STG * T::STG_BYTES);
  uint64_t* empty = full + T::STAGES;
  uint64_t* landed = empty + T::STAGES;  // a staging slot's TMA bytes
  const int role = threadIdx.x / WG_THREADS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int stages = (K + T::STAGE_K - 1) / T::STAGE_K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      bar_init(&full[s], WG_THREADS + (INT4 ? 0 : 1));  // the transposers (and x's TMA bytes)
      bar_init(&empty[s], 4 * T::CONSUMERS);
    }
    for (int g = 0; g < T::STG; ++g) bar_init(&landed[g], 1);
    bar_init_fence();
  }
  __syncthreads();
  if (role == T::CONSUMERS) {  // the transposer warpgroup
    const int t = threadIdx.x % WG_THREADS;
    // stage s's staging loads into slot s % STG
    auto fetch = [&](int s) {
      const int g = s % T::STG;
      uint8_t* S = Stg + g * T::STG_BYTES;
      bar_arrive_tx(&landed[g], T::STG_BYTES);
      tma_load_2d(S, &wmap, &landed[g], n0, T::W_ROWS * s);
      if constexpr (INT4) tma_load_2d(S + T::W_BYTES, &xmap, &landed[g], T::STAGE_K / 2 * s, m0);
    };
    if (t == 0)
      for (int s = 0; s < T::STG && s < stages; ++s) fetch(s);
    // a unit is 4 columns (quad u) x 16 k (chunk c); the 32 lanes of a warp
    // take 32 neighbouring quads, so each row read is 128 contiguous bytes,
    // and lane u writes its columns in the order i ^ rot, so the 8 lanes of
    // a 16-byte store hit 8 distinct chunks of the swizzle
    const int rot = (t >> 1) & 3;
    const Transpose4 transpose(rot);
    constexpr int NB = BN / 128;  // groups of 32 quads
    // stage s: w's staging slot into B (int4: and x's into A)
    auto stage = [&](int s) {
      const int slot = s % T::STAGES, g = s % T::STG;
      bar_wait(&landed[g], (s / T::STG) & 1);
      if (s >= T::STAGES) bar_wait(&empty[slot], (s / T::STAGES - 1) & 1);
      if (!INT4 && t == 0) {
        bar_arrive_tx(&full[slot], T::A_BYTES);
        tma_load_2d(As + slot * T::A_BYTES, &xmap, &full[slot], T::STAGE_K * s, m0);
      }
      const uint8_t* W = Stg + g * T::STG_BYTES;
      uint8_t* B = Bs + slot * T::B_BYTES;
#pragma unroll
      for (int e = t; e < 8 * BN / 4; e += WG_THREADS) {
        const int u = 32 * ((e >> 5) % NB) + (e & 31), c = (e >> 5) / NB;
        uint32_t q[4][4];  // [word of the chunk][column i ^ rot]
        if constexpr (INT4) {  // k-rows 8c .. 8c + 7 of packed pairs
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t L[4], P[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              L[j] = *reinterpret_cast<const uint32_t*>(W + (8 * c + 4 * h + j) * BN + 4 * u);
            transpose(P, L);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const uint2 v = int4_bytes(P[i]);
              q[2 * h][i] = v.x;
              q[2 * h + 1][i] = v.y;
            }
          }
        } else {  // k-rows 16c + 4 h .. + 3
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            uint32_t L[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              L[j] = *reinterpret_cast<const uint32_t*>(W + (16 * c + 4 * h + j) * BN + 4 * u);
            transpose(q[h], L);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint4*>(B + swizzle128(4 * u + (i ^ rot), c)) =
              make_uint4(q[0][i], q[1][i], q[2][i], q[3][i]);
      }
      if constexpr (INT4) {  // x's packed rows: 16 bytes of row m -> chunks c, c + 1 of A's row m
        const uint8_t* X = W + T::W_BYTES;
        uint8_t* A = As + slot * T::A_BYTES;
#pragma unroll
        for (int e = t; e < 4 * BM; e += WG_THREADS) {
          const int m = e >> 2, c = 2 * (e & 3);
          const uint4 v = *reinterpret_cast<const uint4*>(X + m * (T::STAGE_K / 2) + 8 * c);
          const uint2 a = int4_bytes(v.x), b = int4_bytes(v.y), d = int4_bytes(v.z), f = int4_bytes(v.w);
          *reinterpret_cast<uint4*>(A + swizzle128(m, c)) = make_uint4(a.x, a.y, b.x, b.y);
          *reinterpret_cast<uint4*>(A + swizzle128(m, c + 1)) = make_uint4(d.x, d.y, f.x, f.y);
        }
      }
      fence_async_shared();
      bar_arrive(&full[slot]);
    };
    for (int s = 0; s < stages; ++s) {
      stage(s);
      named_sync(1, WG_THREADS);  // every transposer has read staging slot s % STG
      if (t == 0 && s + T::STG < stages) fetch(s + T::STG);
    }
  } else {  // consumer warpgroup `role`: M-tiles role MI .. + MI, all NI column tiles
    int32_t acc[T::MI][T::NI][64];
    const uint32_t a0 = smem_u32(As) + role * T::MI * 64 * ROW_BYTES, b0 = smem_u32(Bs);
    consume<T::STAGES, T::MI, T::NI, 0>(
        acc, stages, full, empty,
        [&](int slot, int i, int ks) {
          return desc_sw128(a0 + slot * T::A_BYTES + i * 64 * ROW_BYTES + 32 * ks, 16, ATOM_BYTES);
        },
        [&](int slot, int j, int ks) {
          return desc_sw128(b0 + slot * T::B_BYTES + j * 128 * ROW_BYTES + 32 * ks, 16, ATOM_BYTES);
        });
#pragma unroll
    for (int i = 0; i < T::MI; ++i)
#pragma unroll
      for (int j = 0; j < T::NI; ++j) {
        float* o = out + (size_t)(m0 + (role * T::MI + i) * 64) * N + n0 + j * 128;
        for_each_acc(acc[i][j], [&](int r, int c, int32_t v0, int32_t v1) {
          *reinterpret_cast<float2*>(o + (size_t)r * N + c) = make_float2((float)v0, (float)v1);
        });
      }
  }
}

template <int BM, int BN, bool INT4>
cudaError_t launch_s8_tile(const void* x, const void* w, float* out, int M, int N, int K,
                           int device, cudaStream_t s) {
  using T = S8Tile<BM, BN, INT4>;
  const int kb = INT4 ? K / 2 : K;  // bytes of k in a row of x, rows of w
  CUtensorMap xmap, wmap;
  cudaError_t err = INT4 ? qt::wg::tile_map(&xmap, 1, x, M, kb, kb, BM, T::STAGE_K / 2, false)
                         : qt::wg::tile_map(&xmap, 1, x, M, kb, kb, BM, T::STAGE_K);
  if (err == cudaSuccess) err = qt::wg::tile_map(&wmap, 1, w, kb, N, N, T::W_ROWS, BN, false);
  static bool smem_set[16] = {};
  if (err == cudaSuccess)
    err = qt::wg::allow_smem(tiled_mm_kernel_s8<BM, BN, INT4>, T::SMEM, device, smem_set);
  if (err != cudaSuccess) return err;
  tiled_mm_kernel_s8<BM, BN, INT4><<<dim3(N / BN, M / BM), T::THREADS, T::SMEM, s>>>(xmap, wmap,
                                                                                     out, N, K);
  return cudaGetLastError();
}

// int8 and int4: K counts elements, K % 64 == 0 (int4: % 128; TMA
// zero-fills a last stage that K does not fill); x and w 16-byte aligned
// (TMA's rule; the tilings give the row pitches K or K/2 and N a multiple of
// 16 bytes).
template <bool INT4>
cudaError_t launch_s8(const void* x, const void* w, float* out, int M, int N, int K, int bm,
                      int bn, int device, cudaStream_t s) {
  if (M % bm || N % bn || K % (INT4 ? 128 : 64) || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  if (bm == 128 && bn == 128) return launch_s8_tile<128, 128, INT4>(x, w, out, M, N, K, device, s);
  if (bm == 128 && bn == 256) return launch_s8_tile<128, 256, INT4>(x, w, out, M, N, K, device, s);
  if (bm == 256 && bn == 128) return launch_s8_tile<256, 128, INT4>(x, w, out, M, N, K, device, s);
  if (bm == 64 && bn == 128) return launch_s8_tile<64, 128, INT4>(x, w, out, M, N, K, device, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0: bf16 (x, w bf16); 1: int8; 2: int4 (packed two per byte), all on
// the wgmma tile. K counts elements.
extern "C" int qt_tiled_mm(const void* x, const void* w, void* out, int M, int N, int K, int dtype,
                           int bm, int bn, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bf16(x, w, static_cast<float*>(out), M, N, K, bm, bn, device, s);
    case 1: return (int)launch_s8<false>(x, w, static_cast<float*>(out), M, N, K, bm, bn, device, s);
    case 2: return (int)launch_s8<true>(x, w, static_cast<float*>(out), M, N, K, bm, bn, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
