// qtpu_pack: host-side native codec for the packed-weight export format.
//
// Implements the SAME two layouts as pytorch_quantize_impls_tpu/ops/pack.py
// (the behavioral reference; parity is bit-exact and property-tested in
// tests/test_native.py):
//
//  * lane packing      — codes interleaved little-endian-in-bits along the
//    last dim, factor = 32/bits codes per uint32 word;
//  * grouped-planar    — the TPU-kernel layout: along axis -2, groups of
//    32 words cover group_k = 32*factor k-rows; word[g*32+r][n] holds code
//    codes[g*gk + i*32 + r][n] in bit field [bits*i, bits*(i+1)).
//
// Scope: deployment tooling (scripts/export_packed.py) packs trained
// checkpoints into serving artifacts on hosts with no accelerator; this
// native path keeps multi-GB exports fast. The reference repo has no native
// code at all (SURVEY.md §2 header) — this is new TPU-framework scope, not a
// port. Threaded with std::thread over rows; no dependencies beyond libc++.
//
// ABI: plain C, int32 codes, uint32 words, row-major contiguous buffers.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

int clamp_threads(int64_t rows) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  int64_t by_work = rows / 64 + 1;  // don't spawn threads for tiny jobs
  return static_cast<int>(std::min<int64_t>(hw, by_work));
}

// Run fn(row_begin, row_end) over [0, rows) on up to clamp_threads threads.
template <typename Fn>
void parallel_rows(int64_t rows, Fn fn) {
  int nt = clamp_threads(rows);
  if (nt <= 1) {
    fn(0, rows);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nt);
  int64_t chunk = (rows + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t b = t * chunk, e = std::min<int64_t>(rows, b + chunk);
    if (b >= e) break;
    ts.emplace_back(fn, b, e);
  }
  for (auto& t : ts) t.join();
}

bool bits_ok(int bits) {
  return bits == 1 || bits == 2 || bits == 4 || bits == 8;
}

constexpr int kGroupRows = 32;  // == ops.pack.GROUP_ROWS

}  // namespace

extern "C" {

// ---- lane packing (last-dim interleave) -----------------------------------
//
// codes:  [rows, n]       int32, values in [0, 2^bits)
// packed: [rows, ceil(n/f)] uint32, zero-padded tail codes
int qtpu_pack_lanes(const int32_t* codes, uint32_t* packed, int64_t rows,
                    int64_t n, int bits) {
  if (!bits_ok(bits)) return -1;
  const int f = 32 / bits;
  const int64_t pn = (n + f - 1) / f;
  parallel_rows(rows, [=](int64_t rb, int64_t re) {
    for (int64_t r = rb; r < re; ++r) {
      const int32_t* src = codes + r * n;
      uint32_t* dst = packed + r * pn;
      for (int64_t w = 0; w < pn; ++w) {
        uint32_t acc = 0;
        const int64_t base = w * f;
        const int m = static_cast<int>(std::min<int64_t>(f, n - base));
        for (int i = 0; i < m; ++i)
          acc |= static_cast<uint32_t>(src[base + i]) << (bits * i);
        dst[w] = acc;
      }
    }
  });
  return 0;
}

// packed: [rows, pn] uint32;  codes out: [rows, n] int32
int qtpu_unpack_lanes(const uint32_t* packed, int32_t* codes, int64_t rows,
                      int64_t n, int bits) {
  if (!bits_ok(bits)) return -1;
  const int f = 32 / bits;
  const int64_t pn = (n + f - 1) / f;
  const uint32_t mask = (bits == 32) ? ~0u : ((1u << bits) - 1u);
  parallel_rows(rows, [=](int64_t rb, int64_t re) {
    for (int64_t r = rb; r < re; ++r) {
      const uint32_t* src = packed + r * pn;
      int32_t* dst = codes + r * n;
      for (int64_t i = 0; i < n; ++i)
        dst[i] = static_cast<int32_t>((src[i / f] >> (bits * (i % f))) & mask);
    }
  });
  return 0;
}

// ---- grouped-planar packing (axis -2, the TPU-kernel layout) --------------
//
// codes:  [k, n] int32 (leading batch dims flattened into per-call loops by
//         the Python wrapper; 2-D is the only case the kernels use).
// packed: [ceil(k/gk)*32, n] uint32 where gk = 32 * (32/bits).
// K is zero-padded to a multiple of gk (matches ops.pack.pack_bitplanes).
int qtpu_pack_planar(const int32_t* codes, uint32_t* packed, int64_t k,
                     int64_t n, int bits) {
  if (!bits_ok(bits)) return -1;
  const int f = 32 / bits;
  const int64_t gk = static_cast<int64_t>(f) * kGroupRows;
  const int64_t groups = (k + gk - 1) / gk;
  // Parallelize over output word-rows: groups*32 of them, each independent.
  parallel_rows(groups * kGroupRows, [=](int64_t wb, int64_t we) {
    for (int64_t wrow = wb; wrow < we; ++wrow) {
      const int64_t g = wrow / kGroupRows;
      const int64_t r = wrow % kGroupRows;
      uint32_t* dst = packed + wrow * n;
      std::memset(dst, 0, sizeof(uint32_t) * n);
      for (int i = 0; i < f; ++i) {
        const int64_t krow = g * gk + static_cast<int64_t>(i) * kGroupRows + r;
        if (krow >= k) continue;  // zero-pad region
        const int32_t* src = codes + krow * n;
        const int sh = bits * i;
        for (int64_t c = 0; c < n; ++c)
          dst[c] |= static_cast<uint32_t>(src[c]) << sh;
      }
    }
  });
  return 0;
}

// packed: [groups*32, n] uint32;  codes out: [k, n] int32 (k <= groups*gk)
int qtpu_unpack_planar(const uint32_t* packed, int32_t* codes, int64_t k,
                       int64_t n, int bits) {
  if (!bits_ok(bits)) return -1;
  const int f = 32 / bits;
  const int64_t gk = static_cast<int64_t>(f) * kGroupRows;
  const uint32_t mask = (1u << bits) - 1u;
  parallel_rows(k, [=](int64_t kb, int64_t ke) {
    for (int64_t krow = kb; krow < ke; ++krow) {
      const int64_t g = krow / gk;
      const int64_t within = krow % gk;
      const int i = static_cast<int>(within / kGroupRows);
      const int64_t r = within % kGroupRows;
      const uint32_t* src = packed + (g * kGroupRows + r) * n;
      int32_t* dst = codes + krow * n;
      const int sh = bits * i;
      for (int64_t c = 0; c < n; ++c)
        dst[c] = static_cast<int32_t>((src[c] >> sh) & mask);
    }
  });
  return 0;
}

// ---- fused f32 -> binary codes (export hot path) --------------------------
//
// w >= 0 -> 1 else 0, then lane- or planar-pack, without materializing the
// intermediate int32 code tensor. w: [k, n] row-major f32.
int qtpu_pack_binary_planar(const float* w, uint32_t* packed, int64_t k,
                            int64_t n) {
  const int64_t gk = 32LL * kGroupRows;  // bits=1 -> f=32
  const int64_t groups = (k + gk - 1) / gk;
  parallel_rows(groups * kGroupRows, [=](int64_t wb, int64_t we) {
    for (int64_t wrow = wb; wrow < we; ++wrow) {
      const int64_t g = wrow / kGroupRows;
      const int64_t r = wrow % kGroupRows;
      uint32_t* dst = packed + wrow * n;
      std::memset(dst, 0, sizeof(uint32_t) * n);
      for (int i = 0; i < 32; ++i) {
        const int64_t krow = g * gk + static_cast<int64_t>(i) * kGroupRows + r;
        if (krow >= k) continue;
        const float* src = w + krow * n;
        for (int64_t c = 0; c < n; ++c)
          dst[c] |= static_cast<uint32_t>(src[c] >= 0.0f) << i;
      }
    }
  });
  return 0;
}

int qtpu_version() { return 1; }

}  // extern "C"
