// Shared cost primitive of the bin-packing kernels (every source in this
// directory, through binpack_rows.cuh), so the fitness, SA-delta and fused
// portfolio kernels can never drift apart arithmetically -- the role `kind_cost_block` plays for the Pallas
// kernels in src/repro/kernels/binpack_fitness/kernel.py.
//
//   cost(w, h, k) = weight[k] * min_m ceil(w / mode_w[k][m]) * ceil(h / mode_d[k][m])
//
// and 0 for an empty slot (w == 0) or a kind index outside the table.  All
// inputs are non-negative int32, so each ceil-division is exact in unsigned
// 32 bits (w + mode_w - 1 < 2^32) and far cheaper there than in 64 bits; the
// product is taken in 64 bits, so the result is exact for every int32
// geometry.
#pragma once

#include <cstdint>

#define RT_MAX_KINDS 4
#define RT_MAX_MODES 8

// RAM-kind mode tables, passed to every kernel by value (a few hundred bytes
// of kernel parameters), so a call needs no host-to-device copy for them.
// The homogeneous kernels use kind 0 with weight 1.  Must match the ctypes
// `KindTables` structure in src/repro_torch/kernels/build.py field for field.
struct KindTables {
  int32_t n_kinds;
  int32_t n_modes[RT_MAX_KINDS];
  int32_t weight[RT_MAX_KINDS];
  int32_t mode_w[RT_MAX_KINDS][RT_MAX_MODES];
  int32_t mode_d[RT_MAX_KINDS][RT_MAX_MODES];
};
static_assert(sizeof(KindTables) == 292, "KindTables layout changed: update build.py");

// The struct's size as this library sees it; the loader compares it with
// the ctypes structure's before the first launch.
extern "C" int kind_tables_bytes() { return static_cast<int>(sizeof(KindTables)); }

__device__ __forceinline__ long long kind_cost(int32_t w, int32_t h, int32_t k,
                                               const KindTables& t) {
  if (w <= 0 || k < 0 || k >= t.n_kinds) return 0;
  long long best = 0;
  for (int m = 0; m < t.n_modes[k]; ++m) {
    const uint32_t mw = static_cast<uint32_t>(t.mode_w[k][m]);
    const uint32_t md = static_cast<uint32_t>(t.mode_d[k][m]);
    const uint32_t cw = (static_cast<uint32_t>(w) + mw - 1u) / mw;
    const uint32_t ch = (static_cast<uint32_t>(h) + md - 1u) / md;
    const long long c = static_cast<long long>(cw) * ch;
    if (m == 0 || c < best) best = c;
  }
  return best * t.weight[k];
}
