// The slot cost and the GA row body of the bin-packing kernels.
// `fitness_slot_cost` is the one device body of the slot cost
// (`kind_cost_block`'s role in src/repro/kernels/binpack_fitness/kernel.py):
// K1 / K2 (binpack_fitness.cu), K3 / K4 (binpack_sa_step.cu) and both roles
// of K5 (binpack_portfolio_step.cu) call it; `fitness_row` is the GA row
// body, one 1024-thread block summing one population row, for K1 / K2 and
// K5's GA role.
//
//   cost(w, h, k) = weight[k] * min_m ceil(w / mode_w[k][m]) * ceil(h / mode_d[k][m])
//
// and 0 for an empty slot (w == 0), for h == 0 (every mode gives 0) and for
// a kind index outside the table.  Domain: w, h >= 0 (int32); a slot with
// w > 0 and h < 0 is outside it (skipped here as empty; the plain versions
// floor-divide), and the engines never make one
// (tests/test_torch_kernel_domain.py).
//
//   * One 1024-thread block per row, a thread owning 4 slots of each
//     4096-slot pass (neighbouring threads on neighbouring words).  A thread
//     issues its 4 width loads at once, then the heights (and kinds) of its
//     live slots, then computes; an empty slot's arithmetic is skipped (the
//     GA's padding is a contiguous tail, so whole warps skip together).  A
//     row is summed by warp shuffles and one shared-memory step: no
//     atomics, no second launch, exact in any order.
//   * Divides by multiply.  For every (kind, mode) the host precomputes a
//     magic number and a shift (build.py `ceil_div_magic`), so that
//         ceil(x / d) = (umulhi(magic, 2 (x - 1)) >> shift) + 1   (x >= 1)
//     -- three instructions where a run-time division takes ~20.
//     Exactness, for every divisor 1 <= d <= 2^31 - 1 and every
//     1 <= x <= 2^31 - 1 (Granlund & Montgomery 1994, Thm 4.2, with
//     N = 31): let l = ceil(log2 d), k = 31 + l, magic = ceil(2^k / d) and
//     e = magic * d - 2^k, so 0 <= e < d <= 2^l.  For n = x - 1 < 2^31,
//     n = q d + r with 0 <= r < d:
//         magic * n / 2^k = q + r / d + e n / (d 2^k),
//     and e n < 2^l 2^31 = 2^k, so the two fractions sum to less than
//     (d - 1) / d + 1 / d = 1 and floor(magic * n / 2^k) = q = floor(n / d).
//     umulhi(magic, 2n) >> l is floor(magic * 2n / 2^32 / 2^l), the same
//     floor; 2n < 2^32 fits the operand, and magic < 2^32 (it is 2^31 for a
//     power of two, and below 2^32 - 1 otherwise, since l <= 31).
//     tests/test_torch_fitness_divmagic.py checks it in numpy.
//   * Multiplies in 32 bits where it can: ceil(w / d) <= w and
//     ceil(h / d) <= h, so when w * h < 2^32 every mode's product and the
//     minimum fit 32 bits; otherwise (int32 extremes) the 64-bit path runs.
//   * Unrolls the mode loop to RT_MAX_MODES.  The host fills the modes past
//     a kind's count with a copy of its mode 0, so the unrolled minimum
//     needs no select, and gives a kind past the table's count weight 0.
//   * With kind lanes the tables sit in shared memory (a per-lane kind
//     index into the parameter's constant bank serialises; shared memory
//     does not): each block copies them after issuing its width loads, and
//     waits for the copy after issuing its height and kind loads.  Each
//     kind's row of modes is padded by one mode, so kinds 0-3 of one mode
//     fall in different banks.
#pragma once

#include <cstdint>

// The table capacity of every kernel: build.py's MAX_KINDS and MAX_MODES.
#define RT_MAX_KINDS 4
#define RT_MAX_MODES 8

// One (kind, mode): ceil(w / mode_w) and ceil(h / mode_d) as magic numbers
// and shifts.  Must match `FitnessMode` in src/repro_torch/kernels/build.py.
struct FitnessMode {
  uint32_t magic_w;
  uint32_t magic_d;
  uint32_t shift_w;
  uint32_t shift_d;
};

// The by-value table argument of K1-K5 (a few hundred bytes of kernel
// parameters, so a call needs no host-to-device copy for it).  Modes past
// a kind's count repeat its mode 0; kinds past the table's count have
// weight 0.  Must match `FitnessTables` in build.py field for field.
struct FitnessTables {
  FitnessMode mode[RT_MAX_KINDS][RT_MAX_MODES + 1];  // + 1: bank padding
  int32_t weight[RT_MAX_KINDS];
};
static_assert(sizeof(FitnessTables) == 592, "FitnessTables layout changed: update build.py");

// The struct's size as this library sees it; the loader compares it with
// build.py's before the first launch.
extern "C" int fitness_tables_bytes() { return static_cast<int>(sizeof(FitnessTables)); }

constexpr int kFitnessThreads = 1024;                          // one block per row
constexpr int kFitnessItems = 4;                               // slots a thread owns in a pass
constexpr int kFitnessChunk = kFitnessThreads * kFitnessItems; // slots a pass takes
static_assert(kFitnessThreads == 32 * 32, "warp 0 sums one warp's partial per lane");

// Units of a live slot (w, h >= 1) under one kind's modes (RT_MAX_MODES of
// them, the padding repeating mode 0).
__device__ __forceinline__ unsigned long long slot_units(uint32_t w, uint32_t h,
                                                         const FitnessMode* modes) {
  const uint32_t n2w = (w - 1u) << 1;
  const uint32_t n2h = (h - 1u) << 1;
  if (static_cast<unsigned long long>(w) * h < (1ull << 32)) {
    uint32_t best = 0xffffffffu;
#pragma unroll
    for (int m = 0; m < RT_MAX_MODES; ++m) {
      const FitnessMode md = modes[m];
      const uint32_t cw = (__umulhi(md.magic_w, n2w) >> md.shift_w) + 1u;
      const uint32_t qh = __umulhi(md.magic_d, n2h) >> md.shift_d;
      best = min(best, cw * qh + cw);  // cw * ceil(h / mode_d) <= w * h
    }
    return best;
  }
  unsigned long long best = ~0ull;
#pragma unroll
  for (int m = 0; m < RT_MAX_MODES; ++m) {
    const FitnessMode md = modes[m];
    const uint32_t cw = (__umulhi(md.magic_w, n2w) >> md.shift_w) + 1u;
    const uint32_t ch = (__umulhi(md.magic_d, n2h) >> md.shift_d) + 1u;
    const unsigned long long c = static_cast<unsigned long long>(cw) * ch;
    best = c < best ? c : best;
  }
  return best;
}

// One slot's cost in cost units: 0 for an empty slot (w <= 0, or h <= 0)
// and for a kind index outside the struct; kind 0 at weight 1 without kind
// lanes.  `t` is the kernel's parameter, or (K1 / K2 / K5's GA role with
// kind lanes) its shared-memory copy.
template <bool KINDS>
__device__ __forceinline__ long long fitness_slot_cost(int32_t w, int32_t h, int32_t k,
                                                       const FitnessTables& t) {
  if (w <= 0 || h <= 0) return 0;
  if constexpr (KINDS) {
    if (static_cast<uint32_t>(k) >= RT_MAX_KINDS) return 0;
    return static_cast<long long>(slot_units(w, h, t.mode[k])) * t.weight[k];
  } else {
    return static_cast<long long>(slot_units(w, h, t.mode[0]));  // weight 1
  }
}

// Threads 0..147 copy the table parameter into shared memory, a word each
// (the caller waits for the copy with its own barrier).  Needs a block of
// at least that many threads (K1 / K2 / K5 launch kFitnessThreads).
__device__ __forceinline__ void stage_fitness_tables(FitnessTables& st,
                                                     const FitnessTables& tables) {
  constexpr int kWords = sizeof(FitnessTables) / sizeof(int32_t);
  static_assert(kWords <= kFitnessThreads, "one word a thread stages the tables");
  if (threadIdx.x < kWords) {
    reinterpret_cast<int32_t*>(&st)[threadIdx.x] =
        reinterpret_cast<const int32_t*>(&tables)[threadIdx.x];
  }
}

// Block-wide, in a block of kFitnessThreads threads: block b sums row b
// (K5 gives its GA role the first blocks of its grid) and its thread 0
// writes the total.  `tables` is the kernel's __grid_constant__ parameter.
template <bool KINDS>
__device__ __forceinline__ void fitness_row(const int32_t* __restrict__ widths,
                                            const int32_t* __restrict__ heights,
                                            const int32_t* __restrict__ kinds,
                                            long long* __restrict__ totals, int nb,
                                            const FitnessTables& tables) {
  const long long base = static_cast<long long>(blockIdx.x) * nb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ long long partials[kFitnessThreads / 32];
  __shared__ __align__(16) FitnessTables st;  // with kind lanes only

  // this thread's slots of one pass: start + i * kFitnessThreads + threadIdx.x
  int32_t w[kFitnessItems], h[kFitnessItems], k[kFitnessItems];
  auto load_widths = [&](long long start) {
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) {
      const long long j = start + i * kFitnessThreads + threadIdx.x;
      w[i] = j < nb ? widths[base + j] : 0;
    }
  };
  auto load_rest = [&](long long start) {
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) {
      const long long j = start + i * kFitnessThreads + threadIdx.x;
      h[i] = w[i] > 0 ? heights[base + j] : 0;  // w > 0 only where j < nb
      k[i] = KINDS && w[i] > 0 ? kinds[base + j] : 0;
    }
  };
  long long acc = 0;
  auto add_costs = [&]() {
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) {
      if constexpr (KINDS) {
        acc += fitness_slot_cost<true>(w[i], h[i], k[i], st);
      } else {
        acc += fitness_slot_cost<false>(w[i], h[i], k[i], tables);
      }
    }
  };

  // the first pass: its loads go out before the tables are staged and
  // before the barrier that publishes them
  load_widths(0);
  if (KINDS) stage_fitness_tables(st, tables);
  load_rest(0);
  if (KINDS) __syncthreads();
  add_costs();
  for (long long start = kFitnessChunk; start < nb; start += kFitnessChunk) {  // NB > 4096 only
    load_widths(start);
    load_rest(start);
    add_costs();
  }

  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) partials[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    long long v = partials[lane];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) totals[blockIdx.x] = v;
  }
}
