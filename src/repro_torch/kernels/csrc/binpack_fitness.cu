// K1 / K2: population-parallel bin-packing fitness with the row sum fused.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/binpack_fitness/kernel.py:
//   K1 binpack_fitness_pallas       (body _fitness_kernel)
//   K2 binpack_fitness_kinds_pallas (body _fitness_kinds_kernel / kind_cost_block)
// Those return the (P, NB) per-bin costs and leave the row sum to ops.py;
// here each population row's (P,) int64 total is written directly, so the
// per-bin plane never reaches device memory.
//
//   cost(w, h, k) = weight[k] * min_m ceil(w / mode_w[k][m]) * ceil(h / mode_d[k][m])
//
// and 0 for an empty slot (w == 0), for h == 0 (every mode gives 0) and for
// a kind index outside the table.
//
// Bound on an H100 SXM: bytes.  At the GA's main-path shape (n_pop = 75 rows
// of NB = 2253 slots, RN152-W1A2, ~1600 live slots a row) K1 must read every
// width (0.68 MB) and the heights of the live slots (an empty slot costs 0):
// ~1.16 MB, 0.35 us at 3.35 TB/s; K2 adds the live slots' kinds: ~1.65 MB,
// 0.49 us.  Both are below the ~1 us a launch costs, so what a design can
// still lose is latency and instruction issue inside the kernel.  The first
// design (one 256-thread block per row, a strided loop, the mode loop
// rolled, run-time divisors) took 8.5 / 10.7 us (PERF.md): each thread
// walked ~9 slots one after another, and each slot cost 12 software
// divisions of ~20 instructions before the next slot's loads went out.
// This design:
//
//   * One 1024-thread block per row (32 warps to hide latency with on each
//     busy SM), a thread owning 4 slots of each 4096-slot pass over the row
//     (neighbouring threads on neighbouring words, so loads coalesce).  A
//     thread issues its 4 width loads at once, then the heights (and kinds)
//     of its live slots, then computes; the arithmetic of an empty slot is
//     skipped (the GA's padding is a contiguous tail, so whole warps skip
//     together).  A row is summed by warp shuffles and one shared-memory
//     step: no memset, no atomics, no second launch, and the integer sum
//     is exact in any order, so the total equals the plain version's bit
//     for bit.  Spreading a row over a cluster of 128-thread blocks (up to
//     8, partials summed in rank 0's shared memory) filled more SMs but was
//     slower at every shape measured: its cluster barriers cost more than
//     the 57 idle SMs (PERF.md, tools/fitness_design_probe.py).
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
//     power of two, and below 2^32 - 1 otherwise, since l <= 31).  x = 0 (w
//     or h) costs 0 and is skipped.  tests/test_torch_fitness_divmagic.py
//     checks the formula on every mode of the four RAM kinds and a few
//     hundred random divisors.
//   * Multiplies in 32 bits where it can: ceil(w / d) <= w and
//     ceil(h / d) <= h, so when w * h < 2^32 every mode's product and the
//     minimum fit 32 bits; otherwise (int32 extremes) the 64-bit path runs.
//   * Unrolls the mode loop to RT_MAX_MODES.  The host fills the modes past
//     a kind's count with a copy of its mode 0, so the unrolled minimum
//     needs no select, and gives a kind past the table's count weight 0.
//   * K2's tables sit in shared memory (a per-lane kind index into the
//     parameter's constant bank serialises; shared memory does not): each
//     block copies them after issuing its width loads, and waits for the
//     copy after issuing its height and kind loads.  Each kind's row of
//     modes is padded by one mode, so kinds 0-3 of one mode fall in
//     different banks.
//
// K5 (binpack_portfolio_step.cu) keeps the first design's row body,
// `fitness_row` in binpack_rows.cuh, until its own redesign.
#include <cuda_runtime.h>

#include "kind_tables.cuh"

// One (kind, mode): ceil(w / mode_w) and ceil(h / mode_d) as magic numbers
// and shifts.  Must match `FitnessMode` in src/repro_torch/kernels/build.py.
struct FitnessMode {
  uint32_t magic_w;
  uint32_t magic_d;
  uint32_t shift_w;
  uint32_t shift_d;
};

// K1 / K2's by-value table argument (`KindTables` stays as it is for K3-K5).
// Modes past a kind's count repeat its mode 0; kinds past the table's count
// have weight 0.  Must match `FitnessTables` in build.py field for field.
struct FitnessTables {
  FitnessMode mode[RT_MAX_KINDS][RT_MAX_MODES + 1];  // + 1: bank padding
  int32_t weight[RT_MAX_KINDS];
};
static_assert(sizeof(FitnessTables) == 592, "FitnessTables layout changed: update build.py");

namespace {

constexpr int kThreads = 1024;             // one block per population row
constexpr int kItems = 4;                  // slots a thread owns in a pass
constexpr int kChunk = kThreads * kItems;  // slots a pass over the row takes
static_assert(kThreads == 32 * 32, "warp 0 sums one warp's partial per lane");

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

// Grid: one block of kThreads threads per population row.
template <bool KINDS>
__global__ void __launch_bounds__(kThreads)
fitness_rows_kernel(const int32_t* __restrict__ widths,
                    const int32_t* __restrict__ heights,
                    const int32_t* __restrict__ kinds,
                    long long* __restrict__ totals, int nb,
                    const __grid_constant__ FitnessTables tables) {
  const long long base = static_cast<long long>(blockIdx.x) * nb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ long long partials[kThreads / 32];
  __shared__ __align__(16) FitnessTables st;  // K2 only

  // this thread's slots of one pass: start + i * kThreads + threadIdx.x
  int32_t w[kItems], h[kItems], k[kItems];
  auto load_widths = [&](long long start) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = start + i * kThreads + threadIdx.x;
      w[i] = j < nb ? widths[base + j] : 0;
    }
  };
  auto load_rest = [&](long long start) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = start + i * kThreads + threadIdx.x;
      h[i] = w[i] > 0 ? heights[base + j] : 0;  // w > 0 only where j < nb
      k[i] = KINDS && w[i] > 0 ? kinds[base + j] : 0;
    }
  };
  long long acc = 0;
  auto add_costs = [&]() {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (w[i] <= 0 || h[i] <= 0) continue;
      if constexpr (KINDS) {
        if (static_cast<uint32_t>(k[i]) >= RT_MAX_KINDS) continue;
        acc += static_cast<long long>(slot_units(w[i], h[i], st.mode[k[i]])) * st.weight[k[i]];
      } else {
        acc += static_cast<long long>(slot_units(w[i], h[i], tables.mode[0]));  // weight 1
      }
    }
  };

  // the first pass: its loads go out before the tables are staged and
  // before the barrier that publishes them
  load_widths(0);
  if (KINDS) {
    constexpr int kWords = sizeof(FitnessTables) / sizeof(int32_t);
    static_assert(kWords <= kThreads, "one word a thread stages the tables");
    if (threadIdx.x < kWords) {
      reinterpret_cast<int32_t*>(&st)[threadIdx.x] =
          reinterpret_cast<const int32_t*>(&tables)[threadIdx.x];
    }
  }
  load_rest(0);
  if (KINDS) __syncthreads();
  add_costs();
  for (long long start = kChunk; start < nb; start += kChunk) {  // NB > 4096 only
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

template <bool KINDS>
int launch_rows(const int32_t* widths, const int32_t* heights, const int32_t* kinds,
                long long* totals, int p, int nb, const FitnessTables* tables,
                cudaStream_t stream) {
  if (p <= 0) return 0;
  fitness_rows_kernel<KINDS><<<p, kThreads, 0, stream>>>(widths, heights, kinds, totals, nb,
                                                          *tables);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The struct's size and the launch geometry as this library sees them; the
// loader compares them with build.py's before the first launch.
extern "C" int fitness_tables_bytes() { return static_cast<int>(sizeof(FitnessTables)); }
extern "C" int fitness_threads() { return kThreads; }
extern "C" int fitness_chunk_slots() { return kChunk; }

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer except `tables`, a host struct copied into the kernel's
// parameters.  Returns the cudaError_t of the launch (0 on success).
extern "C" int binpack_fitness_launch(const int32_t* widths,
                                      const int32_t* heights,
                                      long long* totals, int p, int nb,
                                      const FitnessTables* tables,
                                      cudaStream_t stream) {
  return launch_rows<false>(widths, heights, nullptr, totals, p, nb, tables, stream);
}

extern "C" int binpack_fitness_kinds_launch(const int32_t* widths,
                                            const int32_t* heights,
                                            const int32_t* kinds,
                                            long long* totals, int p, int nb,
                                            const FitnessTables* tables,
                                            cudaStream_t stream) {
  return launch_rows<true>(widths, heights, kinds, totals, p, nb, tables, stream);
}
