// K1 / K2: population-parallel bin-packing fitness with the row sum fused.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/binpack_fitness/kernel.py:
//   K1 binpack_fitness_pallas       (body _fitness_kernel)
//   K2 binpack_fitness_kinds_pallas (body _fitness_kinds_kernel / kind_cost_block)
// Those return the (P, NB) per-bin costs and leave the row sum to ops.py;
// here each population row's (P,) int64 total is written directly, so the
// per-bin plane never reaches device memory.  Domain: w, h >= 0 (int32).
//
// Bound on an H100 SXM: bytes.  At the GA's main-path shape (n_pop = 75 rows
// of NB = 2253 slots, RN152-W1A2, ~1600 live slots a row) K1 must read every
// width and the live slots' heights: ~1.16 MB, 0.35 us at 3.35 TB/s; K2 adds
// the live slots' kinds: ~1.65 MB, 0.49 us.  Both are below the ~1 us a
// launch costs, so what a design can still lose is latency and instruction
// issue inside the kernel.  The body is `fitness_row` (fitness_rows.cuh,
// shared with K5's GA role), which says how it spends them.  A cluster of
// 128-thread blocks per row filled more SMs but was slower at every shape
// measured (PERF.md, tools/fitness_design_probe.py).
#include <cuda_runtime.h>

#include "fitness_rows.cuh"

namespace {

// Grid: one block of kFitnessThreads threads per population row.
template <bool KINDS>
__global__ void __launch_bounds__(kFitnessThreads)
fitness_rows_kernel(const int32_t* __restrict__ widths,
                    const int32_t* __restrict__ heights,
                    const int32_t* __restrict__ kinds,
                    long long* __restrict__ totals, int nb,
                    const __grid_constant__ FitnessTables tables) {
  fitness_row<KINDS>(widths, heights, kinds, totals, nb, tables);
}

template <bool KINDS>
int launch_rows(const int32_t* widths, const int32_t* heights, const int32_t* kinds,
                long long* totals, int p, int nb, const FitnessTables* tables,
                cudaStream_t stream) {
  if (p <= 0) return 0;
  fitness_rows_kernel<KINDS><<<p, kFitnessThreads, 0, stream>>>(widths, heights, kinds,
                                                                totals, nb, *tables);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch geometry as this library sees it; the loader compares it with
// build.py's before the first launch (with `fitness_tables_bytes`).
extern "C" int fitness_threads() { return kFitnessThreads; }
extern "C" int fitness_chunk_slots() { return kFitnessChunk; }

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
