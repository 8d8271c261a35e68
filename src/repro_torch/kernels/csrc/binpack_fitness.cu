// K1 / K2: population-parallel bin-packing fitness with the row sum fused.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/binpack_fitness/kernel.py:
//   K1 binpack_fitness_pallas       (body _fitness_kernel)
//   K2 binpack_fitness_kinds_pallas (body _fitness_kinds_kernel / kind_cost_block)
// Those return the (P, NB) per-bin costs and leave the row sum to ops.py;
// here one block owns one population row and writes its (P,) int64 total,
// so the per-bin plane never reaches device memory.
//
// Bound on an H100 SXM: pure streaming of int32 planes.  At the GA's main
// path shape (n_pop = 75 rows of NB = 2253 bin slots, RN152-W1A2, ~1600
// live bins a row) K1 must read every width (0.68 MB) and the heights of
// the live slots only (an empty slot costs 0): ~1.16 MB, 0.35 us at
// 3.35 TB/s; K2 adds the live slots' kinds: ~1.65 MB, 0.49 us.  The integer
// work (4 operations per mode per live slot) is below that at the card's
// INT32 rate.  Both are well under the ~2-5 us a
// kernel launch costs, so a simple design is enough for now: one block per
// row, a strided loop over the row's slots (neighbouring threads read
// neighbouring words, so loads coalesce), a warp-shuffle plus shared-memory
// sum, no padding of P or NB (the loop bound masks the ragged edge).
// The row body is `fitness_row` in binpack_rows.cuh, shared with K5.
#include <cuda_runtime.h>

#include "binpack_rows.cuh"

namespace {

constexpr int kThreads = 256;

template <bool KINDS>
__global__ void __launch_bounds__(kThreads)
fitness_rows_kernel(const int32_t* __restrict__ widths,
                    const int32_t* __restrict__ heights,
                    const int32_t* __restrict__ kinds,
                    long long* __restrict__ totals, int nb,
                    const KindTables tables) {
  fitness_row<KINDS, kThreads>(widths, heights, kinds, totals, blockIdx.x, nb,
                               tables);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Every pointer is a device
// pointer except `tables`, a host struct copied into the kernel's
// parameters.  Returns the cudaError_t of the launch (0 on success).
extern "C" int binpack_fitness_launch(const int32_t* widths,
                                      const int32_t* heights,
                                      long long* totals, int p, int nb,
                                      const KindTables* tables,
                                      cudaStream_t stream) {
  if (p <= 0) return 0;
  fitness_rows_kernel<false><<<p, kThreads, 0, stream>>>(
      widths, heights, nullptr, totals, nb, *tables);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int binpack_fitness_kinds_launch(const int32_t* widths,
                                            const int32_t* heights,
                                            const int32_t* kinds,
                                            long long* totals, int p, int nb,
                                            const KindTables* tables,
                                            cudaStream_t stream) {
  if (p <= 0) return 0;
  fitness_rows_kernel<true><<<p, kThreads, 0, stream>>>(
      widths, heights, kinds, totals, nb, *tables);
  return static_cast<int>(cudaGetLastError());
}
