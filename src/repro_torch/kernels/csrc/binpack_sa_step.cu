// K3 / K4: fused multi-chain simulated-annealing delta cost.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/binpack_sa_step/kernel.py:
//   K3 sa_step_deltas_pallas       (body _sa_step_kernel)
//   K4 sa_step_deltas_kinds_pallas (body _sa_step_kinds_kernel)
// For every chain row c:  d(c) = sum_t cost(new_t) - cost(old_t), where the
// T slots are the bins one annealing step touched (T = 2 * swap_moves) and
// an empty slot (w == 0) costs nothing on either side.
//
// Bound on an H100 SXM: at the SA main-path shape (64 chains x T = 4) K3
// reads four (64, 4) int32 matrices (4 KiB; K4 six, 6 KiB) and writes 512 B,
// a few nanoseconds at 3.35 TB/s.  The step is bound by the launch and by
// the host<->device copies around it, not by the kernel, so the design is
// the simplest exact one: one thread per chain row looping over its T slots
// with a 64-bit accumulator, the ragged edge masked by the row bound.
// The row body is `sa_delta_row` in binpack_rows.cuh, shared with K5.
#include <cuda_runtime.h>

#include "binpack_rows.cuh"

namespace {

constexpr int kThreads = 128;

template <bool KINDS>
__global__ void __launch_bounds__(kThreads)
sa_step_rows_kernel(const int32_t* __restrict__ old_w,
                    const int32_t* __restrict__ old_h,
                    const int32_t* __restrict__ old_k,
                    const int32_t* __restrict__ new_w,
                    const int32_t* __restrict__ new_h,
                    const int32_t* __restrict__ new_k,
                    long long* __restrict__ deltas, int c, int t,
                    const KindTables tables) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= c) return;
  sa_delta_row<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, deltas, row, t,
                      tables);
}

}  // namespace

// Plain C entry points (loaded with ctypes); see binpack_fitness.cu.
extern "C" int sa_step_deltas_launch(const int32_t* old_w,
                                     const int32_t* old_h,
                                     const int32_t* new_w,
                                     const int32_t* new_h, long long* deltas,
                                     int c, int t, const KindTables* tables,
                                     cudaStream_t stream) {
  if (c <= 0) return 0;
  const int blocks = (c + kThreads - 1) / kThreads;
  sa_step_rows_kernel<false><<<blocks, kThreads, 0, stream>>>(
      old_w, old_h, nullptr, new_w, new_h, nullptr, deltas, c, t, *tables);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sa_step_deltas_kinds_launch(
    const int32_t* old_w, const int32_t* old_h, const int32_t* old_k,
    const int32_t* new_w, const int32_t* new_h, const int32_t* new_k,
    long long* deltas, int c, int t, const KindTables* tables,
    cudaStream_t stream) {
  if (c <= 0) return 0;
  const int blocks = (c + kThreads - 1) / kThreads;
  sa_step_rows_kernel<true><<<blocks, kThreads, 0, stream>>>(
      old_w, old_h, old_k, new_w, new_h, new_k, deltas, c, t, *tables);
  return static_cast<int>(cudaGetLastError());
}
