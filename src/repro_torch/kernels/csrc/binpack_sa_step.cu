// K3 / K4: fused multi-chain simulated-annealing delta cost.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/binpack_sa_step/kernel.py:
//   K3 sa_step_deltas_pallas       (body _sa_step_kernel)
//   K4 sa_step_deltas_kinds_pallas (body _sa_step_kinds_kernel)
// For every chain row c:  d(c) = sum_t cost(new_t) - cost(old_t), where the
// T slots are the bins one annealing step touched (T = 2 * swap_moves) and
// an empty slot (w == 0) costs nothing on either side.  Domain: w, h >= 0
// (int32).
//
// Bound on an H100 SXM: at the SA main-path shape (64 chains x T = 4) K3
// reads four (64, 4) int32 matrices (4 KiB; K4 six, 6 KiB) and writes 512 B,
// about a nanosecond at 3.35 TB/s, far below any launch.  What a launch can
// still lose is latency inside the kernel.  So a row is spread over a group
// of lanes (`sa_lanes_rows`, sa_lanes.cuh, shared with K5's SA role), and a
// slot is costed by `fitness_slot_cost` (fitness_rows.cuh, shared with
// K1 / K2 and K5): divisions by multiplication with host-made magic numbers
// from the by-value `FitnessTables`, the mode loop unrolled.
#include <cuda_runtime.h>

#include "sa_lanes.cuh"

namespace {

constexpr int kThreads = 128;

// Launched with at most kThreads threads a block.
template <bool KINDS>
__global__ void
sa_step_lanes_kernel(const int32_t* __restrict__ old_w,
                     const int32_t* __restrict__ old_h,
                     const int32_t* __restrict__ old_k,
                     const int32_t* __restrict__ new_w,
                     const int32_t* __restrict__ new_h,
                     const int32_t* __restrict__ new_k,
                     long long* __restrict__ deltas, int c, int t, int log2_lanes,
                     const __grid_constant__ FitnessTables tables) {
  sa_lanes_rows<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, deltas, c, t, log2_lanes,
                       blockIdx.x, tables);
}

template <bool KINDS>
int launch_rows(const int32_t* old_w, const int32_t* old_h, const int32_t* old_k,
                const int32_t* new_w, const int32_t* new_h, const int32_t* new_k,
                long long* deltas, int c, int t, const FitnessTables* tables,
                cudaStream_t stream) {
  if (c <= 0) return 0;
  const int lg = sa_lanes_log2(t);
  // whole warps, at most kThreads, no more than the rows need
  const long long want = (static_cast<long long>(c) << lg) + 31;
  const int threads = static_cast<int>(want / 32 * 32 < kThreads ? want / 32 * 32 : kThreads);
  const int rows_per_block = threads >> lg;
  const int blocks = (c + rows_per_block - 1) / rows_per_block;
  sa_step_lanes_kernel<KINDS><<<blocks, threads, 0, stream>>>(
      old_w, old_h, old_k, new_w, new_h, new_k, deltas, c, t, lg, *tables);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes); see binpack_fitness.cu.
extern "C" int sa_step_deltas_launch(const int32_t* old_w,
                                     const int32_t* old_h,
                                     const int32_t* new_w,
                                     const int32_t* new_h, long long* deltas,
                                     int c, int t, const FitnessTables* tables,
                                     cudaStream_t stream) {
  return launch_rows<false>(old_w, old_h, nullptr, new_w, new_h, nullptr, deltas, c, t,
                            tables, stream);
}

extern "C" int sa_step_deltas_kinds_launch(
    const int32_t* old_w, const int32_t* old_h, const int32_t* old_k,
    const int32_t* new_w, const int32_t* new_h, const int32_t* new_k,
    long long* deltas, int c, int t, const FitnessTables* tables,
    cudaStream_t stream) {
  return launch_rows<true>(old_w, old_h, old_k, new_w, new_h, new_k, deltas, c, t,
                           tables, stream);
}
