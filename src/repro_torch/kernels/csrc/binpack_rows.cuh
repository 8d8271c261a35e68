// Row bodies of the fused portfolio kernel K5 (binpack_portfolio_step.cu),
// the first designs of K1 / K2 and K3 / K4:
//
//   fitness_row   one block sums one population row's bin costs (the GA
//                 role of K5);
//   sa_delta_row  one thread sums one chain row's cost(new) - cost(old)
//                 over its touched slots (the SA role of K5).
//
// K1 / K2 have their own body in binpack_fitness.cu since their redesign (a
// 1024-thread block per population row, divisions by magic numbers, the
// mode loop unrolled, the tables in shared memory), and K3 / K4 theirs in
// binpack_sa_step.cu (a group of lanes per chain row).  Each computes what
// the body here computes, exactly, and K5 can take both when it is
// redesigned.
//
// Both are exact: int32 inputs, unsigned 32-bit ceil-divisions and 64-bit
// products and sums (kind_tables.cuh).
#pragma once

#include "kind_tables.cuh"

// Block-wide: every thread of the block must call it with the same `row`.
// A strided loop over the row's slots (neighbouring threads read
// neighbouring words, so loads coalesce), then a warp-shuffle and a
// shared-memory sum; thread 0 writes the row's total.
template <bool KINDS, int THREADS>
__device__ __forceinline__ void fitness_row(const int32_t* __restrict__ widths,
                                            const int32_t* __restrict__ heights,
                                            const int32_t* __restrict__ kinds,
                                            long long* __restrict__ totals,
                                            long long row, int nb,
                                            const KindTables& tables) {
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps only");
  const long long base = row * nb;
  long long acc = 0;
  for (int j = threadIdx.x; j < nb; j += THREADS) {
    const int32_t k = KINDS ? kinds[base + j] : 0;
    acc += kind_cost(widths[base + j], heights[base + j], k, tables);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  __shared__ long long warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < THREADS / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) totals[row] = acc;
  }
}

// One thread, one chain row of `t` touched slots (the caller masks rows
// past the last chain).
template <bool KINDS>
__device__ __forceinline__ void sa_delta_row(const int32_t* __restrict__ old_w,
                                             const int32_t* __restrict__ old_h,
                                             const int32_t* __restrict__ old_k,
                                             const int32_t* __restrict__ new_w,
                                             const int32_t* __restrict__ new_h,
                                             const int32_t* __restrict__ new_k,
                                             long long* __restrict__ deltas,
                                             long long row, int t,
                                             const KindTables& tables) {
  const long long base = row * t;
  long long d = 0;
  for (int j = 0; j < t; ++j) {
    const long long i = base + j;
    const int32_t ko = KINDS ? old_k[i] : 0;
    const int32_t kn = KINDS ? new_k[i] : 0;
    d += kind_cost(new_w[i], new_h[i], kn, tables) -
         kind_cost(old_w[i], old_h[i], ko, tables);
  }
  deltas[row] = d;
}
