// The SA row body of the bin-packing kernels: a group of lanes per chain
// row, for K3 / K4 (binpack_sa_step.cu) and K5's SA role
// (binpack_portfolio_step.cu).  Each slot is costed by `fitness_slot_cost`
// (fitness_rows.cuh), the one device body of the slot cost.
//
// For every chain row c:  d(c) = sum_t cost(new_t) - cost(old_t), where the
// T slots are the bins one annealing step touched (T = 2 * swap_moves).
//
//   * L = min(32, next power of two >= 2T) lanes per chain row, a block of
//     B threads holding B / L rows; lane j evaluates items j, j + L, ... of
//     the row's 2T (slot, side) items, +cost for the new side, -cost for
//     the old, and a segmented __shfl_xor_sync sum over the L lanes gives
//     the row's int64 delta (lane 0 writes it).  For T <= 16 each lane
//     evaluates one item; a larger T makes the group a whole warp that
//     loops.  One thread per row would pay 2T cost evaluations in series.
//   * Each lane reads its slot's kind's modes straight from the by-value
//     table parameter: no shared-memory copy and no barrier.  Lanes of a
//     warp that read different kinds serialise on the constant cache, but
//     there are at most RT_MAX_KINDS of them; copying the 592 B table into
//     shared memory first, in blocks of 32-128 threads, measured slower at
//     every main-path shape (PERF.md, tools/fitness_design_probe.py).
#pragma once

#include "fitness_rows.cuh"

// log2 of the lanes per chain row: min(32, next power of two >= 2t), 1 lane
// for t = 0.  build.py's `sa_lanes_log2` must agree (the loader compares
// kSaMaxLanes through `portfolio_max_lanes`).
constexpr int kSaMaxLanesLog2 = 5;
constexpr int kSaMaxLanes = 1 << kSaMaxLanesLog2;
inline int sa_lanes_log2(int t) {
  int lg = 0;
  while (lg < kSaMaxLanesLog2 && (1 << lg) < 2 * t) ++lg;
  return lg;
}

// Load item j of a chain row: items 0..t-1 are the new side of slots
// 0..t-1, items t..2t-1 the old side (neighbouring lanes read neighbouring
// words of one plane).
template <bool KINDS>
__device__ __forceinline__ void load_item(const int32_t* __restrict__ old_w,
                                          const int32_t* __restrict__ old_h,
                                          const int32_t* __restrict__ old_k,
                                          const int32_t* __restrict__ new_w,
                                          const int32_t* __restrict__ new_h,
                                          const int32_t* __restrict__ new_k,
                                          long long base, int t, int j, int32_t& w,
                                          int32_t& h, int32_t& k) {
  const bool is_new = j < t;
  const long long i = base + (is_new ? j : j - t);
  w = is_new ? new_w[i] : old_w[i];
  h = is_new ? new_h[i] : old_h[i];
  k = KINDS ? (is_new ? new_k[i] : old_k[i]) : 0;
}

// Block-wide, in a block of whole warps: the chain rows `block * (blockDim.x
// >> log2_lanes)` onwards, a group of 2^log2_lanes lanes each.  `tables` is
// the kernel's __grid_constant__ parameter.  c <= 2^31 - 1 and a block holds
// at most blockDim.x <= 1024 rows, so a row index fits in 32 unsigned bits.
template <bool KINDS>
__device__ __forceinline__ void sa_lanes_rows(const int32_t* __restrict__ old_w,
                                              const int32_t* __restrict__ old_h,
                                              const int32_t* __restrict__ old_k,
                                              const int32_t* __restrict__ new_w,
                                              const int32_t* __restrict__ new_h,
                                              const int32_t* __restrict__ new_k,
                                              long long* __restrict__ deltas, int c, int t,
                                              int log2_lanes, unsigned block,
                                              const FitnessTables& tables) {
  const int lanes = 1 << log2_lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const unsigned row = block * (blockDim.x >> log2_lanes) + (threadIdx.x >> log2_lanes);
  const long long base = static_cast<long long>(row) * t;
  const bool busy = row < static_cast<unsigned>(c) && lane < 2 * t;
  int32_t w = 0, h = 0, k = 0;
  if (busy) load_item<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, base, t, lane, w, h, k);

  long long d = 0;
  if (busy) {
    // +cost for the new side, -cost for the old
    const long long first = fitness_slot_cost<KINDS>(w, h, k, tables);
    d = lane < t ? first : -first;
    for (int j = lane + lanes; j < 2 * t; j += lanes) {  // T > 16 only
      load_item<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, base, t, j, w, h, k);
      const long long more = fitness_slot_cost<KINDS>(w, h, k, tables);
      d += j < t ? more : -more;
    }
  }
  // every lane of the warp takes part (rows past the last one add 0); the
  // xor offsets stay inside each aligned group of `lanes`
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, off);
  }
  if (row < static_cast<unsigned>(c) && lane == 0) deltas[row] = d;
}
