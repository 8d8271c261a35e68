// K5: the fused portfolio step -- a stacked GA generation's population
// totals AND one SA fleet step's delta costs in ONE launch.
//
// Replaces the Pallas TPU programs in
// src/repro/kernels/binpack_portfolio_step/kernel.py:
//   portfolio_step_pallas       (K1 + K3 composed under one jit)
//   portfolio_step_kinds_pallas (K2 + K4 composed under one jit)
// The island portfolio's fused barrier answers one GA fitness batch and one
// SA fleet step request per call; on the TPU the two Pallas kernels run as
// one compiled program.  Here one grid plays both roles:
//
//   blocks 0 .. n_rows-1   one population row each: the strided row loop and
//                          warp-shuffle sum of K1 / K2's first design
//                          (`fitness_row`);
//   blocks n_rows ..       256 chains each, one thread per chain: the delta
//                          sum of K3 / K4's first design (`sa_delta_row`).
//
// Both bodies come from binpack_rows.cuh and cost a slot with kind_cost's
// exact integer arithmetic, so K5's results are the separate kernels'
// results bit for bit (K1 / K2 now divide by magic numbers and sum a row
// over 1024 threads, K3 / K4 over a group of lanes; neither can change an
// integer result).  The mode tables
// are one by-value `KindTables` argument shared by both roles (a portfolio's
// islands share one problem).
//
// Bound on an H100 SXM: bytes, as for K1 / K2.  At the portfolio's main-path
// shape (two GA islands of n_pop = 75 over NB = 2253 slots plus an 8-chain
// SA step of 4 slots, RN152-W1A2) the GA half reads every width and the
// live slots' heights (and kinds), ~2.3 MB single-kind and ~3.3 MB with
// kinds: ~0.7 and ~1.0 us at 3.35 TB/s.  The SA half adds a few hundred
// bytes.  One launch saves the second launch's fixed cost; the design is
// otherwise the simple one of K1-K4.
#include <cuda_runtime.h>

#include "binpack_rows.cuh"

namespace {

constexpr int kThreads = 256;

template <bool KINDS>
__global__ void __launch_bounds__(kThreads)
portfolio_step_kernel(const int32_t* __restrict__ widths,
                      const int32_t* __restrict__ heights,
                      const int32_t* __restrict__ kinds,
                      long long* __restrict__ totals, int n_rows, int nb,
                      const int32_t* __restrict__ old_w,
                      const int32_t* __restrict__ old_h,
                      const int32_t* __restrict__ old_k,
                      const int32_t* __restrict__ new_w,
                      const int32_t* __restrict__ new_h,
                      const int32_t* __restrict__ new_k,
                      long long* __restrict__ deltas, int c, int t,
                      const KindTables tables) {
  // the role is uniform per block, so the GA role's __syncthreads is safe
  if (static_cast<int>(blockIdx.x) < n_rows) {
    fitness_row<KINDS, kThreads>(widths, heights, kinds, totals, blockIdx.x,
                                 nb, tables);
    return;
  }
  const long long row =
      static_cast<long long>(blockIdx.x - n_rows) * kThreads + threadIdx.x;
  if (row >= c) return;
  sa_delta_row<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, deltas, row, t,
                      tables);
}

template <bool KINDS>
int launch(const int32_t* widths, const int32_t* heights, const int32_t* kinds,
           long long* totals, int n_rows, int nb, const int32_t* old_w,
           const int32_t* old_h, const int32_t* old_k, const int32_t* new_w,
           const int32_t* new_h, const int32_t* new_k, long long* deltas,
           int c, int t, const KindTables* tables, cudaStream_t stream) {
  const int rows = n_rows > 0 ? n_rows : 0;
  const int chain_blocks = c > 0 ? (c + kThreads - 1) / kThreads : 0;
  if (rows + chain_blocks == 0) return 0;
  portfolio_step_kernel<KINDS><<<rows + chain_blocks, kThreads, 0, stream>>>(
      widths, heights, kinds, totals, rows, nb, old_w, old_h, old_k, new_w,
      new_h, new_k, deltas, c, t, *tables);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes); see binpack_fitness.cu.
extern "C" int portfolio_step_launch(
    const int32_t* widths, const int32_t* heights, long long* totals,
    int n_rows, int nb, const int32_t* old_w, const int32_t* old_h,
    const int32_t* new_w, const int32_t* new_h, long long* deltas, int c,
    int t, const KindTables* tables, cudaStream_t stream) {
  return launch<false>(widths, heights, nullptr, totals, n_rows, nb, old_w,
                       old_h, nullptr, new_w, new_h, nullptr, deltas, c, t,
                       tables, stream);
}

extern "C" int portfolio_step_kinds_launch(
    const int32_t* widths, const int32_t* heights, const int32_t* kinds,
    long long* totals, int n_rows, int nb, const int32_t* old_w,
    const int32_t* old_h, const int32_t* old_k, const int32_t* new_w,
    const int32_t* new_h, const int32_t* new_k, long long* deltas, int c,
    int t, const KindTables* tables, cudaStream_t stream) {
  return launch<true>(widths, heights, kinds, totals, n_rows, nb, old_w, old_h,
                      old_k, new_w, new_h, new_k, deltas, c, t, tables, stream);
}
