// K5: the fused portfolio step -- a stacked GA generation's population
// totals AND one SA fleet step's delta costs in ONE launch.
//
// Replaces the Pallas TPU programs in
// src/repro/kernels/binpack_portfolio_step/kernel.py:
//   portfolio_step_pallas       (K1 + K3 composed under one jit)
//   portfolio_step_kinds_pallas (K2 + K4 composed under one jit)
// The island portfolio's fused barrier answers one GA fitness batch and one
// SA fleet step request per call; on the TPU the two Pallas kernels run as
// one compiled program.  Here one grid of 1024-thread blocks plays both
// roles, the role uniform per block (so each role's __syncthreads is safe):
//
//   blocks 0 .. n_rows-1   one population row each: K1 / K2's row body
//                          (`fitness_row`, fitness_rows.cuh);
//   blocks n_rows ..       1024 >> log2_lanes chain rows each, a group of
//                          2^log2_lanes lanes per row: K3 / K4's lane-group
//                          body (`sa_lanes_rows`, sa_lanes.cuh).
//
// Both roles cost a slot with `fitness_slot_cost` on one by-value
// `FitnessTables` (a portfolio's islands share one problem), as K1-K4 do.
// So K5's results are the separate kernels' bit for bit, with no third
// body.
//
// Bound on an H100 SXM: bytes, as for K1 / K2.  At the portfolio's main-path
// shape (two GA islands of n_pop = 75 over NB = 2253 slots plus an 8-chain
// SA step of 4 slots, RN152-W1A2) ~2.3 MB single-kind and ~3.3 MB with
// kinds: ~0.7 and ~1.0 us at 3.35 TB/s.  One launch saves the second
// launch's fixed cost, and the SA blocks run beside the GA rows.
#include <cuda_runtime.h>

#include "fitness_rows.cuh"
#include "sa_lanes.cuh"

namespace {

// Registers decide waves: K5a takes 32, so the main path's 151 blocks fit
// two an SM, in one wave; K5b would take 63 (two waves), and held to 32 by
// the second bound it spills 16 bytes and runs ~1 us faster, a bound that
// made K5a slower (PERF.md; tools/fitness_design_probe.py).
template <bool KINDS>
__global__ void __launch_bounds__(kFitnessThreads, KINDS ? 2 : 1)
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
                      long long* __restrict__ deltas, int c, int t, int log2_lanes,
                      const __grid_constant__ FitnessTables tables) {
  if (static_cast<int>(blockIdx.x) < n_rows) {
    fitness_row<KINDS>(widths, heights, kinds, totals, nb, tables);
    return;
  }
  sa_lanes_rows<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, deltas, c, t, log2_lanes,
                       blockIdx.x - n_rows, tables);
}

template <bool KINDS>
int launch(const int32_t* widths, const int32_t* heights, const int32_t* kinds,
           long long* totals, int n_rows, int nb, const int32_t* old_w,
           const int32_t* old_h, const int32_t* old_k, const int32_t* new_w,
           const int32_t* new_h, const int32_t* new_k, long long* deltas,
           int c, int t, const FitnessTables* tables, cudaStream_t stream) {
  const int rows = n_rows > 0 ? n_rows : 0;
  const int lg = sa_lanes_log2(t);
  const int chains_per_block = kFitnessThreads >> lg;
  const long long chain_blocks = c > 0 ? (c + chains_per_block - 1LL) / chains_per_block : 0;
  const long long blocks = rows + chain_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  portfolio_step_kernel<KINDS><<<static_cast<unsigned>(blocks), kFitnessThreads, 0, stream>>>(
      widths, heights, kinds, totals, rows, nb, old_w, old_h, old_k, new_w, new_h, new_k,
      deltas, c, t, lg, *tables);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch geometry as this library sees it; the loader compares it with
// build.py's (PORTFOLIO_THREADS, SA_MAX_LANES) before the first launch: every
// block has portfolio_threads() threads, and a chain row takes
// min(portfolio_max_lanes(), next power of two >= 2T) of them.
extern "C" int portfolio_threads() { return kFitnessThreads; }
extern "C" int portfolio_max_lanes() { return kSaMaxLanes; }

// Plain C entry points (loaded with ctypes); see binpack_fitness.cu.
extern "C" int portfolio_step_launch(
    const int32_t* widths, const int32_t* heights, long long* totals,
    int n_rows, int nb, const int32_t* old_w, const int32_t* old_h,
    const int32_t* new_w, const int32_t* new_h, long long* deltas, int c,
    int t, const FitnessTables* tables, cudaStream_t stream) {
  return launch<false>(widths, heights, nullptr, totals, n_rows, nb, old_w,
                       old_h, nullptr, new_w, new_h, nullptr, deltas, c, t,
                       tables, stream);
}

extern "C" int portfolio_step_kinds_launch(
    const int32_t* widths, const int32_t* heights, const int32_t* kinds,
    long long* totals, int n_rows, int nb, const int32_t* old_w,
    const int32_t* old_h, const int32_t* old_k, const int32_t* new_w,
    const int32_t* new_h, const int32_t* new_k, long long* deltas, int c,
    int t, const FitnessTables* tables, cudaStream_t stream) {
  return launch<true>(widths, heights, kinds, totals, n_rows, nb, old_w, old_h,
                      old_k, new_w, new_h, new_k, deltas, c, t, tables, stream);
}
