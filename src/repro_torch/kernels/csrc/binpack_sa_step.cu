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
// about a nanosecond at 3.35 TB/s, far below any launch.  What a launch can
// still lose is latency inside the kernel: one cost evaluation is a chain of
// software 32-bit divisions (two per mode, tens of cycles each), and a
// thread that walks a row's 2T evaluations one after another (the first
// design, one thread per row) pays 2T such chains in series.  So the row is
// spread over a group of L lanes instead:
//
//   * L = min(32, next power of two >= 2T) lanes per chain row, 32 / L rows
//     per warp; lane j evaluates items j, j + L, ... of the row's 2T
//     (slot, side) items, +cost for the new side, -cost for the old, and a
//     segmented __shfl_xor_sync sum over the L lanes gives the row's int64
//     delta (lane 0 writes it).  For T <= 16 each lane evaluates one item;
//     a larger T makes the group a whole warp that loops.
//   * the mode loop is unrolled to RT_MAX_MODES with an `m < n_modes`
//     select, so the divisions of all modes are independent and overlap;
//   * the KindTables parameter (292 B, constant bank) is copied to shared
//     memory at block start: lanes of one warp that index different kinds
//     (K4) then read shared-memory banks in parallel instead of serialised
//     constant-cache reads.  K3 takes the same path with kind 0.  The copy
//     and its barrier sit on the critical path of a kernel this short, so
//     each lane loads its first item before them (the global loads are in
//     flight meanwhile) and one warp copies the 73 words, three loads per
//     lane issued together.
//
// The arithmetic is kind_cost's (kind_tables.cuh) term for term: unsigned
// 32-bit ceil-divisions, a 64-bit product, the first mode's value replaced
// by any smaller one, times the kind's weight; only the order of the final
// 64-bit integer sum differs, which cannot change an integer.  K5 keeps the
// one-thread row body `sa_delta_row` (binpack_rows.cuh) for its SA role.
#include <cuda_runtime.h>

#include "kind_tables.cuh"

namespace {

constexpr int kThreads = 128;

// kind_cost, with the mode loop unrolled over the table's capacity and the
// modes past n_modes masked by a select (divisor 1, value ignored), so no
// division waits on another.
__device__ __forceinline__ long long kind_cost_unrolled(int32_t w, int32_t h, int32_t k,
                                                        const KindTables& t) {
  if (w <= 0 || k < 0 || k >= t.n_kinds) return 0;
  const int n = t.n_modes[k];
  long long best = 0;
#pragma unroll
  for (int m = 0; m < RT_MAX_MODES; ++m) {
    const bool on = m < n;
    const uint32_t mw = on ? static_cast<uint32_t>(t.mode_w[k][m]) : 1u;
    const uint32_t md = on ? static_cast<uint32_t>(t.mode_d[k][m]) : 1u;
    const uint32_t cw = (static_cast<uint32_t>(w) + mw - 1u) / mw;
    const uint32_t ch = (static_cast<uint32_t>(h) + md - 1u) / md;
    const long long c = static_cast<long long>(cw) * ch;
    if (on && (m == 0 || c < best)) best = c;
  }
  return best * t.weight[k];
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

// Launched with at most kThreads threads a block.  No __launch_bounds__:
// with it ptxas held this body to 40 registers and spilled the row index
// around the unrolled mode loop; without it, 46 registers and no spills.
template <bool KINDS>
__global__ void
sa_step_lanes_kernel(const int32_t* __restrict__ old_w,
                     const int32_t* __restrict__ old_h,
                     const int32_t* __restrict__ old_k,
                     const int32_t* __restrict__ new_w,
                     const int32_t* __restrict__ new_h,
                     const int32_t* __restrict__ new_k,
                     long long* __restrict__ deltas, int c, int t, int log2_lanes,
                     const __grid_constant__ KindTables tables) {
  const int lanes = 1 << log2_lanes;
  const int lane = threadIdx.x & (lanes - 1);
  // c <= 2^31 - 1 and a block holds at most 128 rows, so a row index fits
  // in 32 unsigned bits
  const unsigned row = blockIdx.x * (blockDim.x >> log2_lanes) + (threadIdx.x >> log2_lanes);
  const long long base = static_cast<long long>(row) * t;
  const bool busy = row < static_cast<unsigned>(c) && lane < 2 * t;
  // this lane's first item is loaded before the tables are staged, so its
  // global loads are in flight during the copy and the barrier
  int32_t w = 0, h = 0, k = 0;
  if (busy) load_item<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, base, t, lane, w, h, k);

  // the first warp stages the tables, each lane's three words loaded at
  // once (__grid_constant__ lets the block read the parameter by address,
  // with no local copy of it)
  __shared__ KindTables st;
  if (threadIdx.x < 32) {
    constexpr int kWords = sizeof(KindTables) / sizeof(int32_t);
    static_assert(kWords <= 3 * 32, "KindTables outgrew the staging loop");
    const int32_t* src = reinterpret_cast<const int32_t*>(&tables);
    int32_t* dst = reinterpret_cast<int32_t*>(&st);
    int32_t v[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i = threadIdx.x + 32 * r;
      v[r] = i < kWords ? src[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i = threadIdx.x + 32 * r;
      if (i < kWords) dst[i] = v[r];
    }
  }
  __syncthreads();

  long long d = 0;
  if (busy) {
    // +cost for the new side, -cost for the old
    const long long cost = kind_cost_unrolled(w, h, k, st);
    d = lane < t ? cost : -cost;
    for (int j = lane + lanes; j < 2 * t; j += lanes) {  // T > 16 only
      load_item<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, base, t, j, w, h, k);
      const long long cost = kind_cost_unrolled(w, h, k, st);
      d += j < t ? cost : -cost;
    }
  }
  // every lane of the warp takes part (rows past the last one add 0); the
  // xor offsets stay inside each aligned group of `lanes`
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    d += __shfl_xor_sync(0xffffffffu, d, off);
  }
  if (row < static_cast<unsigned>(c) && lane == 0) deltas[row] = d;
}

// log2 of the lanes per row: min(32, next power of two >= 2t), 1 lane for t = 0
int lanes_log2(int t) {
  int lg = 0;
  while (lg < 5 && (1 << lg) < 2 * t) ++lg;
  return lg;
}

template <bool KINDS>
int launch_rows(const int32_t* old_w, const int32_t* old_h, const int32_t* old_k,
                const int32_t* new_w, const int32_t* new_h, const int32_t* new_k,
                long long* deltas, int c, int t, const KindTables* tables,
                cudaStream_t stream) {
  if (c <= 0) return 0;
  const int lg = lanes_log2(t);
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
                                     int c, int t, const KindTables* tables,
                                     cudaStream_t stream) {
  return launch_rows<false>(old_w, old_h, nullptr, new_w, new_h, nullptr, deltas, c, t,
                            tables, stream);
}

extern "C" int sa_step_deltas_kinds_launch(
    const int32_t* old_w, const int32_t* old_h, const int32_t* old_k,
    const int32_t* new_w, const int32_t* new_h, const int32_t* new_k,
    long long* deltas, int c, int t, const KindTables* tables,
    cudaStream_t stream) {
  return launch_rows<true>(old_w, old_h, old_k, new_w, new_h, new_k, deltas, c, t,
                           tables, stream);
}
