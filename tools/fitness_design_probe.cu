// The designs K1 / K2's redesign (src/repro_torch/kernels/csrc/
// binpack_fitness.cu, included below) and K5's (binpack_portfolio_step.cu,
// whose roles are the same row bodies) were chosen over, built and timed
// beside them by tools/fitness_design_probe.py.  Nothing in src/ builds or
// calls this file.
//
//   block_row_kernel  the port's K1 / K2 design (one 1024-thread block per
//                     row) with its 32-bit product path switchable (FAST32);
//                     <true> is the port's kernel;
//   cluster_kernel    each row over a thread-block cluster of up to 8
//                     blocks of 128 threads (512 slots a block), the warps'
//                     partials summed in the rank-0 block's shared memory:
//                     with ASYNC by `st.async` stores completing an
//                     mbarrier there (only rank 0 waits), else by plain
//                     distributed-shared-memory stores and one
//                     cluster.sync(); FAST32 as above;
//   empty_kernel      a launch alone, plain or as clusters, with or without
//                     one cluster barrier;
//   first_design::portfolio_step_kernel
//                     K5 as it was before its redesign, both roles: 256-
//                     thread blocks, a population row's strided loop over
//                     the rolled `kind_cost` (run-time divisions in a loop
//                     bounded by n_modes), then one thread per chain row;
//                     also K1 / K2's first design when given no chains;
//   k5_other_bound_kernel
//                     the port's K5 (the same two roles) under the other
//                     register bound: K5a held by __launch_bounds__(1024, 2)
//                     to 32 registers (two blocks an SM), K5b left free
//                     (__launch_bounds__(1024), one block an SM) -- the
//                     choices the port's bounds were taken over;
//   kind_tables_design::sa_step_lanes_kernel
//                     K3 / K4 before they took the shared slot cost: the
//                     same lane groups, but `KindTables` (the raw modes,
//                     292 B) by value, staged in shared memory by every
//                     block, and run-time 32-bit divisions with the mode
//                     loop unrolled and masked by a select.
#include <cooperative_groups.h>

#include "binpack_fitness.cu"
#include "sa_lanes.cuh"

namespace cg = cooperative_groups;

// The raw mode tables the designs before the shared slot cost took by value
// (the port's kernels take FitnessTables).  Must match `KindTables` in
// tools/fitness_design_probe.py field for field.
struct KindTables {
  int32_t n_kinds;
  int32_t n_modes[RT_MAX_KINDS];
  int32_t weight[RT_MAX_KINDS];
  int32_t mode_w[RT_MAX_KINDS][RT_MAX_MODES];
  int32_t mode_d[RT_MAX_KINDS][RT_MAX_MODES];
};
static_assert(sizeof(KindTables) == 292, "KindTables layout changed");

namespace {


// slot_units without the 32-bit path: every mode's product and the
// minimum in 64 bits
__device__ __forceinline__ unsigned long long slot_units_64(uint32_t w, uint32_t h,
                                                            const FitnessMode* modes) {
  const uint32_t n2w = (w - 1u) << 1;
  const uint32_t n2h = (h - 1u) << 1;
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

template <bool KINDS, bool FAST32>
__device__ __forceinline__ long long probe_cost(int32_t w, int32_t h, int32_t k,
                                                const FitnessTables& param,
                                                const FitnessTables& st) {
  if (w <= 0 || h <= 0) return 0;
  if constexpr (KINDS) {
    if (static_cast<uint32_t>(k) >= RT_MAX_KINDS) return 0;
    const unsigned long long u = FAST32 ? slot_units(w, h, st.mode[k])
                                        : slot_units_64(w, h, st.mode[k]);
    return static_cast<long long>(u) * st.weight[k];
  } else {
    return static_cast<long long>(FAST32 ? slot_units(w, h, param.mode[0])
                                         : slot_units_64(w, h, param.mode[0]));
  }
}

template <bool KINDS, bool FAST32>
__global__ void __launch_bounds__(kFitnessThreads)
block_row_kernel(const int32_t* __restrict__ widths, const int32_t* __restrict__ heights,
                 const int32_t* __restrict__ kinds, long long* __restrict__ totals, int nb,
                 const __grid_constant__ FitnessTables tables) {
  __shared__ long long partials[kFitnessThreads / 32];
  __shared__ __align__(16) FitnessTables st;
  const long long base = static_cast<long long>(blockIdx.x) * nb;
  long long acc = 0;
  for (long long start = 0; start < nb || start == 0; start += kFitnessChunk) {
    int32_t w[kFitnessItems], h[kFitnessItems], k[kFitnessItems];
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) {
      const long long j = start + i * kFitnessThreads + threadIdx.x;
      w[i] = j < nb ? widths[base + j] : 0;
    }
    if (KINDS && start == 0) {
      constexpr int kWords = sizeof(FitnessTables) / sizeof(int32_t);
      if (threadIdx.x < kWords) {
        reinterpret_cast<int32_t*>(&st)[threadIdx.x] =
            reinterpret_cast<const int32_t*>(&tables)[threadIdx.x];
      }
    }
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) {
      const long long j = start + i * kFitnessThreads + threadIdx.x;
      h[i] = w[i] > 0 ? heights[base + j] : 0;
      k[i] = KINDS && w[i] > 0 ? kinds[base + j] : 0;
    }
    if (KINDS && start == 0) __syncthreads();
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) acc += probe_cost<KINDS, FAST32>(w[i], h[i], k[i], tables, st);
    if (nb == 0) break;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) partials[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    long long v = partials[threadIdx.x];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) totals[blockIdx.x] = v;
  }
}

constexpr int kClusterThreads = 128;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kClusterChunk = kClusterThreads * kFitnessItems;  // 512 slots a block
constexpr int kMaxCluster = 8;                           // the portable cluster size

// The cluster barrier in two halves (as CUTLASS's cluster_arrive /
// cluster_wait): arrive has release semantics, wait acquire.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in the cluster's rank-0 block
__device__ __forceinline__ uint32_t rank0_address(const void* p) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(out) : "r"(shared_address(p)));
  return out;
}

// blocks per row: enough 512-slot chunks to cover the row, at most 8
int cluster_blocks(int nb) {
  const int chunks = nb > 0 ? (nb - 1) / kClusterChunk + 1 : 1;
  return chunks < kMaxCluster ? chunks : kMaxCluster;
}

template <bool KINDS, bool FAST32, bool ASYNC>
__global__ void __launch_bounds__(kClusterThreads)
cluster_kernel(const int32_t* __restrict__ widths, const int32_t* __restrict__ heights,
                const int32_t* __restrict__ kinds, long long* __restrict__ totals, int nb,
                const __grid_constant__ FitnessTables tables) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned s = cluster.dim_blocks().x;
  const unsigned rank = cluster.block_rank();
  const long long row = blockIdx.x / s;
  const long long base = row * nb;
  const long long stride = static_cast<long long>(s) * kClusterChunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __shared__ long long partials[kClusterWarps * kMaxCluster];
  __shared__ __align__(8) unsigned long long landed;
  __shared__ __align__(16) FitnessTables st;
  if (ASYNC && rank == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" : : "r"(shared_address(&landed)));
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 : : "r"(shared_address(&landed)), "r"(s * kClusterWarps * 8u));
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  int32_t w[kFitnessItems], h[kFitnessItems], k[kFitnessItems];
  long long acc = 0;
  long long start = static_cast<long long>(rank) * kClusterChunk;
  bool first = true;
  do {
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) {
      const long long j = start + i * kClusterThreads + threadIdx.x;
      w[i] = j < nb ? widths[base + j] : 0;
    }
    if (first && KINDS) {
      constexpr int kWords = sizeof(FitnessTables) / sizeof(int32_t);
      const int32_t* src = reinterpret_cast<const int32_t*>(&tables);
      int32_t* dst = reinterpret_cast<int32_t*>(&st);
      for (int i = threadIdx.x; i < kWords; i += kClusterThreads) dst[i] = src[i];
    }
    if (first) {
      __syncwarp();
      cluster_arrive();
    }
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) {
      const long long j = start + i * kClusterThreads + threadIdx.x;
      h[i] = w[i] > 0 ? heights[base + j] : 0;
      k[i] = KINDS && w[i] > 0 ? kinds[base + j] : 0;
    }
    if (first && KINDS) cluster_wait();
#pragma unroll
    for (int i = 0; i < kFitnessItems; ++i) acc += probe_cost<KINDS, FAST32>(w[i], h[i], k[i], tables, st);
    if (first && !KINDS) cluster_wait();
    first = false;
    start += stride;
  } while (start < nb);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (ASYNC) {
    if (lane == 0) {
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n"
          : : "r"(rank0_address(&partials[rank * kClusterWarps + warp])), "l"(acc),
              "r"(rank0_address(&landed))
          : "memory");
    }
    if (rank != 0 || warp != 0) return;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(shared_address(&landed)) : "memory");
    }
  } else {
    if (lane == 0) cluster.map_shared_rank(&partials[0], 0)[rank * kClusterWarps + warp] = acc;
    cluster.sync();
    if (rank != 0 || warp != 0) return;
  }
  long long v = lane < static_cast<int>(s) * kClusterWarps ? partials[lane] : 0;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) totals[row] = v;
}

template <bool SYNC>
__global__ void empty_kernel(long long* out) {
  if (SYNC) cg::this_cluster().sync();
  if (out != nullptr && blockIdx.x == 0 && threadIdx.x == 0) out[0] = 0;
}

template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int blocks, int threads, int cluster,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  config.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&config, kernel, args...);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// K5 before its redesign (csrc/binpack_rows.cuh and the rolled kind_cost
// of csrc/kind_tables.cuh, both roles as they were), for the timings.
namespace first_design {

constexpr int kThreads = 256;

__device__ __forceinline__ long long kind_cost(int32_t w, int32_t h, int32_t k,
                                               const KindTables& t) {
  if (w <= 0 || k < 0 || k >= t.n_kinds) return 0;
  long long best = 0;
  for (int m = 0; m < t.n_modes[k]; ++m) {
    const uint32_t mw = static_cast<uint32_t>(t.mode_w[k][m]);
    const uint32_t md = static_cast<uint32_t>(t.mode_d[k][m]);
    const uint32_t cw = (static_cast<uint32_t>(w) + mw - 1u) / mw;
    const uint32_t ch = (static_cast<uint32_t>(h) + md - 1u) / md;
    const long long c = static_cast<long long>(cw) * ch;
    if (m == 0 || c < best) best = c;
  }
  return best * t.weight[k];
}

template <bool KINDS>
__device__ __forceinline__ void fitness_row(const int32_t* __restrict__ widths,
                                            const int32_t* __restrict__ heights,
                                            const int32_t* __restrict__ kinds,
                                            long long* __restrict__ totals, long long row,
                                            int nb, const KindTables& tables) {
  const long long base = row * nb;
  long long acc = 0;
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    const int32_t k = KINDS ? kinds[base + j] : 0;
    acc += kind_cost(widths[base + j], heights[base + j], k, tables);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) totals[row] = acc;
  }
}

template <bool KINDS>
__device__ __forceinline__ void sa_delta_row(const int32_t* __restrict__ old_w,
                                             const int32_t* __restrict__ old_h,
                                             const int32_t* __restrict__ old_k,
                                             const int32_t* __restrict__ new_w,
                                             const int32_t* __restrict__ new_h,
                                             const int32_t* __restrict__ new_k,
                                             long long* __restrict__ deltas, long long row,
                                             int t, const KindTables& tables) {
  const long long base = row * t;
  long long d = 0;
  for (int j = 0; j < t; ++j) {
    const long long i = base + j;
    const int32_t ko = KINDS ? old_k[i] : 0;
    const int32_t kn = KINDS ? new_k[i] : 0;
    d += kind_cost(new_w[i], new_h[i], kn, tables) - kind_cost(old_w[i], old_h[i], ko, tables);
  }
  deltas[row] = d;
}

template <bool KINDS>
__global__ void __launch_bounds__(kThreads)
portfolio_step_kernel(const int32_t* __restrict__ widths, const int32_t* __restrict__ heights,
                      const int32_t* __restrict__ kinds, long long* __restrict__ totals,
                      int n_rows, int nb, const int32_t* __restrict__ old_w,
                      const int32_t* __restrict__ old_h, const int32_t* __restrict__ old_k,
                      const int32_t* __restrict__ new_w, const int32_t* __restrict__ new_h,
                      const int32_t* __restrict__ new_k, long long* __restrict__ deltas,
                      int c, int t, const KindTables tables) {
  if (static_cast<int>(blockIdx.x) < n_rows) {
    fitness_row<KINDS>(widths, heights, kinds, totals, blockIdx.x, nb, tables);
    return;
  }
  const long long row = static_cast<long long>(blockIdx.x - n_rows) * kThreads + threadIdx.x;
  if (row >= c) return;
  sa_delta_row<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, deltas, row, t, tables);
}

}  // namespace first_design

// K3 / K4 before they took the shared slot cost (KindTables, run-time
// divisions), for the timings; the lane groups and the grid as the port's.
namespace kind_tables_design {

constexpr int kThreads = 128;

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

// the first warp copies the parameter (73 words), three words a lane
__device__ __forceinline__ void stage_kind_tables(KindTables& st, const KindTables& tables) {
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
}

template <bool KINDS>
__global__ void sa_step_lanes_kernel(const int32_t* __restrict__ old_w,
                                     const int32_t* __restrict__ old_h,
                                     const int32_t* __restrict__ old_k,
                                     const int32_t* __restrict__ new_w,
                                     const int32_t* __restrict__ new_h,
                                     const int32_t* __restrict__ new_k,
                                     long long* __restrict__ deltas, int c, int t,
                                     int log2_lanes, const __grid_constant__ KindTables tables) {
  __shared__ KindTables st;
  const int lanes = 1 << log2_lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const unsigned row = blockIdx.x * (blockDim.x >> log2_lanes) + (threadIdx.x >> log2_lanes);
  const long long base = static_cast<long long>(row) * t;
  const bool busy = row < static_cast<unsigned>(c) && lane < 2 * t;
  int32_t w = 0, h = 0, k = 0;
  if (busy) load_item<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, base, t, lane, w, h, k);
  stage_kind_tables(st, tables);
  __syncthreads();
  long long d = 0;
  if (busy) {
    const long long first = kind_cost_unrolled(w, h, k, st);
    d = lane < t ? first : -first;
    for (int j = lane + lanes; j < 2 * t; j += lanes) {
      load_item<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, base, t, j, w, h, k);
      const long long more = kind_cost_unrolled(w, h, k, st);
      d += j < t ? more : -more;
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (row < static_cast<unsigned>(c) && lane == 0) deltas[row] = d;
}

}  // namespace kind_tables_design

// K4 with its table staged in shared memory first, three ways (the port's
// K4 reads it from the parameter; the lane groups as the port's):
//   0  a loop, one word a thread a pass (five passes in a 32-thread block);
//   1  every thread's loads issued before any of its stores;
//   2  as 0 in blocks of at least 160 threads (one pass).
template <int V>
__global__ void k4_stage_kernel(const int32_t* __restrict__ old_w,
                                const int32_t* __restrict__ old_h,
                                const int32_t* __restrict__ old_k,
                                const int32_t* __restrict__ new_w,
                                const int32_t* __restrict__ new_h,
                                const int32_t* __restrict__ new_k,
                                long long* __restrict__ deltas, int c, int t, int log2_lanes,
                                const __grid_constant__ FitnessTables tables) {
  __shared__ __align__(16) FitnessTables st;
  const int lanes = 1 << log2_lanes;
  const int lane = threadIdx.x & (lanes - 1);
  const unsigned row = blockIdx.x * (blockDim.x >> log2_lanes) + (threadIdx.x >> log2_lanes);
  const long long base = static_cast<long long>(row) * t;
  const bool busy = row < static_cast<unsigned>(c) && lane < 2 * t;
  int32_t w = 0, h = 0, k = 0;
  if (busy) load_item<true>(old_w, old_h, old_k, new_w, new_h, new_k, base, t, lane, w, h, k);
  constexpr int kWords = sizeof(FitnessTables) / sizeof(int32_t);
  const int32_t* src = reinterpret_cast<const int32_t*>(&tables);
  int32_t* dst = reinterpret_cast<int32_t*>(&st);
  if (V == 0 || V == 2) {
    for (int i = threadIdx.x; i < kWords; i += blockDim.x) dst[i] = src[i];
  } else {
    constexpr int kPer = (kWords + 31) / 32;
    int32_t v[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      v[r] = i < kWords ? src[i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = threadIdx.x + r * blockDim.x;
      if (i < kWords) dst[i] = v[r];
    }
  }
  __syncthreads();
  auto cost = [&](int32_t sw, int32_t sh, int32_t sk) {
    return fitness_slot_cost<true>(sw, sh, sk, st);
  };
  long long d = 0;
  if (busy) {
    const long long first = cost(w, h, k);
    d = lane < t ? first : -first;
    for (int j = lane + lanes; j < 2 * t; j += lanes) {
      load_item<true>(old_w, old_h, old_k, new_w, new_h, new_k, base, t, j, w, h, k);
      const long long more = cost(w, h, k);
      d += j < t ? more : -more;
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (row < static_cast<unsigned>(c) && lane == 0) deltas[row] = d;
}

// The port's K5 under the other register bound.
template <bool KINDS>
__global__ void __launch_bounds__(kFitnessThreads, KINDS ? 1 : 2)
k5_other_bound_kernel(const int32_t* __restrict__ widths, const int32_t* __restrict__ heights,
                     const int32_t* __restrict__ kinds, long long* __restrict__ totals,
                     int n_rows, int nb, const int32_t* __restrict__ old_w,
                     const int32_t* __restrict__ old_h, const int32_t* __restrict__ old_k,
                     const int32_t* __restrict__ new_w, const int32_t* __restrict__ new_h,
                     const int32_t* __restrict__ new_k, long long* __restrict__ deltas,
                     int c, int t, int log2_lanes,
                     const __grid_constant__ FitnessTables tables) {
  if (static_cast<int>(blockIdx.x) < n_rows) {
    fitness_row<KINDS>(widths, heights, kinds, totals, nb, tables);
    return;
  }
  sa_lanes_rows<KINDS>(old_w, old_h, old_k, new_w, new_h, new_k, deltas, c, t, log2_lanes,
                       blockIdx.x - n_rows, tables);
}

}  // namespace

// K5 before its redesign: `kinds` selects K5b (kind pointers may be null
// without it).  No launch for an empty grid.
extern "C" int probe_old_k5_launch(int kinds, const int32_t* w, const int32_t* h,
                                   const int32_t* k, long long* totals, int n_rows, int nb,
                                   const int32_t* ow, const int32_t* oh, const int32_t* ok,
                                   const int32_t* nw, const int32_t* nh, const int32_t* nk,
                                   long long* deltas, int c, int t, const KindTables* tables,
                                   cudaStream_t stream) {
  using first_design::kThreads;
  const int blocks = n_rows + (c + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  if (kinds) {
    first_design::portfolio_step_kernel<true><<<blocks, kThreads, 0, stream>>>(
        w, h, k, totals, n_rows, nb, ow, oh, ok, nw, nh, nk, deltas, c, t, *tables);
  } else {
    first_design::portfolio_step_kernel<false><<<blocks, kThreads, 0, stream>>>(
        w, h, k, totals, n_rows, nb, ow, oh, ok, nw, nh, nk, deltas, c, t, *tables);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 / K4 before they took the shared slot cost; `kinds` selects K4 (kind
// pointers may be null without it).  The grid as the port's K3 / K4.
extern "C" int probe_old_k34_launch(int kinds, const int32_t* ow, const int32_t* oh,
                                    const int32_t* ok, const int32_t* nw, const int32_t* nh,
                                    const int32_t* nk, long long* deltas, int c, int t,
                                    const KindTables* tables, cudaStream_t stream) {
  using kind_tables_design::kThreads;
  if (c <= 0) return 0;
  const int lg = sa_lanes_log2(t);
  const long long want = (static_cast<long long>(c) << lg) + 31;
  const int threads = static_cast<int>(want / 32 * 32 < kThreads ? want / 32 * 32 : kThreads);
  const int blocks = (c + (threads >> lg) - 1) / (threads >> lg);
  if (kinds) {
    kind_tables_design::sa_step_lanes_kernel<true><<<blocks, threads, 0, stream>>>(
        ow, oh, ok, nw, nh, nk, deltas, c, t, lg, *tables);
  } else {
    kind_tables_design::sa_step_lanes_kernel<false><<<blocks, threads, 0, stream>>>(
        ow, oh, ok, nw, nh, nk, deltas, c, t, lg, *tables);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 with its table staged, variant 0-2 (k4_stage_kernel).
extern "C" int probe_k4_stage_launch(int variant, const int32_t* ow, const int32_t* oh,
                                     const int32_t* ok, const int32_t* nw, const int32_t* nh,
                                     const int32_t* nk, long long* deltas, int c, int t,
                                     const FitnessTables* tables, cudaStream_t stream) {
  if (c <= 0) return 0;
  const int lg = sa_lanes_log2(t);
  const long long want = (static_cast<long long>(c) << lg) + 31;
  int threads = static_cast<int>(want / 32 * 32 < 128 ? want / 32 * 32 : 128);
  if (variant == 2 && threads < 160) threads = 160;
  const int blocks = (c + (threads >> lg) - 1) / (threads >> lg);
#define PROBE_K4(V)                                                                         \
  case V:                                                                                   \
    k4_stage_kernel<V><<<blocks, threads, 0, stream>>>(ow, oh, ok, nw, nh, nk, deltas, c, t, \
                                                        lg, *tables);                      \
    break;
  switch (variant) {
    PROBE_K4(0)
    PROBE_K4(1)
    PROBE_K4(2)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROBE_K4
  return static_cast<int>(cudaGetLastError());
}

// The port's K5 under the other register bound; the grid as the port's.
extern "C" int probe_k5_other_bound_launch(int kinds, const int32_t* w, const int32_t* h,
                                          const int32_t* k, long long* totals, int n_rows,
                                          int nb, const int32_t* ow, const int32_t* oh,
                                          const int32_t* ok, const int32_t* nw,
                                          const int32_t* nh, const int32_t* nk,
                                          long long* deltas, int c, int t,
                                          const FitnessTables* tables, cudaStream_t stream) {
  const int lg = sa_lanes_log2(t);
  const int per_block = kFitnessThreads >> lg;
  const int blocks = n_rows + (c + per_block - 1) / per_block;
  if (blocks == 0) return 0;
  if (kinds) {
    k5_other_bound_kernel<true><<<blocks, kFitnessThreads, 0, stream>>>(
        w, h, k, totals, n_rows, nb, ow, oh, ok, nw, nh, nk, deltas, c, t, lg, *tables);
  } else {
    k5_other_bound_kernel<false><<<blocks, kFitnessThreads, 0, stream>>>(
        w, h, k, totals, n_rows, nb, ow, oh, ok, nw, nh, nk, deltas, c, t, lg, *tables);
  }
  return static_cast<int>(cudaGetLastError());
}

// variant: bit 0 FAST32
extern "C" int probe_block_row_launch(int variant, const int32_t* w, const int32_t* h,
                                      const int32_t* k, long long* totals, int p, int nb,
                                      const FitnessTables* tables, int kinds,
                                      cudaStream_t stream) {
  const FitnessTables t = *tables;
  if (variant & 1) {
    if (kinds) block_row_kernel<true, true><<<p, kFitnessThreads, 0, stream>>>(w, h, k, totals, nb, t);
    else block_row_kernel<false, true><<<p, kFitnessThreads, 0, stream>>>(w, h, k, totals, nb, t);
  } else {
    if (kinds) block_row_kernel<true, false><<<p, kFitnessThreads, 0, stream>>>(w, h, k, totals, nb, t);
    else block_row_kernel<false, false><<<p, kFitnessThreads, 0, stream>>>(w, h, k, totals, nb, t);
  }
  return static_cast<int>(cudaGetLastError());
}

// variant: bit 0 FAST32, bit 1 ASYNC
extern "C" int probe_cluster_launch(int variant, const int32_t* w, const int32_t* h,
                                    const int32_t* k, long long* totals, int p, int nb,
                                    const FitnessTables* tables, int kinds,
                                    cudaStream_t stream) {
  const int s = cluster_blocks(nb);
  const FitnessTables t = *tables;
#define PROBE_CASE(V, F, A)                                                                 \
  case V:                                                                                   \
    return kinds ? launch_clusters(cluster_kernel<true, F, A>, p * s, kClusterThreads, s,  \
                                   stream, w, h, k, totals, nb, t)                          \
                 : launch_clusters(cluster_kernel<false, F, A>, p * s, kClusterThreads, s, \
                                   stream, w, h, k, totals, nb, t);
  switch (variant) {
    PROBE_CASE(0, false, false)
    PROBE_CASE(1, true, false)
    PROBE_CASE(2, false, true)
    PROBE_CASE(3, true, true)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PROBE_CASE
}

// cluster <= 0: a plain launch
extern "C" int probe_empty_launch(int blocks, int threads, int cluster, int sync,
                                  cudaStream_t stream) {
  long long* none = nullptr;
  if (cluster <= 0) {
    empty_kernel<false><<<blocks, threads, 0, stream>>>(none);
    return static_cast<int>(cudaGetLastError());
  }
  return sync ? launch_clusters(empty_kernel<true>, blocks, threads, cluster, stream, none)
              : launch_clusters(empty_kernel<false>, blocks, threads, cluster, stream, none);
}
