// The designs K1 / K2's redesign (src/repro_torch/kernels/csrc/
// binpack_fitness.cu, included below) was chosen over, built and timed
// beside it by tools/fitness_design_probe.py.  Nothing in src/ builds or
// calls this file.
//
//   block_row_kernel  the port's design (one 1024-thread block per row)
//                     with its 32-bit product path switchable (FAST32);
//                     <true> is the port's kernel;
//   cluster_kernel    each row over a thread-block cluster of up to 8
//                     blocks of 128 threads (512 slots a block), the warps'
//                     partials summed in the rank-0 block's shared memory:
//                     with ASYNC by `st.async` stores completing an
//                     mbarrier there (only rank 0 waits), else by plain
//                     distributed-shared-memory stores and one
//                     cluster.sync(); FAST32 as above;
//   empty_kernel      a launch alone, plain or as clusters, with or without
//                     one cluster barrier.
#include <cooperative_groups.h>

#include "binpack_fitness.cu"

namespace cg = cooperative_groups;

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
__global__ void __launch_bounds__(kThreads)
block_row_kernel(const int32_t* __restrict__ widths, const int32_t* __restrict__ heights,
                 const int32_t* __restrict__ kinds, long long* __restrict__ totals, int nb,
                 const __grid_constant__ FitnessTables tables) {
  __shared__ long long partials[kThreads / 32];
  __shared__ __align__(16) FitnessTables st;
  const long long base = static_cast<long long>(blockIdx.x) * nb;
  long long acc = 0;
  for (long long start = 0; start < nb || start == 0; start += kChunk) {
    int32_t w[kItems], h[kItems], k[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long j = start + i * kThreads + threadIdx.x;
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
    for (int i = 0; i < kItems; ++i) {
      const long long j = start + i * kThreads + threadIdx.x;
      h[i] = w[i] > 0 ? heights[base + j] : 0;
      k[i] = KINDS && w[i] > 0 ? kinds[base + j] : 0;
    }
    if (KINDS && start == 0) __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) acc += probe_cost<KINDS, FAST32>(w[i], h[i], k[i], tables, st);
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
constexpr int kClusterChunk = kClusterThreads * kItems;  // 512 slots a block
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
  int32_t w[kItems], h[kItems], k[kItems];
  long long acc = 0;
  long long start = static_cast<long long>(rank) * kClusterChunk;
  bool first = true;
  do {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
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
    for (int i = 0; i < kItems; ++i) {
      const long long j = start + i * kClusterThreads + threadIdx.x;
      h[i] = w[i] > 0 ? heights[base + j] : 0;
      k[i] = KINDS && w[i] > 0 ? kinds[base + j] : 0;
    }
    if (first && KINDS) cluster_wait();
#pragma unroll
    for (int i = 0; i < kItems; ++i) acc += probe_cost<KINDS, FAST32>(w[i], h[i], k[i], tables, st);
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

}  // namespace

// variant: bit 0 FAST32
extern "C" int probe_block_row_launch(int variant, const int32_t* w, const int32_t* h,
                                      const int32_t* k, long long* totals, int p, int nb,
                                      const FitnessTables* tables, int kinds,
                                      cudaStream_t stream) {
  const FitnessTables t = *tables;
  if (variant & 1) {
    if (kinds) block_row_kernel<true, true><<<p, kThreads, 0, stream>>>(w, h, k, totals, nb, t);
    else block_row_kernel<false, true><<<p, kThreads, 0, stream>>>(w, h, k, totals, nb, t);
  } else {
    if (kinds) block_row_kernel<true, false><<<p, kThreads, 0, stream>>>(w, h, k, totals, nb, t);
    else block_row_kernel<false, false><<<p, kThreads, 0, stream>>>(w, h, k, totals, nb, t);
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
