// K6: fused read of one packed parameter bank (segment matvec).
//
// Replaces the Pallas TPU kernel in src/repro/kernels/packed_gather/kernel.py:
//   K6 packed_gather_matvec (body _packed_gather_kernel)
// Several logical weight matrices share one (R, C) float32 bank row-wise;
// seg[r] names the logical buffer row r belongs to, and x holds one
// activation vector per logical buffer:
//
//   y[r] = sum_c bank[r, c] * x[seg[r], c]     (0 where seg[r] is outside [0, N))
//
// Bound on an H100 SXM: the bank is read once and each of its elements is
// used in one FMA, so the function moves 4*R*C + 4*N*C + 8*R bytes for 2*R*C
// flops -- 0.5 flop per byte, far below the card's ~20 float32 flops per byte
// of device memory: bound by bytes.  The design keeps every bank byte to one
// coalesced 16-byte load and nothing else: one warp per bank row (8 rows per
// block, the reference's ROW_TILE), the row's segment id read once by lane 0
// and broadcast, the row and x[seg] streamed as float4 (C % 128 == 0, so a
// warp covers 512 bytes of each per step), float32 FMAs, a shuffle
// reduction.  The bank is loaded with the streaming hint (read once); x's
// few rows stay in L1/L2 for every bank row that reads them.  The Pallas
// kernel's loop over all N segments with a per-row select is not carried
// over: a row computes only its own segment.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

__global__ void __launch_bounds__(kThreads)
packed_gather_kernel(const float4* __restrict__ bank, const float4* __restrict__ x,
                     const int32_t* __restrict__ seg, float* __restrict__ y,
                     int r, int c4, int n) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= r) return;  // uniform per warp
  int s = 0;
  if (lane == 0) s = seg[row];
  s = __shfl_sync(0xffffffffu, s, 0);
  float acc = 0.0f;
  if (s >= 0 && s < n) {
    const float4* brow = bank + row * c4;
    const float4* xrow = x + static_cast<long long>(s) * c4;
    for (int i = lane; i < c4; i += 32) {
      const float4 b = __ldcs(brow + i);
      const float4 v = __ldg(xrow + i);
      acc = fmaf(b.x, v.x, acc);
      acc = fmaf(b.y, v.y, acc);
      acc = fmaf(b.z, v.z, acc);
      acc = fmaf(b.w, v.w, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

}  // namespace

// Plain C entry point (loaded with ctypes; no PyTorch headers).  The
// wrapper has checked shapes, types, contiguity and 16-byte alignment.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int packed_gather_launch(const float* bank, const float* x,
                                    const int32_t* seg, float* y, int r, int c,
                                    int n, cudaStream_t stream) {
  if (r <= 0) return 0;
  const int blocks = (r + kRowsPerBlock - 1) / kRowsPerBlock;
  packed_gather_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(bank), reinterpret_cast<const float4*>(x),
      seg, y, r, c / 4, n);
  return static_cast<int>(cudaGetLastError());
}
