// Shared pieces of the persistent cooperative PCG kernels.
//
// Each solve is ONE cooperative launch that keeps the whole Jacobi-PCG
// loop on the device.  Phases are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()).  Dot products are reduced
// per block into a scratch array of partials; after the barrier EVERY
// block sums all partials in the same fixed order, so the scalars alpha,
// beta and the exit test are bitwise identical in all blocks (every
// block takes the same branch of the loop) and repeatable from run to
// run — no atomics anywhere.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace pfs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Block-wide sum of one value; the result is returned to every thread.
// `sh` needs kWarps + 1 floats.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? sh[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sh[kWarps] = v;
  }
  __syncthreads();
  const float total = sh[kWarps];
  __syncthreads();
  return total;
}

// Grid-wide total of per-block partials part[j * stride + k] for
// j < nblocks, summed in the same order by every block.  The partials
// were written by other SMs before the last grid barrier, so they are
// read through L2 (__ldcg), never from a possibly stale L1 line.
__device__ __forceinline__ float grid_total(const float* part, int nblocks,
                                            int stride, int k, float* sh) {
  float v = 0.f;
  for (int j = threadIdx.x; j < nblocks; j += kThreads)
    v += __ldcg(part + (long)j * stride + k);
  return block_sum(v, sh);
}

// Grid size for a cooperative launch of `kernel`: every block resident
// at once (blocks per SM from the occupancy calculator x SM count), and
// no more blocks than there are elements to cover.
template <typename Kernel>
inline cudaError_t coop_grid(Kernel kernel, long n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long need = (n + kThreads - 1) / kThreads;
  long g = (long)per_sm * sms;
  if (need < g) g = need;
  if (g < 1) g = 1;
  *grid = (int)g;
  return cudaSuccess;
}

}  // namespace pfs
