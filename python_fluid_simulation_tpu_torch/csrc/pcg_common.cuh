// Shared pieces of the cell-stencil kernels: the 7-point stencil, and the
// block / grid reductions and grid sizing of the persistent cooperative
// kernels.
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

#include <mutex>

namespace pfs {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The 7-point cell-centred operator: loop-invariant diagonal and six
// coefficient fields on an X x Y x Z grid (z fastest), or on B such
// grids stacked along a leading batch axis (B independent systems, as
// the three axis blocks of the viscosity V-cycle).
struct Stencil7 {
  const float* diag;
  const float* coef[6];  // offsets +x, -x, +y, -y, +z, -z
  int X, Y, Z;
  int B;  // systems in the stack (1: one grid)
};

// (A p)[i] = diag p + sum_k coef_k p[i + off_k], neighbours outside the
// grid read 0.  Every product and sum is rounded on its own (no FMA
// contraction), in the order of the plain PyTorch version
// (ops/cuda_stencils.py::stencil_matvec_plain): diag*p first, then the
// six terms in offset order, so the result is bitwise that version's.
// p is read through L2 (__ldcg): inside a persistent kernel other blocks
// wrote it before the last grid barrier.
// kBatched: i runs over B stacked grids and the x bounds are those of
// the grid that holds i (a batch index of its own, so no neighbour read
// crosses from one system into the next); otherwise B is 1 and x = i / YZ.
template <bool kBatched = false>
__device__ __forceinline__ float stencil7(const Stencil7& s, const float* p,
                                          long i) {
  const long yz = (long)s.Y * s.Z;
  const int cz = (int)(i % s.Z);
  const int cy = (int)((i / s.Z) % s.Y);
  const int cx = kBatched ? (int)((i / yz) % s.X) : (int)(i / yz);
  float acc = __fmul_rn(s.diag[i], __ldcg(p + i));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[0][i], cx + 1 < s.X ? __ldcg(p + i + yz) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[1][i], cx > 0 ? __ldcg(p + i - yz) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[2][i], cy + 1 < s.Y ? __ldcg(p + i + s.Z) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[3][i], cy > 0 ? __ldcg(p + i - s.Z) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[4][i], cz + 1 < s.Z ? __ldcg(p + i + 1) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[5][i], cz > 0 ? __ldcg(p + i - 1) : 0.f));
  return acc;
}

// Stencil7 from the C interface's seven field pointers.
inline Stencil7 make_stencil7(const void* diag, const void* cxp,
                              const void* cxm, const void* cyp,
                              const void* cym, const void* czp,
                              const void* czm, int X, int Y, int Z,
                              int B = 1) {
  Stencil7 s;
  s.diag = static_cast<const float*>(diag);
  s.coef[0] = static_cast<const float*>(cxp);
  s.coef[1] = static_cast<const float*>(cxm);
  s.coef[2] = static_cast<const float*>(cyp);
  s.coef[3] = static_cast<const float*>(cym);
  s.coef[4] = static_cast<const float*>(czp);
  s.coef[5] = static_cast<const float*>(czm);
  s.X = X;
  s.Y = Y;
  s.Z = Z;
  s.B = B;
  return s;
}

// Block-wide sum of one value (float, or int) over a kBlock-thread
// block; the result is returned to every thread.  `sh` needs
// kBlock / 32 + 1 values.
template <int kBlock = kThreads, typename T = float>
__device__ __forceinline__ T block_sum(T v, T* sh) {
  constexpr int kBlockWarps = kBlock / 32;
  static_assert(kBlock % 32 == 0 && kBlockWarps <= 32, "one warp sums the warps' sums");
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlockWarps ? sh[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) sh[kBlockWarps] = v;
  }
  __syncthreads();
  const T total = sh[kBlockWarps];
  __syncthreads();
  return total;
}

// Exclusive prefix sum of one int a thread over a kBlock-thread block,
// in thread order; *total gets the block's sum.  `sh` holds
// kBlock / 32 + 1 ints.
template <int kBlock = kThreads>
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh, int* total) {
  constexpr int kBlockWarps = kBlock / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < kBlockWarps ? sh[lane] : 0;
    int si = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, si, o);
      if (lane >= o) si += t;
    }
    if (lane < kBlockWarps) sh[lane] = si - s;
    if (lane == kBlockWarps - 1) sh[kBlockWarps] = si;
  }
  __syncthreads();
  const int out = sh[warp] + incl - v;
  *total = sh[kBlockWarps];
  __syncthreads();
  return out;
}

// Grid-wide total of per-block partials part[j * stride + k] for
// j < nblocks, summed in the same order by every block.  The partials
// were written by other SMs before the last grid barrier, so they are
// read through L2 (__ldcg), never from a possibly stale L1 line.
template <int kBlock = kThreads>
__device__ __forceinline__ float grid_total(const float* part, int nblocks,
                                            int stride, int k, float* sh) {
  float v = 0.f;
  for (int j = threadIdx.x; j < nblocks; j += kBlock)
    v += __ldcg(part + (long)j * stride + k);
  return block_sum<kBlock>(v, sh);
}

// Resident blocks a SM of `kernel` in blocks of `block` threads with
// `smem` bytes of dynamic shared memory, and the SM count, on the current
// device.  The device queries (SM count, occupancy calculator) run once
// per (device, kernel, block, smem) and are cached, so a launch repeats
// none of them.  Above the default 48 KB the kernel's dynamic shared
// memory limit is raised first (never lowered below an earlier entry's),
// so the occupancy query counts what the launch will ask for.
inline cudaError_t coop_capacity(const void* kernel, int block, int smem, int* per_sm, int* sms) {
  struct Entry {
    int dev;
    const void* kernel;
    int block, smem, per_sm, sms;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int j = 0; j < used; ++j) {
    const Entry& c = cache[j];
    if (c.dev == dev && c.kernel == kernel && c.block == block && c.smem == smem) {
      *per_sm = c.per_sm;
      *sms = c.sms;
      return cudaSuccess;
    }
  }
  int n_sm = 0, p = 0, raised = 48 * 1024;  // the kernel's limit: the largest smem asked for so far
  for (int j = 0; j < used; ++j)
    if (cache[j].dev == dev && cache[j].kernel == kernel && cache[j].smem > raised) raised = cache[j].smem;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (smem > raised) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p, kernel, block, smem);
  if (e != cudaSuccess) return e;
  if (used < kEntries) cache[used++] = Entry{dev, kernel, block, smem, p, n_sm};
  *per_sm = p;
  *sms = n_sm;
  return cudaSuccess;
}

// Grid size for a cooperative launch of `kernel` in blocks of `block`
// threads with `smem` bytes of dynamic shared memory: every block
// resident at once (blocks per SM from the occupancy calculator x SM
// count, `coop_capacity`), and no more blocks than there are elements to
// cover.
template <typename Kernel>
inline cudaError_t coop_grid(Kernel kernel, long n, int* grid, int block = kThreads, int smem = 0) {
  int per_sm = 0, sms = 0;
  cudaError_t e = coop_capacity((const void*)kernel, block, smem, &per_sm, &sms);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  long need = (n + block - 1) / block;
  long g = (long)per_sm * sms;
  if (need < g) g = need;
  if (g < 1) g = 1;
  *grid = (int)g;
  return cudaSuccess;
}

}  // namespace pfs
