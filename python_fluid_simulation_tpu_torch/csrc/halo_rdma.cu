// Width-1 halo exchange along array axis 0 of a ring of slot blocks, by
// remote push.
//
// Replaces python_fluid_simulation_tpu/parallel/halo_rdma.py::
// halo_exchange_rdma (its Pallas _kernel): each slot's output is its block
// x (n, plane) framed by one plane on each side, out (n + 2, plane), with
// row 0 = the left neighbour's top plane, row n + 1 = the right
// neighbour's bottom plane, and zeros at the ends of the ring (the domain
// boundary).  The TPU kernel pushes its two edge planes into the
// neighbours' output buffers with remote DMAs after an entry barrier on a
// barrier semaphore; this kernel does the same with plain stores through
// the neighbours' output pointers and system-scope atomic counters, so the
// code is the same whether a neighbour's buffer is on this card or is a
// peer pointer to another card: the route of rings that span cards, each
// slot's launch on its own card, its pushes and the counters (all on slot
// 0's card) crossing NVLink as peer stores and system-scope atomics
// (pfs_enable_peer opens every pair a ring or the counters span).
//
// One launch a slot, each on its slot's own stream (parallel/halo_rdma.py
// enqueues every launch of an exchange before any of its completion events,
// so no slot's launch queues behind another's).  Each launch:
//   0. reads its slot's counters (device memory on the slot's own card):
//      the exchanges along this axis so far and the blocks the slot has
//      launched over them; this exchange's epoch is one more, and its
//      receive target that block sum plus this launch's grid;
//   1. copies its interior into out[1 : n + 1] and writes zeros into
//      out[0] (first slot) and out[n + 1] (last slot);
//   2. entry barrier: block 0 adds one to each live neighbour's arrival
//      counter; every block waits until its own counter reaches
//      epoch * (live neighbours);
//   3. pushes its top plane into the right neighbour's out[0] and its
//      bottom plane into the left neighbour's out[n + 1], grid-stride;
//   4. every thread fences its stores (__threadfence_system), the block
//      synchronises, and thread 0 adds one to the receiver's counter:
//      receives are counted in units of blocks, and every block's share
//      is fenced before its count moves;
//   5. block 0 waits until each live receive counter reaches the receive
//      target, the blocks a neighbour has launched over all of this axis's
//      exchanges so far (every slot of an exchange has the same grid, and
//      the grid may change between exchanges), so the launch ends only
//      once both neighbours' planes have landed;
//   6. the last of its blocks to finish (counted on the slot's third
//      counter, which it sets back to 0) writes the epoch and the receive
//      target back as the slot's counters: every block read them in step
//      0 before it counted itself, and the next launch on the slot's
//      stream reads them after this one has ended.
// Both counters grow with every exchange and no counter is ever reset;
// comparisons are wrap-safe.  They live in device memory, so a launch
// recorded into a CUDA graph (or the body of a WHILE node) takes a fresh
// epoch every time it runs, as an eager launch does.

// Deadlock: the launches of an exchange spin on each other, so all must be
// resident at once.  The grid is small (parallel/halo_rdma.py caps the
// blocks of all launches of an exchange at half of what the card holds,
// from the SM count and the occupancy queried once a process,
// pfs_halo_grid_cap), and every spin is bounded: after kTimeoutNs it
// writes the error word and traps, so a lost signal fails the run instead
// of hanging the card.
//
// What bounds it: bytes.  It reads the block once and writes the block and
// the two frame planes once (the edge planes are read twice); no
// arithmetic.  On one card both pushes are device-memory copies, so the
// exchange's bound is (n + 2 + n) * plane * 4 bytes a slot at 3.35 TB/s;
// across cards each slot also sends one plane a direction over NVLink, at
// most 450 GB/s each way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRing = 64;
constexpr unsigned long long kTimeoutNs = 10ull * 1000ull * 1000ull * 1000ull;  // 10 s
// counters of a ring position
constexpr int kArrive = 0;
constexpr int kFromLeft = 1;
constexpr int kFromRight = 2;

struct Ring {
  float* out[kMaxRing];  // every ring position's output, allocated before any launch
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned int load_acquire_sys(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Spin until *ctr has reached target (wrap-safe); on timeout write `code`
// into the error word and trap.
__device__ void wait_reach(const unsigned int* ctr, unsigned int target, int* err, int code) {
  const unsigned long long t0 = now_ns();
  while ((int)(load_acquire_sys(ctr) - target) < 0) {
    if (now_ns() - t0 > kTimeoutNs) {
      atomicExch_system(err, code);
      __threadfence_system();
      __trap();
    }
    __nanosleep(64);
  }
}

// The slot's own counters (on its card): the epoch and the block sum of the
// last exchange, and the blocks of the running launch that have finished.
constexpr int kEpoch = 0;
constexpr int kBlocks = 1;
constexpr int kFinished = 2;

__global__ void __launch_bounds__(kThreads)
    halo_push_kernel(const __grid_constant__ Ring ring, const float* __restrict__ x,
                     unsigned int* __restrict__ sem, int* __restrict__ err, unsigned int* __restrict__ mine_ctr,
                     int pos, int size, long long n, long long plane) {
  // 0. this exchange's epoch and receive target
  __shared__ unsigned int s_epoch, s_target;
  if (threadIdx.x == 0) {
    s_epoch = mine_ctr[kEpoch] + 1u;
    s_target = mine_ctr[kBlocks] + gridDim.x;
  }
  __syncthreads();
  const unsigned int epoch = s_epoch, recv_target = s_target;
  float* out = ring.out[pos];
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool has_left = pos > 0;
  const bool has_right = pos < size - 1;

  // 1. the interior, and zeros at the ends of the ring
  for (long long i = tid; i < n * plane; i += stride) out[plane + i] = x[i];
  if (!has_left)
    for (long long i = tid; i < plane; i += stride) out[i] = 0.f;
  if (!has_right)
    for (long long i = tid; i < plane; i += stride) out[(n + 1) * plane + i] = 0.f;

  // 2. entry barrier with both neighbours
  unsigned int* mine = sem + 3 * pos;
  if (threadIdx.x == 0) {
    if (blockIdx.x == 0) {
      if (has_left) atomicAdd_system(sem + 3 * (pos - 1) + kArrive, 1u);
      if (has_right) atomicAdd_system(sem + 3 * (pos + 1) + kArrive, 1u);
    }
    wait_reach(mine + kArrive, epoch * (unsigned int)(has_left + has_right), err, 1);
  }
  __syncthreads();

  // 3. the pushes
  if (has_right) {
    float* dst = ring.out[pos + 1];
    for (long long i = tid; i < plane; i += stride) dst[i] = x[(n - 1) * plane + i];
  }
  if (has_left) {
    float* dst = ring.out[pos - 1] + (n + 1) * plane;
    for (long long i = tid; i < plane; i += stride) dst[i] = x[i];
  }

  // 4. fence every thread's stores, then one count a block on each receiver
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) {
    if (has_right) atomicAdd_system(sem + 3 * (pos + 1) + kFromLeft, 1u);
    if (has_left) atomicAdd_system(sem + 3 * (pos - 1) + kFromRight, 1u);
  }

  // 5. wait for every block of each live neighbour
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (has_left) wait_reach(mine + kFromLeft, recv_target, err, 2);
    if (has_right) wait_reach(mine + kFromRight, recv_target, err, 3);
    __threadfence_system();
  }

  // 6. the last block to finish advances the slot's counters
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(mine_ctr + kFinished, 1u) == gridDim.x - 1) {
      mine_ctr[kEpoch] = epoch;
      mine_ctr[kBlocks] = recv_target;
      mine_ctr[kFinished] = 0u;
      __threadfence();
    }
  }
}

}  // namespace

// The card's SM count and how many blocks of the kernel an SM holds
// (queried once a process by the caller; also loads the kernel, so no
// launch of an exchange waits on a module load).
extern "C" int pfs_halo_grid_cap(int* sms, int* blocks_per_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, halo_push_kernel, kThreads, 0);
  return (int)e;
}

// Let the current device's kernels reach `peer`'s memory (one direction).
// Already enabled (by this library or by PyTorch's own peer copies) is
// not an error; the sticky error it leaves is cleared.
extern "C" int pfs_enable_peer(int peer) {
  int dev = 0, can = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  return (int)e;
}

// One slot's launch (on a stream of the current device, the slot's).  outs: host array of the ring's `size` output
// pointers, by ring position; sem: this ring's 3 * size counters; err: the
// axis's error word; counters: the slot's own three (epoch, block sum,
// finished blocks) on its device.
extern "C" int pfs_halo_exchange(const void* x, const void* outs, void* sem, void* err, void* counters, int pos,
                                 int size, long long n, long long plane, int grid, void* stream) {
  if (size < 1 || size > kMaxRing || pos < 0 || pos >= size || n < 1 || plane < 1 || grid < 1)
    return (int)cudaErrorInvalidValue;
  Ring ring;
  const uint64_t* table = static_cast<const uint64_t*>(outs);
  for (int i = 0; i < kMaxRing; ++i) ring.out[i] = i < size ? reinterpret_cast<float*>(table[i]) : nullptr;
  halo_push_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, static_cast<const float*>(x), static_cast<unsigned int*>(sem), static_cast<int*>(err),
      static_cast<unsigned int*>(counters), pos, size, n, plane);
  return (int)cudaGetLastError();
}
