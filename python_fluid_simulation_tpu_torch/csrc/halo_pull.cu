// Width-1 halo exchange along array axis 0 of rings of slot blocks that all
// sit on one device: one launch a device an exchange, every slot's output
// pulled whole.
//
// Replaces python_fluid_simulation_tpu/parallel/halo_rdma.py::
// halo_exchange_rdma (its Pallas _kernel) for the rings of a mesh whose
// slots share a device -- on a one-card machine every ring of every mesh:
// each slot's output is its block x (n, plane) framed by one plane on each
// side, out (n + 2, plane), row 0 = the left neighbour's top plane, row
// n + 1 = the right neighbour's bottom plane, zeros at the ends of the
// ring.  The TPU kernel pushes its edge planes into the neighbours'
// buffers after an entry barrier, as csrc/halo_rdma.cu does for rings that
// span devices.  On one device nothing needs a barrier: every input block
// is complete in stream order before the launch, so each output is written
// whole by reading, element by element, what belongs there:
//
//   e <  plane               the left neighbour's row n - 1 (0 at a ring's start)
//   e <  (n + 1) * plane     the slot's own x[e - plane]
//   otherwise                the right neighbour's row 0 (0 at a ring's end)
//
// The host hands one table a launch (__grid_constant__): for every slot of
// the device, its block, the left neighbour's top plane, the right
// neighbour's bottom plane (null at the ring's ends) and its output.  So a
// (2, 2) mesh's two rings are one launch, and the launch needs no streams,
// events, counters or fences of its own: it runs on the caller's stream.
// blockIdx.y is the table's entry, blockIdx.x strides over its output.
//
// What bounds it: bytes.  It reads each block and the two frame planes
// once and writes each output once, (2n + 2) * plane * 4 bytes a slot at
// 3.35 TB/s; no arithmetic.  16-byte vectors (V = float4) where the plane
// is a multiple of 4 floats and every pointer is 16-byte aligned (the
// wrapper picks, parallel/halo_rdma.py::vector_floats), 4-byte scalars
// otherwise.  The grid is sized to the work, at most the blocks the card
// holds at once; nothing spins, so no cap below that is needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pcg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSlots = 64;  // slots of one device a launch

struct PullSlot {
  const float* x;   // the slot's block, (n, plane)
  const float* lo;  // the left neighbour's row n - 1, or null
  const float* hi;  // the right neighbour's row 0, or null
  float* out;       // (n + 2, plane)
};

struct PullTable {
  PullSlot slot[kMaxSlots];
};

// n and plane in units of V
template <typename V>
__global__ void __launch_bounds__(kThreads)
    halo_pull_kernel(const __grid_constant__ PullTable table, long long n, long long plane) {
  const PullSlot& s = table.slot[blockIdx.y];
  const V* x = reinterpret_cast<const V*>(s.x);
  const V* lo = reinterpret_cast<const V*>(s.lo);
  const V* hi = reinterpret_cast<const V*>(s.hi);
  V* out = reinterpret_cast<V*>(s.out);
  const long long interior = (n + 1) * plane, total = (n + 2) * plane;
  const long long stride = (long long)gridDim.x * kThreads;
  const V zero{};
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < total; e += stride) {
    V v;
    if (e < plane)
      v = lo ? lo[e] : zero;
    else if (e < interior)
      v = x[e - plane];
    else
      v = hi ? hi[e - interior] : zero;
    out[e] = v;
  }
}

// The launch on the current device: the table copied into the kernel's
// parameter, the grid from the resident blocks.
cudaError_t launch_pull(const void* table, int slots, long long n, long long plane, int vec, cudaStream_t st) {
  PullTable t;
  const uint64_t* p = static_cast<const uint64_t*>(table);
  for (int i = 0; i < kMaxSlots; ++i) {
    t.slot[i].x = i < slots ? reinterpret_cast<const float*>(p[4 * i]) : nullptr;
    t.slot[i].lo = i < slots ? reinterpret_cast<const float*>(p[4 * i + 1]) : nullptr;
    t.slot[i].hi = i < slots ? reinterpret_cast<const float*>(p[4 * i + 2]) : nullptr;
    t.slot[i].out = i < slots ? reinterpret_cast<float*>(p[4 * i + 3]) : nullptr;
    if (vec == 4 && i < slots)
      for (int j = 0; j < 4; ++j)
        if (p[4 * i + j] % 16) return cudaErrorInvalidValue;
  }
  const void* kernel = vec == 4 ? (const void*)halo_pull_kernel<float4> : (const void*)halo_pull_kernel<float>;
  int per_sm = 0, sms = 0;
  const cudaError_t e = pfs::coop_capacity(kernel, kThreads, 0, &per_sm, &sms);
  if (e != cudaSuccess) return e;
  const long long pv = plane / vec;
  const long long need = ((n + 2) * pv + kThreads - 1) / kThreads;  // blocks an output asks for
  long long cap = (long long)per_sm * sms / slots;
  if (cap < 1) cap = 1;
  const dim3 grid((unsigned)(need < cap ? need : cap), (unsigned)slots);
  if (vec == 4)
    halo_pull_kernel<float4><<<grid, kThreads, 0, st>>>(t, n, pv);
  else
    halo_pull_kernel<float><<<grid, kThreads, 0, st>>>(t, n, plane);
  return cudaGetLastError();
}

}  // namespace

// One device's launch on `stream`, a stream of the current device (the
// wrapper makes the slots' device current, ops/_cuda_build.py::launching).
// table: host array of `slots` x 4 pointers (x, lo, hi, out) as PullSlot
// lays them out; n, plane in floats; vec 4 (every pointer 16-byte aligned,
// plane % 4 == 0) or 1.
extern "C" int pfs_halo_pull(const void* table, int slots, long long n, long long plane, int vec, void* stream) {
  if (slots < 1 || slots > kMaxSlots || n < 1 || plane < 1 || (vec != 1 && vec != 4) || plane % vec)
    return (int)cudaErrorInvalidValue;
  return (int)launch_pull(table, slots, n, plane, vec, static_cast<cudaStream_t>(stream));
}

