// The cross-card sum of the distributed solves' dots: every slot's fp32
// partials summed in slot order, the same bits on every card.
//
// Replaces no TPU kernel.  In the JAX package a distributed dot is
// lax.psum of each device's partial inside shard_map
// (python_fluid_simulation_tpu/parallel/halo.py::psum_dot, :105-111, and the
// coupled solve's :475-480), an XLA all-reduce that leaves the total on
// every device, so every device's while_loop tests the same scalars.  The
// port's plain version sums the partials on slot 0's device in slot order,
// ((p0 + p1) + p2) + p3 (parallel/halo.py::psum_dot); on a mesh whose slots
// span cards this kernel gives every card that very sum, so each card
// computes its own alpha and beta and its own loop exit, as each JAX device
// does, and a captured solve can loop on every card at once (one WHILE
// node a card).
//
// One launch a slot, each on its slot's stream (parallel/halo_rdma.py::
// slot_launches), one thread, up to kMaxDots dots at once.  Each launch:
//   1. reads its slot's epoch (device memory on its card) and takes one
//      more; the parity of that epoch picks one of two halves of every
//      receive buffer, so a slot that is one all-reduce ahead never
//      overwrites partials a slower card has still to read;
//   2. stores its partials into its column of every slot's receive buffer
//      (peer stores where that slot is on another card), fences them
//      system-wide, and adds one to every slot's arrival counter
//      (system-scope atomics);
//   3. waits until its own arrival counter reaches epoch * slots
//      (wrap-safe; after kTimeoutNs it writes the error word and traps, so a
//      lost signal fails the run instead of hanging the card);
//   4. sums its own buffer's column of each dot in slot order with
//      round-to-nearest fp32 adds, writes the totals and the epoch.
// A slot cannot start an all-reduce two ahead of another: that needs every
// slot's arrival at the one in between, after which each slot's read of
// the first is done (its stream runs its launches in order).
//
// What bounds it: latency.  Each launch moves dots * slots floats and
// slots counters over NVLink (a few hundred bytes, ~1 ns at 450 GB/s):
// the round trips of the stores, the atomics and the spin, a few
// microseconds, are its cost.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 64;
constexpr int kMaxDots = 3;
constexpr unsigned long long kTimeoutNs = 10ull * 1000ull * 1000ull * 1000ull;  // 10 s

struct Slots {
  float* recv[kMaxSlots];           // every slot's receive buffer, [2][kMaxDots][slots]
  unsigned int* arrive[kMaxSlots];  // every slot's arrival counter
};

struct Partials {
  const float* part[kMaxDots];  // this slot's partials (0-dim tensors)
  float* out[kMaxDots];         // this slot's totals
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

__global__ void mesh_psum_kernel(const __grid_constant__ Slots slots, const __grid_constant__ Partials p,
                                 unsigned int* __restrict__ epoch_ctr, int* __restrict__ err, int slot, int size,
                                 int dots) {
  // 1. this all-reduce's epoch and half
  const unsigned int epoch = *epoch_ctr + 1u;
  const int half = (int)(epoch & 1u) * kMaxDots * size;

  // 2. the partials into every slot's buffer, then one arrival each
  float mine[kMaxDots];
  for (int j = 0; j < dots; ++j) mine[j] = *p.part[j];
  for (int t = 0; t < size; ++t)
    for (int j = 0; j < dots; ++j) slots.recv[t][half + j * size + slot] = mine[j];
  __threadfence_system();
  for (int t = 0; t < size; ++t) atomicAdd_system(slots.arrive[t], 1u);

  // 3. every slot's partials have landed here
  const unsigned int target = epoch * (unsigned int)size;
  const unsigned long long t0 = now_ns();
  while ((int)(load_acquire_sys(slots.arrive[slot]) - target) < 0) {
    if (now_ns() - t0 > kTimeoutNs) {
      atomicExch_system(err, 1);
      __threadfence_system();
      __trap();
    }
    __nanosleep(32);
  }

  // 4. the slot-order sums
  const volatile float* col = slots.recv[slot] + half;
  for (int j = 0; j < dots; ++j) {
    float total = col[j * size];
    for (int t = 1; t < size; ++t) total = __fadd_rn(total, col[j * size + t]);
    *p.out[j] = total;
  }
  *epoch_ctr = epoch;
}

}  // namespace

// One slot's launch on `stream` (a stream of the current device, the
// slot's).  recv, arrive: host arrays of every slot's receive buffer and
// arrival counter (peer pointers for slots on other cards); parts, outs:
// host arrays of this slot's `dots` partials and totals; epoch: this
// slot's epoch counter, err its error word (both on its card).
extern "C" int pfs_mesh_psum(const void* recv, const void* arrive, const void* parts, const void* outs,
                             void* epoch, void* err, int slot, int size, int dots, void* stream) {
  if (size < 1 || size > kMaxSlots || slot < 0 || slot >= size || dots < 1 || dots > kMaxDots)
    return (int)cudaErrorInvalidValue;
  Slots s;
  Partials p;
  const uint64_t* r = static_cast<const uint64_t*>(recv);
  const uint64_t* a = static_cast<const uint64_t*>(arrive);
  const uint64_t* pp = static_cast<const uint64_t*>(parts);
  const uint64_t* po = static_cast<const uint64_t*>(outs);
  for (int i = 0; i < kMaxSlots; ++i) {
    s.recv[i] = i < size ? reinterpret_cast<float*>(r[i]) : nullptr;
    s.arrive[i] = i < size ? reinterpret_cast<unsigned int*>(a[i]) : nullptr;
  }
  for (int j = 0; j < kMaxDots; ++j) {
    p.part[j] = j < dots ? reinterpret_cast<const float*>(pp[j]) : nullptr;
    p.out[j] = j < dots ? reinterpret_cast<float*>(po[j]) : nullptr;
  }
  mesh_psum_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      s, p, static_cast<unsigned int*>(epoch), static_cast<int*>(err), slot, size, dots);
  return (int)cudaGetLastError();
}
