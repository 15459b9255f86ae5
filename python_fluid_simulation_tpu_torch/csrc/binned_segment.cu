// Segmented reduce and broadcast over cell-sorted particle rows.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_binned.py::
// binned_segment_reduce (_kernel, with channels_first) and
// binned_segment_broadcast (_bcast_kernel).  The TPU kernels walk the
// sorted rows serially through VMEM tiles of the dense table, with the
// row range of each tile found by searchsorted in XLA beforehand.  On
// Hopper every (segment, channel) pair gets its own thread instead:
//
// reduce   a block owns 256 consecutive segments.  Its threads first find
//          the row range of each segment by binary search on the sorted
//          ids (into shared memory), then each (segment, channel) pair is
//          reduced SERIALLY IN ROW ORDER from `fill`: add sums, min takes
//          the minimum clamped at fill.  Sums stay segment-local, use no
//          atomics and are bitwise repeatable; they match PyTorch's
//          segment_reduce (the plain version), which reduces in the same
//          order from the same initial value.  Negative ids sort before
//          segment 0 and ids >= M after segment M-1, so both fall outside
//          every range and are dropped.  Row-major output puts consecutive
//          threads on consecutive channels of one segment; channels-first
//          output (C, M) puts them on consecutive segments of one channel,
//          so the stores are coalesced either way.
// broadcast out[i, c] = table[ids[i], c], 0 for ids outside [0, M).  The
//          callers (G2P, the density displacement gather) gather 54-
//          channel corner tables (216-byte rows) over the cell-sorted
//          particle ids, so the rows of a cell are neighbours.  A warp
//          owns 32 consecutive rows at a time: it loads their ids once
//          (one per lane), finds the runs of equal ids with a ballot,
//          reads each run's table row ONCE (as float2 vectors: C even and
//          both rows 8-byte aligned; otherwise 4-byte scalars, a shape
//          case chosen by the launcher) and writes it to every output row
//          of the run, lanes on consecutive vectors of a row, so each
//          store is one contiguous row.  No division in the loop; the
//          grid is the resident blocks, walking the rows with a stride.
//          (The first version, one thread an output element with a 64-bit
//          divide and modulo, re-read the id C times and the table row
//          once a particle: 0.235 ms for a 128^3 step's two calls against
//          index_select's 0.129-0.145, PERF.md.)
// place    the second phase of the scan route (replaces _scan_kernel's
//          phase B, pallas_binned.py:327): given the inclusive segmented
//          scan of the rows (seg_scan.cu), each segment's LAST row holds
//          its reduce.  A block owns S consecutive segments: it fills an
//          S x C tile in shared memory with `fill`, finds its row range
//          with two binary searches, and for every segment-last row in
//          that range (a warp ballot on ids[i] != ids[i+1]) its warp
//          copies the row into the tile, combined with fill (add:
//          fill + row, min: the row where it is below fill); then the
//          tile is written out once, coalesced.  channels_first stages
//          the tile transposed (C x (S+1): the +1 keeps a warp's row
//          writes on distinct banks), so a warp writes consecutive
//          segments of one channel.  Scan then place computes what the
//          serial reduce computes: with fill = 0 (every add caller) and
//          the scan's row-order adds it is bitwise that result, and the
//          min is order-free.
//
// What bounds them: bytes.  The reduce reads K*C values and K ids once
// and writes M*C values, one add or min per value; the broadcast writes
// K*C values and reads K ids and each distinct table row in its range (a
// run split between two warps' rows is read twice); the placement reads K ids and the
// segment-last rows (one a non-empty segment) and writes M*C values.  The simple design pays extra for the
// binary searches (2 log2 K id reads a segment, L2-resident) and, in the
// channels-first layout, for reads strided by C; tuning is later work.
//
// Ids are int64, the dtype of the port's torch.sort of cell ids.
//
// Index widths: M and C are 32-bit (the wrapper checks M < 2^31 and
// 256 C < 2^31, the pairs a reduce block counts in an int; the placement
// takes C <= 256); every element offset -- row * C + c, (m0 + s) * C + c,
// c * M + m0 + s, rid * cv + c, (base + s) * cv -- is computed in 64 bits, so a table may
// pass 2^31 entries (the level set's 125-channel reduce at 126x504x126
// cells holds 1.0e9).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSegs = 256;  // segments per reduce block

__device__ __forceinline__ long lower_bound(const long long* ids, long k,
                                            long long v) {
  long lo = 0, hi = k;
  while (lo < hi) {
    const long mid = (lo + hi) >> 1;
    if (ids[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool kMin, bool kChannelsFirst>
__global__ void __launch_bounds__(kThreads)
    binned_reduce_kernel(const float* __restrict__ vals,
                         const long long* __restrict__ ids, long k, int M,
                         int C, float fill, float* __restrict__ out) {
  __shared__ long rows[kSegs + 1];
  const long m0 = (long)blockIdx.x * kSegs;
  const int nseg = (long)M - m0 < kSegs ? (int)((long)M - m0) : kSegs;
  for (int j = threadIdx.x; j <= nseg; j += kThreads)
    rows[j] = lower_bound(ids, k, (long long)(m0 + j));
  __syncthreads();
  const int pairs = nseg * C;
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int s = kChannelsFirst ? p % nseg : p / C;
    const int c = kChannelsFirst ? p / nseg : p % C;
    float acc = fill;
    for (long row = rows[s]; row < rows[s + 1]; ++row) {
      const float v = vals[row * C + c];
      if (kMin)
        acc = (v != v || v < acc) ? v : acc;  // NaN propagates, as in torch
      else
        acc = __fadd_rn(acc, v);
    }
    if (kChannelsFirst)
      out[(long)c * M + m0 + s] = acc;
    else
      out[(m0 + s) * C + c] = acc;
  }
}

// V: float2 (C even, rows 8-byte aligned) or float; cv = C in V units.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    binned_broadcast_kernel(const V* __restrict__ table,
                            const long long* __restrict__ ids, long k, int M,
                            int cv, V* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long warps = (long)gridDim.x * (kThreads / 32);
  for (long base = (long)blockIdx.x * kThreads + threadIdx.x - lane; base < k;
       base += warps * 32) {
    const int n = k - base < 32 ? (int)(k - base) : 32;
    const long long id = lane < n ? __ldg(ids + base + lane) : 0;
    const long long prev = __shfl_up_sync(0xffffffffu, id, 1);
    // run starts among the warp's n rows; lane 0 always starts one
    unsigned starts = __ballot_sync(0xffffffffu, lane < n && (lane == 0 || id != prev));
    while (starts) {
      const int s = __ffs(starts) - 1;
      starts &= starts - 1;
      const int e = starts ? __ffs(starts) - 1 : n;
      const long long rid = __shfl_sync(0xffffffffu, id, s);
      const bool valid = rid >= 0 && rid < M;
      V* dst = out + (base + s) * cv;
      for (int c = lane; c < cv; c += 32) {
        const V val = valid ? __ldg(table + rid * cv + c) : V{};
        for (int r = 0; r < e - s; ++r) dst[(long)r * cv + c] = val;
      }
    }
  }
}

constexpr int kPlaceFloats = 10240;  // shared floats a placement tile holds (40 KB)

template <bool kMin, bool kChannelsFirst>
__global__ void __launch_bounds__(kThreads)
    binned_place_kernel(const float* __restrict__ scan,
                        const long long* __restrict__ ids, long k, int M,
                        int C, int S, float fill, float* __restrict__ out) {
  extern __shared__ float tile[];  // S x C, or C x (S + 1) channels-first
  __shared__ long range[2];
  const long m0 = (long)blockIdx.x * S;
  const int nseg = (long)M - m0 < S ? (int)((long)M - m0) : S;
  const int ld = kChannelsFirst ? S + 1 : C;
  const int n = kChannelsFirst ? C * ld : nseg * C;
  for (int p = threadIdx.x; p < n; p += kThreads) tile[p] = fill;
  if (threadIdx.x < 2)
    range[threadIdx.x] = lower_bound(ids, k, (long long)(m0 + threadIdx.x * nseg));
  __syncthreads();
  const long lo = range[0], hi = range[1];
  const int lane = threadIdx.x & 31;
  for (long base = lo + (threadIdx.x & ~31); base < hi; base += kThreads) {
    const long i = base + lane;
    const long long id = i < hi ? ids[i] : 0;
    const bool last = i < hi && (i + 1 == k || ids[i + 1] != id);
    for (unsigned mask = __ballot_sync(0xffffffffu, last); mask; mask &= mask - 1) {
      const int b = __ffs(mask) - 1;
      const int s = (int)(__shfl_sync(0xffffffffu, id, b) - m0);
      const float* row = scan + (base + b) * C;
      for (int c = lane; c < C; c += 32) {
        const float v = row[c];
        const float r = kMin ? ((v != v || v < fill) ? v : fill) : __fadd_rn(fill, v);
        tile[kChannelsFirst ? c * ld + s : s * C + c] = r;
      }
    }
  }
  __syncthreads();
  if (kChannelsFirst) {
    for (int p = threadIdx.x; p < C * nseg; p += kThreads) {
      const int c = p / nseg, s = p - c * nseg;
      out[(long)c * M + m0 + s] = tile[c * ld + s];
    }
  } else {
    float* dst = out + m0 * C;
    for (int p = threadIdx.x; p < n; p += kThreads) dst[p] = tile[p];
  }
}

}  // namespace

// Segments a placement block owns: a multiple of 32, at most 1024, with
// the tile within kPlaceFloats; 0 when C is too wide.
static int place_segments(int C) {
  const int s = (kPlaceFloats / C - 1) / 32 * 32;
  return s < 32 ? 0 : (s > 1024 ? 1024 : s);
}

extern "C" int pfs_binned_place(const void* scan, const void* ids,
                                long long k, int M, int C, int op_min,
                                int channels_first, float fill, void* out,
                                void* stream) {
  if (M <= 0 || C <= 0) return 0;
  const int S = place_segments(C);
  if (S == 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((M + S - 1) / S);
  const size_t smem = (size_t)(channels_first ? C * (S + 1) : S * C) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(scan);
  const long long* id = static_cast<const long long*>(ids);
  float* o = static_cast<float*>(out);
  if (op_min) {
    if (channels_first)
      binned_place_kernel<true, true><<<blocks, kThreads, smem, st>>>(v, id, k, M, C, S, fill, o);
    else
      binned_place_kernel<true, false><<<blocks, kThreads, smem, st>>>(v, id, k, M, C, S, fill, o);
  } else {
    if (channels_first)
      binned_place_kernel<false, true><<<blocks, kThreads, smem, st>>>(v, id, k, M, C, S, fill, o);
    else
      binned_place_kernel<false, false><<<blocks, kThreads, smem, st>>>(v, id, k, M, C, S, fill, o);
  }
  return (int)cudaGetLastError();
}

extern "C" int pfs_binned_reduce(const void* vals, const void* ids,
                                 long long k, int M, int C, int op_min,
                                 int channels_first, float fill, void* out,
                                 void* stream) {
  if (M <= 0 || C <= 0) return 0;
  const unsigned blocks = (unsigned)((M + kSegs - 1) / kSegs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const long long* id = static_cast<const long long*>(ids);
  float* o = static_cast<float*>(out);
  if (op_min) {
    if (channels_first)
      binned_reduce_kernel<true, true><<<blocks, kThreads, 0, st>>>(v, id, k, M, C, fill, o);
    else
      binned_reduce_kernel<true, false><<<blocks, kThreads, 0, st>>>(v, id, k, M, C, fill, o);
  } else {
    if (channels_first)
      binned_reduce_kernel<false, true><<<blocks, kThreads, 0, st>>>(v, id, k, M, C, fill, o);
    else
      binned_reduce_kernel<false, false><<<blocks, kThreads, 0, st>>>(v, id, k, M, C, fill, o);
  }
  return (int)cudaGetLastError();
}

extern "C" int pfs_binned_broadcast(const void* table, const void* ids,
                                    long long k, int M, int C, void* out,
                                    void* stream) {
  if (k <= 0 || C <= 0) return 0;
  const bool vec = C % 2 == 0 && reinterpret_cast<uintptr_t>(table) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const void* kernel = vec ? (const void*)binned_broadcast_kernel<float2>
                           : (const void*)binned_broadcast_kernel<float>;
  // the resident blocks, or fewer where the rows need fewer warps
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const long need = (k + kThreads - 1) / kThreads;  // one warp a 32 rows
  long blocks = (long)per_sm * sms;
  if (blocks > need) blocks = need;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* id = static_cast<const long long*>(ids);
  if (vec)
    binned_broadcast_kernel<float2><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float2*>(table), id, k, M, C / 2, static_cast<float2*>(out));
  else
    binned_broadcast_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(table), id, k, M, C, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
