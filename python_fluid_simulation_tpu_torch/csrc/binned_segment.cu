// Segmented reduce and broadcast over cell-sorted particle rows.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_binned.py::
// binned_segment_reduce (_kernel, with channels_first) and
// binned_segment_broadcast (_bcast_kernel).  The TPU kernels walk the
// sorted rows serially through VMEM tiles of the dense table, with the
// row range of each tile found by searchsorted in XLA beforehand.  On
// Hopper every (segment, channel) pair gets its own thread instead:
//
// reduce   tiles of kTile (128) consecutive segments, dealt round robin to
//          the resident blocks (small tiles spread the fluid's dense
//          segments over every block).  A block finds the row ranges of its
//          next kBatch tiles at once, one binary search a thread on the
//          sorted ids (two a tile, not one a segment); inside a tile the
//          segments' first rows come from one pass over the tile's rows
//          that marks where the id changes (as the live placement's pass
//          1).  A warp then takes a segment x 32-channel group, lanes on
//          consecutive channels, so every row is read as one contiguous
//          run; each lane reduces its channel SERIALLY IN ROW ORDER from
//          `fill` (add: __fadd_rn sums, min: the minimum clamped at fill,
//          NaN propagating), four rows' loads in flight at a time.  Sums
//          stay segment-local, use no atomics and are bitwise repeatable;
//          they are the scan route's result (fill 0) and the order of
//          PyTorch's segment_reduce, the plain version.  The results go
//          through shared memory, kGroup (64) channels x (kTile + 1) at a
//          time, and are written along segments (channels-first (C, M): a
//          warp a channel's 128 segments) or along channels (row-major
//          (M, C)), so every store is coalesced.  Where M is not a
//          multiple of 8 a channel's row starts inside a 32-byte sector,
//          and a tile's edge sectors are shared with the next tile's: the
//          longer the tile, the fewer such sectors (a sweep of 32, 64 and
//          128 segments a tile chose 128: no slower where M is a multiple
//          of 8, much faster where it is not).  A tile with no rows writes `fill`
//          and does nothing else (at 256 and 504 94-99% of the segments
//          are empty).  Negative ids sort before segment 0 and ids >= M
//          after segment M-1, so both fall outside every tile and are
//          dropped.
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
//          its reduce, combined with fill (add: fill + row, min: the row
//          where it is below fill), written in LIVE FORM: only the
//          nonempty segments (at 256 and 504 94-99% of the segments are
//          empty, so a dense M x C table is mostly `fill`).  Column j of
//          live (C, cap) holds the j-th nonempty in-range segment, in
//          ascending id order -- the dense table's column, rounded the
//          same way (scan then place computes what the serial reduce
//          computes: with fill = 0, every add caller, and the scan's
//          row-order adds it is bitwise that result; the min is
//          order-free) -- and slot (M,) int32 holds each segment's column,
//          -1 where it is empty.  One cooperative launch over tiles of
//          kLiveTile segments, dealt to the resident blocks round robin:
//          pass 1 walks the rows and writes each tile's first row where
//          the rows' tile changes (sorted ids: no binary search a tile);
//          pass 2 counts each tile's segment-last rows; pass 3 gives each
//          tile its first column (the counts of the tiles before it,
//          summed in a fixed order, no atomics), numbers the tile's last
//          rows in row order with a block scan, sets their slots in a
//          shared tile of -1s, and moves their rows to the columns
//          through shared memory in groups of kLiveCols: a warp reads a
//          row along its channels (coalesced), then a warp writes a
//          channel along the group's consecutive columns (coalesced), so
//          the row-major scan becomes the channel-major table the fold
//          reads.  The slot tile is written once; a tile with no rows
//          writes -1s and nothing else.  A grid barrier between the
//          passes.  Tiles are small (512 segments) so that the fluid's
//          dense tiles spread over every block: with 2,048 a block that
//          drew a few of them (~15k rows each at 256) set the time.  Ids
//          are re-read in each pass (K * 8 bytes, L2-resident at the
//          step's sizes) rather than kept.
//
// What bounds them: bytes.  The reduce reads K*C values and K ids once
// and writes M*C values, one add or min per value; the broadcast writes
// K*C values and reads K ids and each distinct table row in its range (a
// run split between two warps' rows is read twice); the live placement
// reads the K ids (twice) and the S segment-last rows and writes S*C
// values and M slots: 0.43 GB for the 256 step's level-set call
// (S = 0.38M, C = 125) against 3.4 GB for a dense table.  The reduce also
// reads each tile's ids once more to mark its segments, and pays two
// binary searches a tile (2 log2 K id reads, L2-resident).
//
// Ids are int64, the dtype of the port's torch.sort of cell ids.
//
// Index widths: M and C are 32-bit (the wrapper checks M < 2^31 and
// 256 C < 2^31; the placement takes C <= 256); every element offset --
// row * C + c, (m0 + s) * C + c, c * M + m0 + s, rid * cv + c,
// (base + s) * cv -- is computed in 64 bits, so a table may
// pass 2^31 entries (the level set's 125-channel reduce at 126x504x126
// cells holds 1.0e9).

#include <cstdint>

#include "pcg_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;            // segments a reduce tile
constexpr int kGroup = 64;            // channels a reduce tile stages at once
constexpr int kBatch = kThreads / 2;  // tiles whose row ranges a block searches at once

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

template <bool kMin>
__device__ __forceinline__ float reduce_step(float acc, float v) {
  return kMin ? ((v != v || v < acc) ? v : acc)  // NaN propagates, as in torch
              : __fadd_rn(acc, v);
}

template <bool kMin, bool kChannelsFirst>
__global__ void __launch_bounds__(kThreads)
    binned_reduce_kernel(const float* __restrict__ vals,
                         const long long* __restrict__ ids, long k, int M,
                         int C, float fill, float* __restrict__ out) {
  constexpr int ld = kTile + 1;  // +1: a warp's channel column on distinct banks
  __shared__ float stage[kGroup * ld];
  __shared__ long start[kTile + 1];   // the tile's segments' first rows, and its end
  __shared__ long bounds[2 * kBatch];  // the batch's tiles' row ranges
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long ntiles = ((long)M + kTile - 1) / kTile;
  for (long first = blockIdx.x; first < ntiles; first += (long)gridDim.x * kBatch) {
    __syncthreads();  // every thread is done with the last batch's bounds
    {
      const long t = first + (long)(threadIdx.x >> 1) * gridDim.x;
      if (t < ntiles) {
        long m = (t + (threadIdx.x & 1)) * kTile;
        if (m > M) m = M;
        bounds[threadIdx.x] = lower_bound(ids, k, (long long)m);
      }
    }
    __syncthreads();
    for (int j = 0; j < kBatch; ++j) {
      const long t = first + (long)j * gridDim.x;
      if (t >= ntiles) break;
      const long m0 = t * kTile;
      const int nseg = (long)M - m0 < kTile ? (int)((long)M - m0) : kTile;
      const long lo = bounds[2 * j], hi = bounds[2 * j + 1];
      if (lo == hi) {  // no rows: every segment is fill
        if (kChannelsFirst) {
          for (int c = warp; c < C; c += kWarps)
            for (int s = lane; s < nseg; s += 32) out[(long)c * M + m0 + s] = fill;
        } else {
          float* o = out + m0 * C;
          const long n = (long)nseg * C;
          for (long e = threadIdx.x; e < n; e += kThreads) o[e] = fill;
        }
        continue;
      }
      // the segments' first rows: row i is the first of segments
      // (id[i - 1], id[i]] (the ids are sorted), the tile's end follows
      // its last row
      for (long i = lo + threadIdx.x; i < hi; i += kThreads) {
        const int cur = (int)(ids[i] - m0);
        const int prev = i == lo ? -1 : (int)(ids[i - 1] - m0);
        for (int s = prev + 1; s <= cur; ++s) start[s] = i;
        if (i == hi - 1)
          for (int s = cur + 1; s <= nseg; ++s) start[s] = hi;
      }
      __syncthreads();
      for (int c0 = 0; c0 < C; c0 += kGroup) {
        const int g = C - c0 < kGroup ? C - c0 : kGroup;
        const int nch = (g + 31) >> 5;  // 32-channel groups
        for (int u = warp; u < nseg * nch; u += kWarps) {
          const int s = u / nch;
          const int cc = ((u - s * nch) << 5) + lane;  // the lane's channel in the group
          if (cc >= g) continue;
          float acc = fill;
          const float* p = vals + start[s] * (long)C + c0 + cc;
          long rows = start[s + 1] - start[s];
          for (; rows >= 4; rows -= 4, p += 4 * (long)C) {
            const float v0 = p[0], v1 = p[C], v2 = p[2 * (long)C], v3 = p[3 * (long)C];
            acc = reduce_step<kMin>(acc, v0);
            acc = reduce_step<kMin>(acc, v1);
            acc = reduce_step<kMin>(acc, v2);
            acc = reduce_step<kMin>(acc, v3);
          }
          for (; rows > 0; --rows, p += C) acc = reduce_step<kMin>(acc, *p);
          stage[cc * ld + s] = acc;
        }
        __syncthreads();
        if (kChannelsFirst) {
          for (int cc = warp; cc < g; cc += kWarps)
            for (int s = lane; s < nseg; s += 32) out[(long)(c0 + cc) * M + m0 + s] = stage[cc * ld + s];
        } else {
          for (int s = warp; s < nseg; s += kWarps)
            for (int cc = lane; cc < g; cc += 32) out[(m0 + s) * C + c0 + cc] = stage[cc * ld + s];
        }
        __syncthreads();
      }
    }
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

constexpr int kLiveTile = 512;  // segments a live-placement tile covers
constexpr int kLiveCols = 32;    // columns a transpose group stages

// Row i is its segment's last (ids sorted, so the segments' last rows
// come in ascending id order).
__device__ __forceinline__ bool seg_last(const long long* ids, long k, long i) {
  return i + 1 == k || ids[i + 1] != ids[i];
}

template <bool kMin>
__device__ __forceinline__ float place_value(float v, float fill) {
  return kMin ? ((v != v || v < fill) ? v : fill) : __fadd_rn(fill, v);
}

// The tile of a row's id: -1 below 0, ntiles at M or above.
__device__ __forceinline__ int live_tile(long long id, int M, int ntiles) {
  return id < 0 ? -1 : (id >= M ? ntiles : (int)(id / kLiveTile));
}

// live (C, cap): column j of channel c at live[c * cap + j].  work:
// ntiles + 1 row starts (tile t's rows are [start[t], start[t + 1])), then
// ntiles counts.  stage: C x (kLiveCols + 1) floats of dynamic shared
// memory.
template <bool kMin>
__global__ void __launch_bounds__(kThreads)
    binned_place_live_kernel(const float* __restrict__ scan,
                             const long long* __restrict__ ids, long k, int M,
                             int C, float fill, long cap,
                             float* __restrict__ live, int* __restrict__ slot,
                             long* __restrict__ work) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  extern __shared__ float stage[];
  __shared__ int slots[kLiveTile];
  __shared__ long rows[kThreads + kLiveCols];  // last rows awaiting their group
  __shared__ int shi[kWarps + 1];
  __shared__ long shl[kWarps + 1];
  const int ntiles = (int)(((long)M + kLiveTile - 1) / kLiveTile);
  long* start = work;
  long* counts = work + ntiles + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int ld = kLiveCols + 1;  // +1: a warp's channel writes on distinct banks

  // pass 1: the tiles' row starts, start[t] = the first row whose tile is
  // t or more, each written once by the row where the tile changes (the
  // ids are sorted: no search)
  const long stride = (long)gridDim.x * kThreads;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < k; i += stride) {
    const int cur = live_tile(ids[i], M, ntiles);
    const int prev = i == 0 ? -1 : live_tile(ids[i - 1], M, ntiles);
    for (int t = prev + 1; t <= cur; ++t) start[t] = i;
    if (i == k - 1)
      for (int t = cur + 1; t <= ntiles; ++t) start[t] = k;
  }
  if (k == 0 && blockIdx.x == 0)
    for (int t = threadIdx.x; t <= ntiles; t += kThreads) start[t] = 0;
  grid.sync();

  // pass 2: each tile's nonempty segments (its segment-last rows)
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long lo = __ldcg(start + t), hi = __ldcg(start + t + 1);
    int n = 0;
    if (lo < hi) {  // the same in every thread
      for (long i = lo + threadIdx.x; i < hi; i += kThreads) n += seg_last(ids, k, i);
      n = pfs::block_sum<kThreads, int>(n, shi);
    }
    if (threadIdx.x == 0) counts[t] = n;
  }
  grid.sync();

  // pass 3: the columns and the map
  long before = 0, counted = 0;  // columns of tiles [0, counted)
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long m0 = (long)t * kLiveTile;
    const int nseg = (long)M - m0 < kLiveTile ? (int)((long)M - m0) : kLiveTile;
    const long lo = __ldcg(start + t), hi = __ldcg(start + t + 1);
    if (lo == hi) {  // no rows: every segment empty
      for (int s = threadIdx.x; s < nseg; s += kThreads) slot[m0 + s] = -1;
      continue;
    }
    long add = 0;
    for (long u = counted + threadIdx.x; u < t; u += kThreads) add += __ldcg(counts + u);
    before += pfs::block_sum<kThreads, long>(add, shl);
    counted = t;
    for (int s = threadIdx.x; s < nseg; s += kThreads) slots[s] = -1;
    __syncthreads();
    int col = (int)before;  // the next column to number
    int pending = 0;        // numbered rows in rows[] not yet moved
    // move rows[first, first + n) to columns [c0, c0 + n), n <= kLiveCols
    auto move = [&](int first, int n, int c0) {
      for (int j = warp; j < n; j += kWarps) {
        const float* row = scan + rows[first + j] * C;
        for (int c = lane; c < C; c += 32) stage[c * ld + j] = place_value<kMin>(row[c], fill);
      }
      __syncthreads();
      for (int c = warp; c < C; c += kWarps)
        if (lane < n) live[(long)c * cap + c0 + lane] = stage[c * ld + lane];
      __syncthreads();
    };
    for (long base = lo; base < hi; base += kThreads) {
      const long i = base + threadIdx.x;
      const bool last = i < hi && seg_last(ids, k, i);
      int total;
      const int pos = pfs::block_exclusive_scan<kThreads>(last, shi, &total);
      if (last) {
        slots[ids[i] - m0] = col + pos;
        rows[pending + pos] = i;
      }
      col += total;
      pending += total;
      __syncthreads();
      int done = 0;
      for (; pending - done >= kLiveCols; done += kLiveCols) move(done, kLiveCols, col - pending + done);
      if (done > 0) {
        const int rest = pending - done;  // < kLiveCols <= done: no overlap
        if (threadIdx.x < rest) rows[threadIdx.x] = rows[done + threadIdx.x];
        pending = rest;
        __syncthreads();
      }
    }
    if (pending > 0) move(0, pending, col - pending);
    for (int s = threadIdx.x; s < nseg; s += kThreads) slot[m0 + s] = slots[s];
    __syncthreads();
  }
}

}  // namespace

// The live placement: live (C, cap) with cap >= the nonempty in-range
// segments (min(k, M) always is), slot (M,), and a workspace of
// work_cap >= 2 ceil(M / kLiveTile) + 1 longs.  One cooperative launch.
extern "C" int pfs_binned_place_live(const void* scan, const void* ids,
                                     long long k, int M, int C, int op_min,
                                     float fill, void* live, long long cap,
                                     void* slot, void* work,
                                     long long work_cap, void* stream) {
  if (M <= 0) return 0;
  if (C <= 0 || C > 256 || cap < 0) return (int)cudaErrorInvalidValue;
  const long ntiles = ((long)M + kLiveTile - 1) / kLiveTile;
  if (work_cap < 2 * ntiles + 1) return (int)cudaErrorInvalidValue;
  const int smem = C * (kLiveCols + 1) * (int)sizeof(float);
  const void* kernel = op_min ? (const void*)binned_place_live_kernel<true>
                              : (const void*)binned_place_live_kernel<false>;
  int grid = 0;
  const long rows = (long)k > ntiles ? (long)k : ntiles;  // pass 1 walks the rows, passes 2-3 the tiles
  cudaError_t e = pfs::coop_grid(kernel, rows, &grid, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const float* sc = static_cast<const float*>(scan);
  const long long* id = static_cast<const long long*>(ids);
  long kk = (long)k, cp = (long)cap;
  float* lv = static_cast<float*>(live);
  int* sl = static_cast<int*>(slot);
  long* wk = static_cast<long*>(work);
  void* args[] = {&sc, &id, &kk, &M, &C, &fill, &cp, &lv, &sl, &wk};
  e = cudaLaunchCooperativeKernel(kernel, grid, kThreads, args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The reduce: the resident blocks, or fewer where there are fewer tiles.
extern "C" int pfs_binned_reduce(const void* vals, const void* ids,
                                 long long k, int M, int C, int op_min,
                                 int channels_first, float fill, void* out,
                                 void* stream) {
  if (M <= 0 || C <= 0) return 0;
  const void* kernel =
      op_min ? (channels_first ? (const void*)binned_reduce_kernel<true, true>
                               : (const void*)binned_reduce_kernel<true, false>)
             : (channels_first ? (const void*)binned_reduce_kernel<false, true>
                               : (const void*)binned_reduce_kernel<false, false>);
  int per_sm = 0, sms = 0;
  cudaError_t e = pfs::coop_capacity(kernel, kThreads, 0, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  const long ntiles = ((long)M + kTile - 1) / kTile;
  long blocks = (long)per_sm * sms;
  if (blocks > ntiles) blocks = ntiles;
  if (blocks < 1) blocks = 1;
  const unsigned grid = (unsigned)blocks;
  const float* v = static_cast<const float*>(vals);
  const long long* id = static_cast<const long long*>(ids);
  long kk = (long)k;
  float* o = static_cast<float*>(out);
  void* args[] = {&v, &id, &kk, &M, &C, &fill, &o};
  e = cudaLaunchKernel(kernel, grid, kThreads, args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
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
  int sms = 0, per_sm = 0;
  const cudaError_t e = pfs::coop_capacity(kernel, kThreads, 0, &per_sm, &sms);
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
