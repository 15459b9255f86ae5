// The clipped per-corner fold of a channel-major segment table onto the
// grid: out[t] = combine over channels c and source cells e of
// seg[c, e] where t = clip(e + s_c, 0, N - 1) per axis, combine add or min,
// `fill` where nothing lands.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_fold.py::
// fold_scattered_sep_pallas.  The TPU kernel blocks (x, y) with halo
// windows in VMEM and makes the clip a pure static-shift stencil by first
// pre-accumulating the border planes.  On Hopper a thread walks, for its
// target and per channel, the source positions that land on it -- one in
// the interior, a few clipped planes at the borders.  Along each axis a
// channel with shift s reaches target t from the "intermediate" plane
// j = e + s - min_s; j runs over the sources of one shift family, the
// plane groups G(t) = {j : clip(j + min_s) = t} are contiguous ranges,
// and the sources a target reads lie in [lo(G) + min_s - max_s, hi(G)]
// (src_lo / src_hi below).
//
// The table comes in one of two forms:
//   dense  seg[choff[c] + e]: a source's column is its own cell id (any
//          channel offsets: strided channel slices of one table);
//   live   the scatter's form (ops/cuda_binned.py::LiveTable,
//          binned_segment.cu's live placement): slot[e] >= 0 is the
//          column of a nonempty source cell, seg[choff[c] + slot[e]] its
//          value; slot[e] = -1 reads the table's fill `tfill`, as the
//          dense table holds it there.  At 256 and 504 94-99% of the
//          source cells are empty.
//
// The sums follow the plain version's order exactly
// (ops/cuda_fold.py::fold_plain, the port's fold_scattered_sep + fold_clip):
// over the z group, of the y group, of the x group, of the channel combine
// over the z shifts, of the y shifts, of the x shifts -- each a left fold,
// each operation rounded on its own, sources outside the table reading
// `fill` -- so kernel and plain version agree bitwise, sums included, and
// the live fold is bitwise the dense fold of the dense table.  The min is
// torch.minimum's (NaN-propagating fminf).
//
// Design.  A block owns a tile of kTX x kTY x kTZ targets, z fastest: a
// warp is 32 z-neighbouring targets, so its out stores and, per channel,
// its reads of z-neighbouring sources coalesce (in the live form z-runs of
// nonempty cells have consecutive columns: the columns ascend with the cell
// id).  kTY = 8 warps a block, each thread walking kTX = 4 targets along x,
// so the staged halo is paid for by 4 targets.  In the live form the block
// first stages the slots of its tile's source box -- the tile and its shift
// halo, at most 2 planes a side on the step's families (level set -2..2,
// P2G and density -2..0, volume -1..0), plus the clipped border planes of
// an edge tile -- in shared memory, once: 8 x 12 x 36 ints for the level
// set (a warp stages an (x, y) row of the box, lanes along z, so no
// division an element).  Then, where a target whose sources all read
// `fill` must write fill (tfill == fill, and combine(fill, fill) == fill:
// min, or add with fill 0; the wrapper decides): a tile whose box holds no
// nonempty source -- most tiles: the fluid is compact -- writes `fill` and
// ends at the staging barrier; in the others two separable passes over
// the box (z windows a lane, then y windows a warp; x per target) mark the
// targets whose window holds a nonempty source.  The rest of the targets
// -- 92-99% of all -- write `fill` and read nothing more; the marked ones
// run the channel combine with their slot lookups in shared memory and
// read only the nonempty columns.
//
// What bounds it: bytes.  Live: the slot map (M * 4, a box's slots read
// from L2 by neighbouring blocks again), every nonempty column of the
// folded channels once (S * C * 4), the grid written once (N * 4); the
// 125-channel level-set fold at 256 (S = 0.38M) moves 0.24 GB against
// 3.06 GB dense.  The per-target combine chain of the level set (125 loads
// and combines a live target, in the plain version's order) is the other
// candidate where the fluid is dense.  A thread that takes its channels
// one load and one combine at a time is bound by load latency, and
// unrolling all 125 spills registers, so a z shift's loads are issued
// together (channels() below, K^2 slots, K the family's largest shift
// count, known at compile time).  Most tiles end at the staging barrier,
// so the blocks resident on an SM set how well the staging's L2 latency
// is hidden: the launch bounds ask for 3 blocks an SM at K = 5 (<= 85
// registers; 115 unbounded) and 4 below (<= 64), trading a few spilled
// slots of the live chain for occupancy (PERF.md, row 14).  Before this
// design the kernel was one thread a target over the dense table: 0.62-
// 0.63 ms for the coiling level-set fold, 3.79 ms for 504's (a 4.0 GB
// table), 3-4x its byte bound, on an H100 80GB HBM3 at 700 W
// (chip_smoke.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShifts = 5;
constexpr int kMaxChannels = kMaxShifts * kMaxShifts * kMaxShifts;
constexpr int kTX = 4, kTY = 8, kTZ = 32;  // a block's target tile
constexpr int kThreads = kTY * kTZ;
static_assert(kTZ == 32, "a warp is one z row of the tile");

struct FoldArgs {
  const float* seg;  // channel c of column s at seg[choff[c] + s]
  const int* slot;   // live form: (E0, E1, E2) columns, -1 empty; null: dense
  float* out;        // (N0, N1, N2)
  int E[3], N[3];
  int S[3];                  // shifts per axis
  int shift[3][kMaxShifts];  // the shifts of each axis, in channel order
  int smin[3], smax[3];
  int nint[3];    // intermediate extent E + max_s - min_s
  int ntiles[3];  // target tiles per axis
  int box[3];     // the largest source box of a tile, per axis (live form)
  float fill;     // sources outside the table, targets no source reaches
  float tfill;    // live form: an empty source cell
  int shortcut;   // live form: a target with no nonempty source writes fill
  long long choff[kMaxChannels];
};

// The plane group [group_lo, group_hi] of target t along an axis (empty
// when lo > hi), and the sources its channels read: [src_lo, src_hi].
// Both ends are non-decreasing in t, so a tile's sources lie in
// [src_lo(first target), src_hi(last target)].
__host__ __device__ inline int group_lo(const FoldArgs& a, int ax, int t) {
  return max(t == 0 ? 0 : t - a.smin[ax], 0);
}
__host__ __device__ inline int group_hi(const FoldArgs& a, int ax, int t) {
  return min(t == a.N[ax] - 1 ? a.nint[ax] - 1 : t - a.smin[ax], a.nint[ax] - 1);
}
__host__ __device__ inline int src_lo(const FoldArgs& a, int ax, int t) {
  return max(group_lo(a, ax, t) + a.smin[ax] - a.smax[ax], 0);
}
__host__ __device__ inline int src_hi(const FoldArgs& a, int ax, int t) {
  return min(group_hi(a, ax, t), a.E[ax] - 1);
}

// A tile's source box in shared memory: slots s[(x * ext1 + y) * ext2 + z]
// of the sources lo + (x, y, z).
struct Box {
  const int* s;
  int lo[3], ext[3];
};

template <bool kMin>
__device__ __forceinline__ float combine(float a, float b) {
  if (kMin) {
    if (a != a) return a;
    if (b != b) return b;
    return fminf(a, b);
  }
  return __fadd_rn(a, b);
}

// Channel c of the in-table source (e0, e1, e2).
template <bool kLive>
__device__ __forceinline__ float load(const FoldArgs& a, const Box& b, int c,
                                      int e0, int e1, int e2) {
  if (kLive) {
    const int s = b.s[((e0 - b.lo[0]) * b.ext[1] + e1 - b.lo[1]) * b.ext[2] + e2 - b.lo[2]];
    return s < 0 ? a.tfill : __ldg(a.seg + a.choff[c] + s);
  }
  return __ldg(a.seg + a.choff[c] + ((long)e0 * a.E[1] + e1) * a.E[2] + e2);
}

// The channel combine at intermediate position (j0, j1, j2).  For each z
// shift the (up to K^2) loads of its y and x shifts are issued before any
// of them is combined, so a thread has that many reads in flight rather
// than one; the combines then run in the plain version's order.  K >= the
// shifts an axis, a compile-time bound so the slots live in registers.
template <bool kMin, int K, bool kLive>
__device__ __forceinline__ float channels(const FoldArgs& a, const Box& b,
                                          int j0, int j1, int j2) {
  int e0[K], e1[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    e0[i] = j0 + a.smin[0] - a.shift[0][i];
    e1[i] = j1 + a.smin[1] - a.shift[1][i];
  }
  float v2 = 0.f;
#pragma unroll 1
  for (int i2 = 0; i2 < a.S[2]; ++i2) {
    const int e2 = j2 + a.smin[2] - a.shift[2][i2];
    float t2 = a.fill;
    if (e2 >= 0 && e2 < a.E[2]) {
      float t[K][K];
#pragma unroll
      for (int i1 = 0; i1 < K; ++i1)
#pragma unroll
        for (int i0 = 0; i0 < K; ++i0) {
          t[i1][i0] = a.fill;
          if (i1 < a.S[1] && i0 < a.S[0] && e1[i1] >= 0 && e1[i1] < a.E[1] &&
              e0[i0] >= 0 && e0[i0] < a.E[0])
            t[i1][i0] = load<kLive>(a, b, (i0 * a.S[1] + i1) * a.S[2] + i2, e0[i0], e1[i1], e2);
        }
      float v1 = 0.f;
#pragma unroll
      for (int i1 = 0; i1 < K; ++i1) {
        if (i1 < a.S[1]) {
          float t1 = a.fill;
          if (e1[i1] >= 0 && e1[i1] < a.E[1]) {
            float v0 = t[i1][0];
#pragma unroll
            for (int i0 = 1; i0 < K; ++i0)
              if (i0 < a.S[0]) v0 = combine<kMin>(v0, t[i1][i0]);
            t1 = v0;
          }
          v1 = i1 == 0 ? t1 : combine<kMin>(v1, t1);
        }
      }
      t2 = v1;
    }
    v2 = i2 == 0 ? t2 : combine<kMin>(v2, t2);
  }
  return v2;
}

// Dynamic shared memory (live form): the box's slots, then the z-window
// flags (box x, box y, kTZ) and the y-window flags (box x, kTY, kTZ).
template <bool kMin, int K, bool kLive>
__global__ void __launch_bounds__(kThreads, K == kMaxShifts ? 3 : 4)
    fold_kernel(const __grid_constant__ FoldArgs a) {
  extern __shared__ int smem[];
  const int tz = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int bz = blockIdx.x % a.ntiles[2];
  const int by = (blockIdx.x / a.ntiles[2]) % a.ntiles[1];
  const int bx = blockIdx.x / (a.ntiles[2] * a.ntiles[1]);
  const int t0[3] = {bx * kTX, by * kTY, bz * kTZ};
  const int nt[3] = {min(kTX, a.N[0] - t0[0]), min(kTY, a.N[1] - t0[1]), min(kTZ, a.N[2] - t0[2])};
  Box b;
  b.s = smem;
  const unsigned char* gy = nullptr;
  if (kLive) {
    for (int ax = 0; ax < 3; ++ax) {
      b.lo[ax] = src_lo(a, ax, t0[ax]);
      b.ext[ax] = max(src_hi(a, ax, t0[ax] + nt[ax] - 1) - b.lo[ax] + 1, 0);
    }
    // stage the box's slots: a warp a (x, y) row, lanes along z
    int* s = smem;
    const int rows = b.ext[0] * b.ext[1];
    bool mine = false;
    for (int r = ty; r < rows; r += kTY) {
      const int x = r / b.ext[1], y = r - x * b.ext[1];
      const int* src = a.slot + ((long)(b.lo[0] + x) * a.E[1] + b.lo[1] + y) * a.E[2] + b.lo[2];
      for (int z = tz; z < b.ext[2]; z += kTZ) {
        const int v = __ldg(src + z);
        s[r * b.ext[2] + z] = v;
        mine |= v >= 0;
      }
    }
    // the barrier after the staging; a tile whose box holds no nonempty
    // source has no live target
    const bool any_live = __syncthreads_or(mine);
    if (a.shortcut && !any_live) {
      if (ty < nt[1] && tz < nt[2])
        for (int tx = 0; tx < nt[0]; ++tx)
          a.out[((long)(t0[0] + tx) * a.N[1] + t0[1] + ty) * a.N[2] + t0[2] + tz] = a.fill;
      return;
    }
    if (a.shortcut) {
      unsigned char* gz = reinterpret_cast<unsigned char*>(smem + a.box[0] * a.box[1] * a.box[2]);
      unsigned char* g = gz + a.box[0] * a.box[1] * kTZ;
      gy = g;
      const bool own = ty < nt[1] && tz < nt[2];
      // z: a nonempty source in lane tz's z window, per box (x, y) row
      const int zlo = src_lo(a, 2, t0[2] + tz) - b.lo[2], zhi = src_hi(a, 2, t0[2] + tz) - b.lo[2];
      for (int r = ty; r < rows; r += kTY) {
        bool any = false;
        if (tz < nt[2])
          for (int z = zlo; z <= zhi; ++z) any |= s[r * b.ext[2] + z] >= 0;
        gz[r * kTZ + tz] = any;
      }
      __syncthreads();
      // y: over warp ty's y window, per box x; read back by this thread only
      if (own) {
        const int ylo = src_lo(a, 1, t0[1] + ty) - b.lo[1], yhi = src_hi(a, 1, t0[1] + ty) - b.lo[1];
        for (int x = 0; x < b.ext[0]; ++x) {
          bool any = false;
          for (int y = ylo; y <= yhi; ++y) any |= gz[(x * b.ext[1] + y) * kTZ + tz] != 0;
          g[(x * kTY + ty) * kTZ + tz] = any;
        }
      }
    }
  }
  if (ty >= nt[1] || tz >= nt[2]) return;  // no barrier below
  for (int tx = 0; tx < nt[0]; ++tx) {
    const int t[3] = {t0[0] + tx, t0[1] + ty, t0[2] + tz};
    float* out = a.out + ((long)t[0] * a.N[1] + t[1]) * a.N[2] + t[2];
    if (kLive && a.shortcut) {
      bool any = false;
      for (int e = src_lo(a, 0, t[0]); e <= src_hi(a, 0, t[0]); ++e)
        any |= gy[((e - b.lo[0]) * kTY + ty) * kTZ + tz] != 0;
      if (!any) {
        *out = a.fill;
        continue;
      }
    }
    int lo[3], hi[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = group_lo(a, ax, t[ax]);
      hi[ax] = group_hi(a, ax, t[ax]);
    }
    float v2 = a.fill;
    for (int j2 = lo[2]; j2 <= hi[2]; ++j2) {
      float v1 = a.fill;
      for (int j1 = lo[1]; j1 <= hi[1]; ++j1) {
        float v0 = a.fill;
        for (int j0 = lo[0]; j0 <= hi[0]; ++j0) {
          const float c = channels<kMin, K, kLive>(a, b, j0, j1, j2);
          v0 = j0 == lo[0] ? c : combine<kMin>(v0, c);
        }
        v1 = j1 == lo[1] ? v0 : combine<kMin>(v1, v0);
      }
      v2 = j2 == lo[2] ? v1 : combine<kMin>(v2, v1);
    }
    *out = v2;
  }
}

template <bool kLive>
using Kernel = void (*)(FoldArgs);

template <bool kLive>
Kernel<kLive> pick(int smax, int is_min) {
  if (smax <= 2) return is_min ? fold_kernel<true, 2, kLive> : fold_kernel<false, 2, kLive>;
  if (smax <= 3) return is_min ? fold_kernel<true, 3, kLive> : fold_kernel<false, 3, kLive>;
  return is_min ? fold_kernel<true, kMaxShifts, kLive> : fold_kernel<false, kMaxShifts, kLive>;
}

}  // namespace

// shifts: S0 + S1 + S2 ints, axis by axis.  choff: one offset a channel
// (S0 * S1 * S2 of them, at most 125).  slot: null for a dense table;
// otherwise the live form's map over the E0 x E1 x E2 source cells, with
// tfill its empty cells' value and shortcut as in the header.
extern "C" int pfs_fold(const void* seg, const long long* choff,
                        const void* slot, void* out, int E0, int E1, int E2,
                        int N0, int N1, int N2, int S0, int S1, int S2,
                        const int* shifts, float fill, float tfill,
                        int shortcut, int is_min, void* stream) {
  FoldArgs a;
  a.seg = static_cast<const float*>(seg);
  a.slot = static_cast<const int*>(slot);
  a.out = static_cast<float*>(out);
  const int E[3] = {E0, E1, E2}, N[3] = {N0, N1, N2}, S[3] = {S0, S1, S2};
  const int T[3] = {kTX, kTY, kTZ};
  int k = 0;
  for (int ax = 0; ax < 3; ++ax) {
    if (S[ax] < 1 || S[ax] > kMaxShifts || E[ax] < 1 || N[ax] < 1)
      return (int)cudaErrorInvalidValue;
    a.E[ax] = E[ax];
    a.N[ax] = N[ax];
    a.S[ax] = S[ax];
    int lo = shifts[k], hi = shifts[k];
    for (int i = 0; i < S[ax]; ++i) {
      a.shift[ax][i] = shifts[k + i];
      lo = min(lo, shifts[k + i]);
      hi = max(hi, shifts[k + i]);
    }
    for (int i = S[ax]; i < kMaxShifts; ++i) a.shift[ax][i] = 0;
    k += S[ax];
    a.smin[ax] = lo;
    a.smax[ax] = hi;
    a.nint[ax] = E[ax] + hi - lo;
    a.ntiles[ax] = (N[ax] + T[ax] - 1) / T[ax];
  }
  const int nch = S0 * S1 * S2;
  for (int c = 0; c < nch; ++c) a.choff[c] = choff[c];
  for (int c = nch; c < kMaxChannels; ++c) a.choff[c] = 0;
  a.fill = fill;
  a.tfill = tfill;
  a.shortcut = slot != nullptr && shortcut;
  const long n = (long)N0 * N1 * N2;
  if (n > (1L << 30)) return (int)cudaErrorInvalidValue;
  const long blocks = (long)a.ntiles[0] * a.ntiles[1] * a.ntiles[2];
  size_t smem = 0;
  if (slot != nullptr) {
    for (int ax = 0; ax < 3; ++ax) {  // the largest box over the tiles
      a.box[ax] = 0;
      for (int t = 0; t < a.ntiles[ax]; ++t) {
        const int t0 = t * T[ax], t1 = min(t0 + T[ax], N[ax]) - 1;
        a.box[ax] = max(a.box[ax], src_hi(a, ax, t1) - src_lo(a, ax, t0) + 1);
      }
    }
    smem = (size_t)a.box[0] * a.box[1] * a.box[2] * sizeof(int) +
           (size_t)a.box[0] * a.box[1] * kTZ + (size_t)a.box[0] * kTY * kTZ;
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // shifts too wide to stage
  } else {
    a.box[0] = a.box[1] = a.box[2] = 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smax = max(S0, max(S1, S2));
  if (slot != nullptr)
    pick<true>(smax, is_min)<<<(unsigned)blocks, kThreads, smem, st>>>(a);
  else
    pick<false>(smax, is_min)<<<(unsigned)blocks, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
