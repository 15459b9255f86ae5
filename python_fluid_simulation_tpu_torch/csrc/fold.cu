// The clipped per-corner fold of a channel-major segment table onto the
// grid: out[t] = combine over channels c and source cells e of
// seg[c, e] where t = clip(e + s_c, 0, N - 1) per axis, combine add or min,
// `fill` where nothing lands.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_fold.py::
// fold_scattered_sep_pallas.  The TPU kernel blocks (x, y) with halo
// windows in VMEM and makes the clip a pure static-shift stencil by first
// pre-accumulating the border planes.  On Hopper that trick is not needed:
// one thread per target cell walks, per channel, the source positions that
// land on it -- one in the interior, a few clipped planes at the borders.
// Along each axis a channel with shift s reaches target t from the
// "intermediate" plane j = e + s - min_s; j runs over the sources of one
// shift family, the plane groups G(t) = {j : clip(j + min_s) = t} are
// contiguous ranges.
//
// The sums follow the plain version's order exactly
// (ops/cuda_fold.py::fold_plain, the port's fold_scattered_sep + fold_clip):
// over the z group, of the y group, of the x group, of the channel combine
// over the z shifts, of the y shifts, of the x shifts -- each a left fold,
// each operation rounded on its own, sources outside the table reading
// `fill` -- so kernel and plain version agree bitwise, sums included.  The
// min is torch.minimum's (NaN-propagating fminf).
//
// What bounds it: bytes.  Every table entry is read once by the interior
// targets (a clipped border plane by its one edge target), every target
// written once; a read of C channels a target is coalesced along z.  The
// level set's 125-channel min fold at 64x256x64 reads 524 MB (~0.16 ms at
// 3.35 TB/s).  A thread that takes its channels one load and one combine
// at a time is bound by load latency, and unrolling all 125 spills
// registers, so a z shift's loads are issued together (channels() below,
// K^2 slots, K the family's largest shift count, known at compile time):
// 0.62-0.63 ms for that fold, ~4x its bound, on an H100 80GB HBM3 at
// 700 W (chip_smoke.py).  A tiled design that stages each channel's
// shifted tile in shared memory is the next step.

#include "pcg_common.cuh"

namespace {

constexpr int kMaxShifts = 5;

struct FoldArgs {
  const float* seg;  // (C, E0, E1, E2), inner three dims contiguous
  long cstride;      // elements between channels
  float* out;        // (N0, N1, N2)
  int E[3], N[3];
  int S[3];                 // shifts per axis
  int shift[3][kMaxShifts];  // the shifts of each axis, in channel order
  int smin[3];
  int nint[3];  // intermediate extent E + max_s - min_s
  float fill;
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

// The channel combine at intermediate position (j0, j1, j2).  For each z
// shift the (up to K^2) loads of its y and x shifts are issued before any
// of them is combined, so a thread has that many reads in flight rather
// than one; the combines then run in the plain version's order.  K >= the
// shifts an axis, a compile-time bound so the slots live in registers.
template <bool kMin, int K>
__device__ __forceinline__ float channels(const FoldArgs& a, int j0, int j1,
                                          int j2) {
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
              e0[i0] >= 0 && e0[i0] < a.E[0]) {
            const long c = ((long)i0 * a.S[1] + i1) * a.S[2] + i2;
            t[i1][i0] = __ldg(a.seg + c * a.cstride +
                              ((long)e0[i0] * a.E[1] + e1[i1]) * a.E[2] + e2);
          }
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

// One thread per target; the host keeps the target count at most 2^30, so
// the target's coordinates come from 32-bit divisions (i + stride stays
// below 2^31).  Table offsets are 64-bit (channel * cstride + source), so
// the table itself may pass 2^31 entries: the level set's 125-channel
// table at 126x504x126 cells holds 1.0e9 (4.0 GB).
template <bool kMin, int K>
__global__ void __launch_bounds__(pfs::kThreads)
    fold_kernel(const __grid_constant__ FoldArgs a) {
  const int n = (int)((long)a.N[0] * a.N[1] * a.N[2]);
  const int stride = gridDim.x * pfs::kThreads;
  for (int i = blockIdx.x * pfs::kThreads + threadIdx.x; i < n; i += stride) {
    const int t[3] = {i / (a.N[1] * a.N[2]), (i / a.N[2]) % a.N[1], i % a.N[2]};
    // plane group of t per axis: [lo, hi] (empty when lo > hi)
    int lo[3], hi[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = t[ax] == 0 ? 0 : t[ax] - a.smin[ax];
      hi[ax] = t[ax] == a.N[ax] - 1 ? a.nint[ax] - 1 : t[ax] - a.smin[ax];
      lo[ax] = max(lo[ax], 0);
      hi[ax] = min(hi[ax], a.nint[ax] - 1);
    }
    float v2 = a.fill;
    for (int j2 = lo[2]; j2 <= hi[2]; ++j2) {
      float v1 = a.fill;
      for (int j1 = lo[1]; j1 <= hi[1]; ++j1) {
        float v0 = a.fill;
        for (int j0 = lo[0]; j0 <= hi[0]; ++j0) {
          const float c = channels<kMin, K>(a, j0, j1, j2);
          v0 = j0 == lo[0] ? c : combine<kMin>(v0, c);
        }
        v1 = j1 == lo[1] ? v0 : combine<kMin>(v1, v0);
      }
      v2 = j2 == lo[2] ? v1 : combine<kMin>(v2, v1);
    }
    a.out[i] = v2;
  }
}

}  // namespace

// shifts: S0 + S1 + S2 ints, axis by axis.
extern "C" int pfs_fold(const void* seg, long long cstride, void* out,
                        int E0, int E1, int E2, int N0, int N1, int N2,
                        int S0, int S1, int S2, const int* shifts, float fill,
                        int is_min, void* stream) {
  FoldArgs a;
  a.seg = static_cast<const float*>(seg);
  a.cstride = (long)cstride;
  a.out = static_cast<float*>(out);
  const int E[3] = {E0, E1, E2}, N[3] = {N0, N1, N2}, S[3] = {S0, S1, S2};
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
    a.nint[ax] = E[ax] + hi - lo;
  }
  a.fill = fill;
  const long n = (long)N0 * N1 * N2;
  if (n > (1L << 30)) return (int)cudaErrorInvalidValue;  // 32-bit target ids
  const unsigned blocks = (unsigned)((n + pfs::kThreads - 1) / pfs::kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smax = max(S0, max(S1, S2));
  void (*kernel)(FoldArgs);
  if (smax <= 2)
    kernel = is_min ? fold_kernel<true, 2> : fold_kernel<false, 2>;
  else if (smax <= 3)
    kernel = is_min ? fold_kernel<true, 3> : fold_kernel<false, 3>;
  else
    kernel = is_min ? fold_kernel<true, kMaxShifts> : fold_kernel<false, kMaxShifts>;
  kernel<<<blocks, pfs::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
