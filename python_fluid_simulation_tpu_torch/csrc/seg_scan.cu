// Inclusive segmented scan down sorted rows:
//   out[i, c] = combine(vals[j, c] for j in segment(i), j <= i)
// with combine add or min, where a segment is a run of rows whose
// `same` flag is set (same[i]: row i continues row i-1's segment).
//
// Replaces python_fluid_simulation_tpu/ops/pallas_segscan.py::
// seg_scan_sorted (_kernel, the roll doubling, and _kernel_mxu, the
// masked-triangular matmul for add).  The TPU kernels scan a 2048-row
// block in VMEM and carry the block's last row to the next grid step in
// scratch: its grid runs in order.  On Hopper blocks run in parallel and
// in no order, so the carry is a second pass:
//
// tile   a block loads R consecutive rows x C channels (R * C <= 8192
//        floats, R a multiple of 32 up to 1024) into shared memory with
//        coalesced reads, then one thread per (segment start in the tile,
//        channel) walks its segment's rows in shared memory, and the tile
//        is written back coalesced.  The tile's first row is taken as a
//        segment start whatever its flag says.
// carry  a block per tile boundary t (rows t*R - 1 | t*R): when row t*R
//        continues a segment that began in tile t-1, the boundary owns
//        that segment; one thread per channel walks it on from row t*R
//        (the last row of tile t-1, already right after the tile pass),
//        through every later tile it crosses, re-scanning those rows.
//        A segment that began before tile t-1 is owned by an earlier
//        boundary, so each row is rewritten by one thread at most.  No
//        atomics: the result does not depend on the order blocks run in.
//
// The association: every row combines the running value of the row
// before it, in row order -- out[i] = combine(out[i-1], vals[i]) inside
// a segment -- with each add rounded on its own (__fadd_rn).  That is
// the serial binned reduce's order (binned_segment.cu), so a segment's
// last row holds bitwise the serial kernel's sum when that starts from
// fill = 0, and the plain version (ops/cuda_scan.py::
// seg_scan_sorted_plain) applies the same operations.  The min is the
// serial kernel's and torch's: NaN propagates.
//
// What bounds it: bytes.  vals is read once and out written once (the
// carry pass re-reads only the rows of segments that cross a tile
// boundary).  The in-tile walk costs one shared-memory round trip a row;
// a segment of the step's reduces holds ~1-30 rows.
//
// Index widths: C <= 256 (the wrapper checks), R * C fits an int, and
// every element offset row * C + c is 64-bit, so a (K, C) array may pass
// 2^31 entries (the 125-channel level set at 2.85M particles holds 3.6e8).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 8192;  // shared floats a tile holds (32 KB)
constexpr int kMaxRows = 1024;     // rows a tile holds at most

template <bool kMin>
__device__ __forceinline__ float combine(float acc, float v) {
  if (kMin) return (v != v || v < acc) ? v : acc;  // NaN propagates
  return __fadd_rn(acc, v);
}

template <bool kMin>
__global__ void __launch_bounds__(kThreads)
    seg_scan_tile_kernel(const float* __restrict__ vals,
                         const unsigned char* __restrict__ same, long k,
                         int C, int R, float* __restrict__ out) {
  extern __shared__ float tile[];  // R x C, row-major
  __shared__ unsigned char start[kMaxRows];
  const long r0 = (long)blockIdx.x * R;
  const int n = k - r0 < R ? (int)(k - r0) : R;
  const int nc = n * C;
  const float* src = vals + r0 * C;
  for (int p = threadIdx.x; p < nc; p += kThreads) tile[p] = src[p];
  for (int r = threadIdx.x; r < n; r += kThreads)
    start[r] = r == 0 || !same[r0 + r];
  __syncthreads();
  for (int p = threadIdx.x; p < nc; p += kThreads) {
    const int r = p / C;
    if (!start[r]) continue;
    const int c = p - r * C;
    float acc = tile[p];
    for (int j = r + 1; j < n && !start[j]; ++j) {
      acc = combine<kMin>(acc, tile[j * C + c]);
      tile[j * C + c] = acc;
    }
  }
  __syncthreads();
  float* dst = out + r0 * C;
  for (int p = threadIdx.x; p < nc; p += kThreads) dst[p] = tile[p];
}

template <bool kMin>
__global__ void __launch_bounds__(kThreads)
    seg_scan_carry_kernel(const float* __restrict__ vals,
                          const unsigned char* __restrict__ same, long k,
                          int C, int R, float* __restrict__ out) {
  const long r0 = (long)(blockIdx.x + 1) * R;  // boundary rows r0 - 1 | r0
  if (!same[r0]) return;
  // the segment through r0 began in tile t-1 iff that tile holds a start
  int has_start = 0;
  for (int r = threadIdx.x; r < R; r += kThreads)
    has_start |= !same[r0 - R + r] || r0 - R + r == 0;
  if (!__syncthreads_or(has_start)) return;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc = out[(r0 - 1) * C + c];
    for (long i = r0; i < k && same[i]; ++i) {
      acc = combine<kMin>(acc, vals[i * C + c]);
      out[i * C + c] = acc;
    }
  }
}

}  // namespace

extern "C" int pfs_seg_scan(const void* vals, const void* same, long long k,
                            int C, int op_min, void* out, void* stream) {
  if (k <= 0 || C <= 0) return 0;
  int R = (kTileFloats / C) / 32 * 32;
  if (R < 32) return (int)cudaErrorInvalidValue;
  if (R > kMaxRows) R = kMaxRows;
  const long tiles = (k + R - 1) / R;
  const size_t smem = (size_t)R * C * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const unsigned char* s = static_cast<const unsigned char*>(same);
  float* o = static_cast<float*>(out);
  if (op_min)
    seg_scan_tile_kernel<true><<<(unsigned)tiles, kThreads, smem, st>>>(v, s, k, C, R, o);
  else
    seg_scan_tile_kernel<false><<<(unsigned)tiles, kThreads, smem, st>>>(v, s, k, C, R, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles < 2) return (int)err;
  if (op_min)
    seg_scan_carry_kernel<true><<<(unsigned)(tiles - 1), kThreads, 0, st>>>(v, s, k, C, R, o);
  else
    seg_scan_carry_kernel<false><<<(unsigned)(tiles - 1), kThreads, 0, st>>>(v, s, k, C, R, o);
  return (int)cudaGetLastError();
}
