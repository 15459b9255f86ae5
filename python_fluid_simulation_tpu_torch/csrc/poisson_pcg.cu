// Jacobi-PCG for a 7-point cell-centred ghost-fluid system (pressure or
// density) from an initial guess x0, or from x0 = 0: the whole solve in
// one cooperative persistent kernel whose iterations touch only the
// system's live cells.
//
// Replaces two TPU kernels that compute the same function:
// python_fluid_simulation_tpu/ops/pallas_cg.py::make_fused_coupled_cg
// with F = 1 (reached through make_fused_poisson_cg; x0 given), which
// streams prev / cur / next x-slabs of the CG state through VMEM in three
// passes an iteration, and pallas_stencils.py::make_stencil_cg (x0 = 0),
// which keeps every CG vector in VMEM and loops inside one kernel.  The
// JAX package chooses between them by memory; the port launches this one
// kernel from both wrappers (ops/cuda_stencils.py::fused_poisson_pcg,
// ::cell_poisson_pcg).
//
// History.  The first port of make_stencil_cg was a three-phase kernel
// (q = A d; x, r update; direction update), each phase a
// grid-stride pass over every cell ended by a grid barrier: at the
// 48x80x48 flagship its 13 fields lived in L2 and an iteration was bound
// by the three barriers.  make_fused_coupled_cg's first port folded the
// direction update into the matvec phase (two barriers, 19 device-memory
// field passes an iteration over every cell): 0.253 ms an iteration on
// the 8.0M-cell coiling_504 pressure system and 0.196 at 256 (6.07M
// cells), on an H100 80GB HBM3 at 700 W.  Both streamed every cell,
// while the system lives on the fluid cells (0.8% of them at 504).
//
// Why only the live cells need an iteration.  Outside the fluid a row of
// the system is zero (diag and every coefficient 0) and so is b, and pd
// is 1 there.  Call a cell live when its row is nonzero or r0 = b - A x0
// is nonzero there.  A cell that is not live starts with r = 0 and
// d_old = 0 (the init writes both on every cell); its q would be
// A d = 0 (a zero row), so r stays 0, d = r/pd + beta d_old stays 0 and
// x stays x0 in every iteration.  Each dot gains +0 from it.  A live
// row's coupling into it multiplies a 0 direction: the same value the
// full-grid kernels computed there.  So the iterations walk a list of the
// live cells and compute, on every cell, the same expressions in the
// same rounding as before; only the grouping of the dot partials changes.
//
//   init  pass 1, every cell: x = x0, r = b - A x0, d0 = d1 = 0, partial
//         r.(r/pd) and r.r, and the live flag, one ballot word a warp
//         (the block owns a contiguous run of 32-cell words); the
//         block's count of live cells
//         grid barrier
//         pass 2: the block's offset (the counts of the blocks before it,
//         summed in a fixed order) and Na; the block's words, kBlock at
//         a time, scanned in the block, each thread writing the indices
//         of its word's live cells: the list is ascending, no atomics
//         grid barrier
//   A     over the list: d = r/pd + beta d_old (beta = 0 in the first
//         iteration), q = A d, partial d.q; the direction update folded
//         into the matvec: a thread computes each neighbour's direction
//         again where the coupling to it is nonzero (the same expression
//         on the same inputs, so the owner's bits); d ping-pongs between
//         d0 and d1
//   B     over the list: x += alpha d, r -= alpha q, partial r.(r/pd)
//         and r.r
//
// with a grid barrier after each phase: two an iteration.  Na stays in
// device memory (the wrapper makes no host read).  Neighbour reads stay at
// grid indices; the ascending list keeps z-runs contiguous, so a warp's
// own-cell reads coalesce.
//
// Semantics of the TPU solve loop (pallas_cg.py::_make_driver):
// thresh = max(tol^2, rel^2 res0) with the caller's fp32 tol^2 and rel^2,
// loop while res >= thresh and k < max_iter and delta != 0;
// alpha = delta/dq (0 if dq == 0), beta = delta'/delta (0 if delta == 0).
// pd must be 1 (never 0) on rows outside the system.  Every product, sum
// and quotient of a vector update is rounded on its own, in the order of
// the plain PyTorch version (ops/cuda_stencils.py::fused_poisson_pcg_plain,
// the generic CG); the stencil sums in pcg_common.cuh's stencil7 order (a
// skipped coupling adds a zero product).  Dot products are reduced per
// thread, per block and then over the blocks' partials in one fixed order,
// so a repeated solve is bitwise equal.  x0 may be null: x0 = 0, r0 = b
// (b - A 0 for finite coefficients), and neither x0 nor its neighbours are
// read.  Cell indices are 32-bit (the launcher refuses 2^31 - 64 cells or
// more).
//
// What bounds it on the H100.  The init streams every cell once (b, x0,
// diag, 6 coefficients and pd read; x, r, d0, d1 written; the flags and
// the list are 1/8 and 4 bytes a cell at most).  An iteration moves 21
// floats a live cell (A: the list entry, diag, 6 coefficients, r, pd and
// d_old read, d and q written; B: the entry, x, d, r, q and pd read, x and
// r written; the neighbours' r, pd and d_old come from L1/L2), so at
// ~6% live cells (256) the iteration's bytes are ~16x fewer than the
// full-grid kernel's and at 0.8% (504) its two grid barriers and the
// latency of the list -> coefficients -> neighbours chain bound it.

#include "pcg_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBlock = 512;
constexpr int kBlockWarps = kBlock / 32;

struct Args {
  pfs::Stencil7 A;
  const float* b;
  const float* x0;  // null: x0 = 0
  const float* pd;
  float* x;
  float* r;
  float* d0;  // ping-pong: iteration k reads d0 (k even) or d1, writes the other
  float* d1;
  float* q;
  float* part;      // 3 * gridDim.x floats: [dq | (delta, res) pairs]
  int* act;         // n: the live cells, ascending; Na of them are written
  unsigned* flags;  // ceil(n / 32) words: bit j of word w is cell 32 w + j
  int* counts;      // gridDim.x + 1: each block's live cells, then Na
  int* iters_out;
  float* res_out;
  float* res0_out;
  float tol2, rel2;
  int max_iter;
};

// The direction at cell i: r/pd + beta d_old, rounded as the plain CG's
// `beta * d + z` with z = r / pd.  r and d_old were written by other
// blocks before the last grid barrier: read through L2.
__device__ __forceinline__ float direction(const Args& a, const float* dold,
                                           long i, float beta) {
  const float z = __fdiv_rn(__ldcg(a.r + i), __ldg(a.pd + i));
  return __fadd_rn(__fmul_rn(beta, __ldcg(dold + i)), z);
}

// One coupling's term: c * d(neighbour j), the neighbour's direction read
// only where the coupling c is nonzero and j is inside the grid.
__device__ __forceinline__ float coupling(const Args& a, float c, bool inside,
                                          long j, const float* dold,
                                          float beta) {
  return __fmul_rn(c, (inside && c != 0.f) ? direction(a, dold, j, beta) : 0.f);
}

__global__ void __launch_bounds__(kBlock)
    poisson_pcg_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[kBlockWarps + 1];
  __shared__ int shi[kBlockWarps + 1];
  const pfs::Stencil7& s = a.A;
  const int X = s.X, Y = s.Y, Z = s.Z;
  const int yz = Y * Z;
  const int n = X * yz;
  const int nb = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* part_dq = a.part;
  float* part_dr = a.part + nb;  // interleaved (delta, res)

  // init, pass 1: the block's words [wbeg, wend), a warp a word
  const int nwords = (n + 31) / 32;
  const int per_block = (nwords + nb - 1) / nb;
  const int wbeg = min((int)blockIdx.x * per_block, nwords);
  const int wend = min(wbeg + per_block, nwords);
  float ld = 0.f, lr = 0.f;
  int live_count = 0;
  for (int w = wbeg + warp; w < wend; w += kBlockWarps) {
    const int i = w * 32 + lane;
    bool live = false;
    if (i < n) {
      const float dg = __ldg(s.diag + i);
      float c[6];
#pragma unroll
      for (int t = 0; t < 6; ++t) c[t] = __ldg(s.coef[t] + i);
      float rv = a.b[i];
      if (a.x0 != nullptr) {
        const int cz = i % Z, cy = (i / Z) % Y, cx = i / yz;
        const float* p = a.x0;
        float acc = __fmul_rn(dg, p[i]);
        acc = __fadd_rn(acc, __fmul_rn(c[0], cx + 1 < X ? p[i + yz] : 0.f));
        acc = __fadd_rn(acc, __fmul_rn(c[1], cx > 0 ? p[i - yz] : 0.f));
        acc = __fadd_rn(acc, __fmul_rn(c[2], cy + 1 < Y ? p[i + Z] : 0.f));
        acc = __fadd_rn(acc, __fmul_rn(c[3], cy > 0 ? p[i - Z] : 0.f));
        acc = __fadd_rn(acc, __fmul_rn(c[4], cz + 1 < Z ? p[i + 1] : 0.f));
        acc = __fadd_rn(acc, __fmul_rn(c[5], cz > 0 ? p[i - 1] : 0.f));
        rv = __fsub_rn(rv, acc);
        a.x[i] = p[i];
      } else {
        a.x[i] = 0.f;
      }
      a.r[i] = rv;
      a.d0[i] = 0.f;
      a.d1[i] = 0.f;
      ld += __fmul_rn(rv, __fdiv_rn(rv, a.pd[i]));
      lr += __fmul_rn(rv, rv);
      live = rv != 0.f || dg != 0.f || c[0] != 0.f || c[1] != 0.f || c[2] != 0.f ||
             c[3] != 0.f || c[4] != 0.f || c[5] != 0.f;
    }
    const unsigned word = __ballot_sync(0xffffffffu, live);
    if (lane == 0) {
      a.flags[w] = word;
      live_count += __popc(word);
    }
  }
  ld = pfs::block_sum<kBlock>(ld, sh);
  lr = pfs::block_sum<kBlock>(lr, sh);
  live_count = pfs::block_sum<kBlock, int>(live_count, shi);
  if (threadIdx.x == 0) {
    part_dr[2 * blockIdx.x] = ld;
    part_dr[2 * blockIdx.x + 1] = lr;
    a.counts[blockIdx.x] = live_count;
  }
  grid.sync();
  float delta = pfs::grid_total<kBlock>(part_dr, nb, 2, 0, sh);
  const float res0 = pfs::grid_total<kBlock>(part_dr, nb, 2, 1, sh);
  const float thresh = fmaxf(a.tol2, a.rel2 * res0);

  // init, pass 2: the block's part of the list, at its offset
  int before = 0, na = 0;
  for (int j = threadIdx.x; j < nb; j += kBlock) {
    const int cnt = __ldcg(a.counts + j);
    na += cnt;
    if (j < (int)blockIdx.x) before += cnt;
  }
  before = pfs::block_sum<kBlock, int>(before, shi);
  na = pfs::block_sum<kBlock, int>(na, shi);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.counts[nb] = na;
  for (int w0 = wbeg; w0 < wend; w0 += kBlock) {
    const int w = w0 + threadIdx.x;
    unsigned word = w < wend ? __ldcg(a.flags + w) : 0u;
    int in_round = 0;
    int pos = before + pfs::block_exclusive_scan<kBlock>(__popc(word), shi, &in_round);
    while (word != 0u) {
      a.act[pos++] = w * 32 + __ffs(word) - 1;
      word &= word - 1u;
    }
    before += in_round;
  }
  grid.sync();

  const int stride = nb * kBlock;
  const int k0 = (int)blockIdx.x * kBlock + threadIdx.x;
  float res = res0, beta = 0.f;
  int k = 0;
  while (res >= thresh && k < a.max_iter && delta != 0.f) {
    const float* dold = (k & 1) ? a.d1 : a.d0;
    float* dnew = (k & 1) ? a.d0 : a.d1;
    // A: d = r/pd + beta d_old, q = A d, partial d.q; the read-only
    // operator's loads are issued before any store
    float ldq = 0.f;
    for (int t = k0; t < na; t += stride) {
      const int i = __ldcg(a.act + t);
      const int cz = i % Z, cy = (i / Z) % Y, cx = i / yz;
      const float dg = __ldg(s.diag + i);
      float c[6];
#pragma unroll
      for (int u = 0; u < 6; ++u) c[u] = __ldg(s.coef[u] + i);
      const float dv = direction(a, dold, i, beta);
      float acc = __fmul_rn(dg, dv);
      acc = __fadd_rn(acc, coupling(a, c[0], cx + 1 < X, (long)i + yz, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[1], cx > 0, (long)i - yz, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[2], cy + 1 < Y, (long)i + Z, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[3], cy > 0, (long)i - Z, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[4], cz + 1 < Z, (long)i + 1, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[5], cz > 0, (long)i - 1, dold, beta));
      dnew[i] = dv;
      a.q[i] = acc;
      ldq += __fmul_rn(dv, acc);
    }
    ldq = pfs::block_sum<kBlock>(ldq, sh);
    if (threadIdx.x == 0) part_dq[blockIdx.x] = ldq;
    grid.sync();
    const float dq = pfs::grid_total<kBlock>(part_dq, nb, 1, 0, sh);
    const float alpha = dq != 0.f ? delta / dq : 0.f;

    // B: x += alpha d, r -= alpha q, partial r.(r/pd) and r.r
    ld = 0.f;
    lr = 0.f;
    for (int t = k0; t < na; t += stride) {
      const int i = __ldcg(a.act + t);
      a.x[i] = __fadd_rn(a.x[i], __fmul_rn(alpha, __ldcg(dnew + i)));
      const float rv = __fsub_rn(__ldcg(a.r + i), __fmul_rn(alpha, __ldcg(a.q + i)));
      a.r[i] = rv;
      ld += __fmul_rn(rv, __fdiv_rn(rv, a.pd[i]));
      lr += __fmul_rn(rv, rv);
    }
    ld = pfs::block_sum<kBlock>(ld, sh);
    lr = pfs::block_sum<kBlock>(lr, sh);
    if (threadIdx.x == 0) {
      part_dr[2 * blockIdx.x] = ld;
      part_dr[2 * blockIdx.x + 1] = lr;
    }
    grid.sync();
    const float new_delta = pfs::grid_total<kBlock>(part_dr, nb, 2, 0, sh);
    res = pfs::grid_total<kBlock>(part_dr, nb, 2, 1, sh);
    beta = delta != 0.f ? new_delta / delta : 0.f;
    delta = new_delta;
    ++k;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.iters_out = k;
    *a.res_out = res;
    *a.res0_out = res0;
  }
}

}  // namespace

// x0: null for x0 = 0.  d0, d1: the two direction buffers.  live: an int
// workspace of live_cap >= n + ceil(n / 32) + grid + 1 entries (the list,
// the flag words, the blocks' counts and Na), grid <= part_cap / 3.
// Returns a cudaError_t.
extern "C" int pfs_poisson_pcg(
    const void* b, const void* x0, const void* diag, const void* cxp,
    const void* cxm, const void* cyp, const void* cym, const void* czp,
    const void* czm, const void* pd, void* x, void* r, void* d0, void* d1,
    void* q, void* part, int part_cap, void* live, long long live_cap,
    void* iters, void* res, void* res0, int X, int Y, int Z, float tol2,
    float rel2, int max_iter, void* stream) {
  if (X < 1 || Y < 1 || Z < 1) return (int)cudaErrorInvalidValue;
  const long n = (long)X * Y * Z;
  if (n >= (1L << 31) - 64) return (int)cudaErrorInvalidValue;
  Args a;
  a.A = pfs::make_stencil7(diag, cxp, cxm, cyp, cym, czp, czm, X, Y, Z);
  a.b = static_cast<const float*>(b);
  a.x0 = static_cast<const float*>(x0);
  a.pd = static_cast<const float*>(pd);
  a.x = static_cast<float*>(x);
  a.r = static_cast<float*>(r);
  a.d0 = static_cast<float*>(d0);
  a.d1 = static_cast<float*>(d1);
  a.q = static_cast<float*>(q);
  a.part = static_cast<float*>(part);
  a.iters_out = static_cast<int*>(iters);
  a.res_out = static_cast<float*>(res);
  a.res0_out = static_cast<float*>(res0);
  a.tol2 = tol2;
  a.rel2 = rel2;
  a.max_iter = max_iter;
  int grid = 0;
  cudaError_t e = pfs::coop_grid(poisson_pcg_kernel, n, &grid, kBlock);
  if (e != cudaSuccess) return (int)e;
  const long nwords = (n + 31) / 32;
  if (3 * grid > part_cap || n + nwords + grid + 1 > live_cap) return (int)cudaErrorInvalidValue;
  int* w = static_cast<int*>(live);
  a.act = w;
  a.flags = reinterpret_cast<unsigned*>(w + n);
  a.counts = w + n + nwords;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)poisson_pcg_kernel, grid, kBlock,
                                  args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
