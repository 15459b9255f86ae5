// Jacobi-PCG for a 7-point cell-centred system (pressure or density) from
// an initial guess x0, for grids whose CG working set is several times L2:
// the whole solve in one cooperative persistent kernel, every field pass a
// device-memory pass.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_cg.py::
// make_fused_coupled_cg (with F = 1, reached through make_fused_poisson_cg):
// the TPU kernel keeps the CG state in a padded blocked layout and streams
// prev / cur / next x-slabs of d and the coefficient slabs through VMEM, in
// three passes an iteration (matvec + d.q, x/r update + dots, direction
// update), with the scalar recurrences in an XLA while_loop.  Here:
//
//   init  x = x0, r = b - A x0, d_old = 0, partial r.(r/pd) and r.r
//   A     d = r/pd + beta d_old (beta = 0 in the first iteration), q = A d,
//         partial d.q -- the direction update folded into the matvec pass
//   B     x += alpha d, r -= alpha q, partial r.(r/pd) and r.r
//
// with a grid barrier after each phase: two an iteration (the three-phase
// cell_poisson_pcg.cu needs three).  In phase A one thread a cell computes
// its own direction, writes it, and computes each neighbour's direction
// again from the neighbour's r, pd and d_old where the coupling to it is
// nonzero (in a free-surface grid most couplings are 0, so most neighbour
// reads are skipped): the same expression on the same inputs, so every
// thread gets the owner's bits.  d ping-pongs between two buffers: the
// neighbours read the previous direction while the owners write the new
// one.
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
// so a repeated solve is bitwise equal.  Indices are 64-bit.
//
// What bounds it on the H100: device-memory bytes.  An iteration moves 19
// field passes (A: r, pd, d_old, diag and 6 coefficients read, d and q
// written; B: x, d, r, q, pd read, x and r written), ~608 MB at
// 126x504x126 cells, ~0.18 ms at 3.35 TB/s; the neighbours' r, pd and
// d_old come from L1/L2.  Measured on the coiling_504 pressure system (an
// H100 80GB HBM3 at 700 W, chip_smoke.py): 0.253 ms an iteration against
// cell_poisson_pcg's 0.282.  A first design that marched x through a ring
// of planes in shared memory, with a block barrier a plane, was slower
// than cell_poisson_pcg (probably too few loads in flight between the
// barriers); so was this design until phase A issued the operator's
// seven loads before its first store.

#include "pcg_common.cuh"

namespace {

namespace cg = cooperative_groups;
using pfs::kThreads;

struct Args {
  pfs::Stencil7 A;
  const float* b;
  const float* x0;
  const float* pd;
  float* x;
  float* r;
  float* d0;  // ping-pong: iteration k reads d0 (k even) or d1, writes the other
  float* d1;
  float* q;
  float* part;  // 3 * gridDim.x floats: [dq | (delta, res) pairs]
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

__global__ void __launch_bounds__(kThreads)
    fused_poisson_pcg_kernel(const __grid_constant__ Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[pfs::kWarps + 1];
  const pfs::Stencil7& s = a.A;
  const long Y = s.Y, Z = s.Z;
  const long yz = Y * Z;
  const long n = s.X * yz;
  const long stride = (long)gridDim.x * kThreads;
  const long i0 = (long)blockIdx.x * kThreads + threadIdx.x;
  const int nb = gridDim.x;
  float* part_dq = a.part;
  float* part_dr = a.part + nb;  // interleaved (delta, res)

  // init: x = x0, r = b - A x0, d_old = 0
  float ld = 0.f, lr = 0.f;
  for (long i = i0; i < n; i += stride) {
    const float rv = __fsub_rn(a.b[i], pfs::stencil7(s, a.x0, i));
    a.x[i] = a.x0[i];
    a.r[i] = rv;
    a.d0[i] = 0.f;
    ld += __fmul_rn(rv, __fdiv_rn(rv, a.pd[i]));
    lr += __fmul_rn(rv, rv);
  }
  ld = pfs::block_sum(ld, sh);
  lr = pfs::block_sum(lr, sh);
  if (threadIdx.x == 0) {
    part_dr[2 * blockIdx.x] = ld;
    part_dr[2 * blockIdx.x + 1] = lr;
  }
  grid.sync();
  float delta = pfs::grid_total(part_dr, nb, 2, 0, sh);
  const float res0 = pfs::grid_total(part_dr, nb, 2, 1, sh);
  const float thresh = fmaxf(a.tol2, a.rel2 * res0);
  float res = res0, beta = 0.f;
  int k = 0;

  while (res >= thresh && k < a.max_iter && delta != 0.f) {
    const float* dold = (k & 1) ? a.d1 : a.d0;
    float* dnew = (k & 1) ? a.d0 : a.d1;
    // A: d = r/pd + beta d_old, q = A d, partial d.q; the read-only
    // operator's loads are issued before any store
    float ldq = 0.f;
    for (long i = i0; i < n; i += stride) {
      const int cz = (int)(i % Z);
      const int cy = (int)((i / Z) % Y);
      const int cx = (int)(i / yz);
      const float dg = __ldg(s.diag + i);
      float c[6];
#pragma unroll
      for (int t = 0; t < 6; ++t) c[t] = __ldg(s.coef[t] + i);
      const float dv = direction(a, dold, i, beta);
      float acc = __fmul_rn(dg, dv);
      acc = __fadd_rn(acc, coupling(a, c[0], cx + 1 < s.X, i + yz, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[1], cx > 0, i - yz, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[2], cy + 1 < s.Y, i + Z, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[3], cy > 0, i - Z, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[4], cz + 1 < s.Z, i + 1, dold, beta));
      acc = __fadd_rn(acc, coupling(a, c[5], cz > 0, i - 1, dold, beta));
      dnew[i] = dv;
      a.q[i] = acc;
      ldq += __fmul_rn(dv, acc);
    }
    ldq = pfs::block_sum(ldq, sh);
    if (threadIdx.x == 0) part_dq[blockIdx.x] = ldq;
    grid.sync();
    const float dq = pfs::grid_total(part_dq, nb, 1, 0, sh);
    const float alpha = dq != 0.f ? delta / dq : 0.f;

    // B: x += alpha d, r -= alpha q, partial r.(r/pd) and r.r
    ld = 0.f;
    lr = 0.f;
    for (long i = i0; i < n; i += stride) {
      a.x[i] = __fadd_rn(a.x[i], __fmul_rn(alpha, __ldcg(dnew + i)));
      const float rv = __fsub_rn(__ldcg(a.r + i), __fmul_rn(alpha, __ldcg(a.q + i)));
      a.r[i] = rv;
      ld += __fmul_rn(rv, __fdiv_rn(rv, a.pd[i]));
      lr += __fmul_rn(rv, rv);
    }
    ld = pfs::block_sum(ld, sh);
    lr = pfs::block_sum(lr, sh);
    if (threadIdx.x == 0) {
      part_dr[2 * blockIdx.x] = ld;
      part_dr[2 * blockIdx.x + 1] = lr;
    }
    grid.sync();
    const float new_delta = pfs::grid_total(part_dr, nb, 2, 0, sh);
    res = pfs::grid_total(part_dr, nb, 2, 1, sh);
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

// d0, d1: the two direction buffers.  Returns a cudaError_t.
extern "C" int pfs_fused_poisson_pcg(
    const void* b, const void* x0, const void* diag, const void* cxp,
    const void* cxm, const void* cyp, const void* cym, const void* czp,
    const void* czm, const void* pd, void* x, void* r, void* d0, void* d1,
    void* q, void* part, int part_cap, void* iters, void* res, void* res0,
    int X, int Y, int Z, float tol2, float rel2, int max_iter, void* stream) {
  if (X < 1 || Y < 1 || Z < 1) return (int)cudaErrorInvalidValue;
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
  cudaError_t e = pfs::coop_grid(fused_poisson_pcg_kernel, (long)X * Y * Z, &grid);
  if (e != cudaSuccess) return (int)e;
  if (3 * grid > part_cap) return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)fused_poisson_pcg_kernel, grid,
                                  kThreads, args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
