// Jacobi-PCG for the 7-point cell-centred ghost-fluid systems (pressure
// and density), the whole solve in one cooperative persistent kernel.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_stencils.py::
// make_stencil_cg (the TPU kernel keeps every CG vector in VMEM and loops
// inside one kernel).  Here the vectors stay in device memory — at the
// flagship grid (48x80x48 cells, 0.74 MB a field) the whole working set
// of 13 fields fits the 50 MB L2 — and the loop runs inside one launch:
// no host sync and no launch per iteration.  Per iteration three phases,
// each ended by a grid barrier:
//   A: q = A d and partial d.q
//   B: x += alpha d; r -= alpha q; partial r.(r/pd) and r.r
//   C: d = r/pd + beta d
// The iteration is bound by the barriers and by L2 traffic (~20 field
// passes), not by the device-memory bytes of its inputs.
//
// Semantics follow the TPU kernel: x0 = 0, d0 = b/pd,
// thresh = max(tol^2, rel^2 res0), loop while res >= thresh and
// k < max_iter and delta != 0; alpha = delta/dq (0 if dq == 0),
// beta = delta'/delta (0 if delta == 0).  Neighbour reads outside the
// grid read 0 (the coefficient fields are zero there anyway).  The
// stencil is pcg_common.cuh's stencil7, shared with stencil_matvec.cu and
// mg_level_chain.cu.

#include "pcg_common.cuh"

namespace {

namespace cg = cooperative_groups;
using pfs::kThreads;
using pfs::kWarps;

struct PoissonArgs {
  pfs::Stencil7 A;
  const float* b;
  const float* pd;
  float* x;
  float* r;
  float* d;
  float* q;
  float* part;  // 3 * gridDim.x floats: [dq | (delta, res) pairs]
  int* iters_out;
  float* res_out;
  float* res0_out;
  float tol2, rel2;
  int max_iter;
};

__global__ void __launch_bounds__(kThreads)
    cell_poisson_pcg_kernel(PoissonArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[kWarps + 1];
  const long n = (long)a.A.X * a.A.Y * a.A.Z;
  const long stride = (long)gridDim.x * kThreads;
  const long i0 = (long)blockIdx.x * kThreads + threadIdx.x;
  const int nb = gridDim.x;
  float* part_dq = a.part;
  float* part_dr = a.part + nb;  // interleaved (delta, res)

  // init: x = 0, r = b, d = b / pd
  float ld = 0.f, lr = 0.f;
  for (long i = i0; i < n; i += stride) {
    const float bv = a.b[i];
    const float dv = bv / a.pd[i];
    a.x[i] = 0.f;
    a.r[i] = bv;
    a.d[i] = dv;
    ld += bv * dv;
    lr += bv * bv;
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
  float res = res0;
  int k = 0;

  while (res >= thresh && k < a.max_iter && delta != 0.f) {
    // A: q = A d, partial d.q
    float ldq = 0.f;
    for (long i = i0; i < n; i += stride) {
      const float qv = pfs::stencil7(a.A, a.d, i);
      a.q[i] = qv;
      ldq += __ldcg(a.d + i) * qv;
    }
    ldq = pfs::block_sum(ldq, sh);
    if (threadIdx.x == 0) part_dq[blockIdx.x] = ldq;
    grid.sync();
    const float dq = pfs::grid_total(part_dq, nb, 1, 0, sh);
    const float alpha = dq != 0.f ? delta / dq : 0.f;

    // B: x += alpha d, r -= alpha q, partial r.z and r.r
    ld = 0.f;
    lr = 0.f;
    for (long i = i0; i < n; i += stride) {
      const float dv = __ldcg(a.d + i);
      a.x[i] = a.x[i] + alpha * dv;
      const float rv = a.r[i] - alpha * a.q[i];
      a.r[i] = rv;
      ld += rv * (rv / a.pd[i]);
      lr += rv * rv;
    }
    ld = pfs::block_sum(ld, sh);
    lr = pfs::block_sum(lr, sh);
    if (threadIdx.x == 0) {
      part_dr[2 * blockIdx.x] = ld;
      part_dr[2 * blockIdx.x + 1] = lr;
    }
    grid.sync();
    const float new_delta = pfs::grid_total(part_dr, nb, 2, 0, sh);
    const float new_res = pfs::grid_total(part_dr, nb, 2, 1, sh);
    const float beta = delta != 0.f ? new_delta / delta : 0.f;

    // C: d = r / pd + beta d
    for (long i = i0; i < n; i += stride)
      a.d[i] = a.r[i] / a.pd[i] + beta * __ldcg(a.d + i);
    delta = new_delta;
    res = new_res;
    ++k;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.iters_out = k;
    *a.res_out = res;
    *a.res0_out = res0;
  }
}

}  // namespace

extern "C" int pfs_cell_poisson_pcg(
    const void* b, const void* diag, const void* cxp, const void* cxm,
    const void* cyp, const void* cym, const void* czp, const void* czm,
    const void* pd, void* x, void* r, void* d, void* q, void* part,
    int part_cap, void* iters, void* res, void* res0, int X, int Y, int Z,
    float tol2, float rel2, int max_iter, void* stream) {
  PoissonArgs a;
  a.A = pfs::make_stencil7(diag, cxp, cxm, cyp, cym, czp, czm, X, Y, Z);
  a.b = static_cast<const float*>(b);
  a.pd = static_cast<const float*>(pd);
  a.x = static_cast<float*>(x);
  a.r = static_cast<float*>(r);
  a.d = static_cast<float*>(d);
  a.q = static_cast<float*>(q);
  a.part = static_cast<float*>(part);
  a.iters_out = static_cast<int*>(iters);
  a.res_out = static_cast<float*>(res);
  a.res0_out = static_cast<float*>(res0);
  a.tol2 = tol2;
  a.rel2 = rel2;
  a.max_iter = max_iter;
  int grid = 0;
  cudaError_t e = pfs::coop_grid(cell_poisson_pcg_kernel, (long)X * Y * Z, &grid);
  if (e != cudaSuccess) return (int)e;
  if (3 * grid > part_cap) return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)cell_poisson_pcg_kernel, grid,
                                  kThreads, args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
