// Coupled 3-field Jacobi-PCG for the implicit viscosity system, the whole
// solve in one cooperative persistent kernel, with the 42 couplings and 3
// diagonals recomputed from the parity-class geometry every matvec.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_cg.py::
// make_fused_coupled_cg_geom (_make_geom_matvec + _make_bc_passes +
// _make_driver).  The TPU version streams x-slabs of the 10 geometry
// fields and 3 velocity fields through VMEM in three kernels per
// iteration driven by an XLA while_loop; here one launch runs the loop
// with grid barriers between the phases
//   A: q = A d (coefficients rebuilt from 7 vol + 3 sphi classes), d.q
//   B: x += alpha d; r -= alpha q; partial r.(r/pd) and r.r
//   C: d = r/pd + beta d
// so no scalar crosses to the host.  At the flagship grid the geometry
// (10 classes of ~49x81x49) and the 3-field CG state fit the 50 MB L2:
// an iteration there is bound by the barriers and by the ~50 L1/L2 loads
// per face of the recomputed stencil, not by device-memory bytes.  That
// holds only at the flagship: at 154x256x154 cells (18M faces) the
// working set is 537.6 MB, and more at 126x504x126, ten times L2, so each
// iteration streams it from device memory and the per-face loads miss
// L2 (PERF.md, row 2).  coupled_tile.cuh's tiled operator (the
// standalone matvec's) is the form phase A can take up.
//
// The stencil plan and the per-face apply (phase A) live in coupled_geom.cuh,
// shared with the standalone matvec (coupled_matvec.cu); this kernel calls
// it with every operation rounded on its own, as the matvec and the plain
// version do, so phase A's A d is bitwise coupled_matvec_plain's.  (With
// contraction allowed, the products that cancel in a face's sum left
// last-bit differences of up to 1.9e-5 at 24M faces, on an H100.)

#include <cstring>

#include "coupled_geom.cuh"
#include "pcg_common.cuh"

namespace {

namespace cg = cooperative_groups;
using pfs::kThreads;
using pfs::kWarps;

using pfs::coupled::Plan;

struct CoupledArgs {
  Plan plan;
  const float* geom;  // the 10 classes, concatenated
  const float* b;     // 3 face fields, concatenated
  const float* x0;
  const float* pd;
  const float* s_mu;  // device scalar
  float* x;
  float* r;
  float* d;
  float* q;
  float* part;  // 3 * gridDim.x floats: [dq | (delta, res) pairs]
  int* iters_out;
  float* res_out;
  float* res0_out;
  float* thresh_out;
  float tol2, rel2;
  int max_iter;
};

// Phase A's apply: the full coupled operator, each operation rounded.
template <bool kCoherent>
__device__ __forceinline__ float apply_a(const CoupledArgs& a, const float* v,
                                         int f, int cx, int cy, int cz,
                                         float smu) {
  return pfs::coupled::apply_a<kCoherent, pfs::coupled::kTerms>(
      a.plan, a.geom, v, f, cx, cy, cz, smu);
}

__global__ void __launch_bounds__(kThreads)
    coupled_visc_pcg_kernel(const __grid_constant__ CoupledArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[kWarps + 1];
  const long n = a.plan.off[3];
  const long stride = (long)gridDim.x * kThreads;
  const long i0 = (long)blockIdx.x * kThreads + threadIdx.x;
  const int nb = gridDim.x;
  float* part_dq = a.part;
  float* part_dr = a.part + nb;
  const float smu = *a.s_mu;

  // init: r = b - A x0, d = r / pd, x = x0
  float ld = 0.f, lr = 0.f;
  for (long i = i0; i < n; i += stride) {
    int f, cx, cy, cz;
    pfs::coupled::decode(a.plan, i, &f, &cx, &cy, &cz);
    const float rv = a.b[i] - apply_a<false>(a, a.x0, f, cx, cy, cz, smu);
    const float zv = rv / a.pd[i];
    a.x[i] = a.x0[i];
    a.r[i] = rv;
    a.d[i] = zv;
    ld += rv * zv;
    lr += rv * rv;
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
      int f, cx, cy, cz;
      pfs::coupled::decode(a.plan, i, &f, &cx, &cy, &cz);
      const float qv = apply_a<true>(a, a.d, f, cx, cy, cz, smu);
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
      a.x[i] = a.x[i] + alpha * __ldcg(a.d + i);
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
    *a.thresh_out = thresh;
  }
}

}  // namespace

// `plan` is a host buffer of `plan_bytes` bytes laid out as `Plan`.
extern "C" int pfs_coupled_visc_pcg(
    const void* plan, int plan_bytes, const void* geom, const void* b,
    const void* x0, const void* pd, const void* s_mu, void* x, void* r,
    void* d, void* q, void* part, int part_cap, void* iters, void* res,
    void* res0, void* thresh, float tol2, float rel2, int max_iter,
    void* stream) {
  if (plan_bytes != (int)sizeof(Plan)) return (int)cudaErrorInvalidValue;
  CoupledArgs a;
  memcpy(&a.plan, plan, sizeof(Plan));
  a.geom = static_cast<const float*>(geom);
  a.b = static_cast<const float*>(b);
  a.x0 = static_cast<const float*>(x0);
  a.pd = static_cast<const float*>(pd);
  a.s_mu = static_cast<const float*>(s_mu);
  a.x = static_cast<float*>(x);
  a.r = static_cast<float*>(r);
  a.d = static_cast<float*>(d);
  a.q = static_cast<float*>(q);
  a.part = static_cast<float*>(part);
  a.iters_out = static_cast<int*>(iters);
  a.res_out = static_cast<float*>(res);
  a.res0_out = static_cast<float*>(res0);
  a.thresh_out = static_cast<float*>(thresh);
  a.tol2 = tol2;
  a.rel2 = rel2;
  a.max_iter = max_iter;
  int grid = 0;
  cudaError_t e = pfs::coop_grid(coupled_visc_pcg_kernel, a.plan.off[3], &grid);
  if (e != cudaSuccess) return (int)e;
  if (3 * grid > part_cap) return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)coupled_visc_pcg_kernel, grid,
                                  kThreads, args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
