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
// an iteration is bound by the barriers and by the ~50 L1/L2 loads per
// face of the recomputed stencil, not by device-memory bytes.
//
// The stencil plan (which class, offset and sign*factor feeds each term)
// is built on the host from solvers/viscosity.py::_terms_for_axis (it
// depends only on the grid resolution) and passed by value in the
// kernel's __grid_constant__ parameter, so this file holds no copy of the
// term table and the launch needs no copy to device memory.
// Products follow viscosity_term_fields' fp32 order:
// w = (sign*factor)*s_mu; term = where(mask, w*vol, 0) * v; the fluid
// test is sphi >= 0.  Geometry reads outside a class array read 0 (vol)
// or -1 (sphi); velocity reads outside a face array read 0.

#include <cstring>

#include "pcg_common.cuh"

namespace {

namespace cg = cooperative_groups;
using pfs::kThreads;
using pfs::kWarps;

constexpr int kTerms = 14;
constexpr int kDiag = 7;   // center + 6 neighbours
constexpr int kClasses = 10;

struct Term {
  int field;
  int vo[3];    // velocity offset into face array `field`
  int scls;     // sphi class of the coupling's fluid test
  int ck[3];
  int vcls;     // vol class of the control volume
  int vk[3];
  float sf;     // sign * factor
};

struct AxisPlan {
  int active_cls;
  int diag_cls[kDiag];
  int diag_k[kDiag][3];
  float diag_factor[kDiag];  // [0] unused (the centre is unscaled)
  Term terms[kTerms];
};

// Every member is a 4-byte word; the host builds the same layout.
struct Plan {
  AxisPlan ax[3];
  int cls_dim[kClasses][3];
  int cls_off[kClasses];     // offset of each class in the geometry buffer
  int cls_is_sphi[kClasses];
  int n[3];                  // cell resolution
  int off[4];                // field offsets in the concatenated layout
};

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

__device__ __forceinline__ float geom(const CoupledArgs& a, int c, int gx,
                                      int gy, int gz) {
  const int* dim = a.plan.cls_dim[c];
  if (gx < 0 || gx >= dim[0] || gy < 0 || gy >= dim[1] || gz < 0 ||
      gz >= dim[2])
    return a.plan.cls_is_sphi[c] ? -1.f : 0.f;
  return __ldg(a.geom + a.plan.cls_off[c] +
               ((long)gx * dim[1] + gy) * dim[2] + gz);
}

__device__ __forceinline__ void face_shape(const Plan& p, int f, int* s) {
  s[0] = p.n[0] + (f == 0);
  s[1] = p.n[1] + (f == 1);
  s[2] = p.n[2] + (f == 2);
}

// (A v) at face (cx, cy, cz) of field f; v is the concatenated 3-field
// vector, read through L2 when it is written inside the kernel.
template <bool kCoherent>
__device__ __forceinline__ float apply_a(const CoupledArgs& a, const float* v, int f, int cx,
                         int cy, int cz, float smu) {
  const AxisPlan& P = a.plan.ax[f];
  int s[3];
  face_shape(a.plan, f, s);
  const bool interior = cx >= 1 && cx <= s[0] - 2 && cy >= 1 &&
                        cy <= s[1] - 2 && cz >= 1 && cz <= s[2] - 2;
  const bool active = interior && geom(a, P.active_cls, cx, cy, cz) >= 0.f;
  const float center = geom(a, P.diag_cls[0], cx + P.diag_k[0][0],
                            cy + P.diag_k[0][1], cz + P.diag_k[0][2]);
  float extra = 0.f;
#pragma unroll
  for (int j = 1; j < kDiag; ++j)
    extra = extra + P.diag_factor[j] * geom(a, P.diag_cls[j],
                                            cx + P.diag_k[j][0],
                                            cy + P.diag_k[j][1],
                                            cz + P.diag_k[j][2]);
  const float diag_raw = center + smu * extra;
  const long self = a.plan.off[f] + ((long)cx * s[1] + cy) * s[2] + cz;
  const float vself = kCoherent ? __ldcg(v + self) : v[self];
  float acc = (active ? diag_raw : 0.f) * vself;
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    const Term& T = P.terms[t];
    const float w = T.sf * smu;
    const bool fluid =
        geom(a, T.scls, cx + T.ck[0], cy + T.ck[1], cz + T.ck[2]) >= 0.f;
    const float coef =
        (active && fluid)
            ? w * geom(a, T.vcls, cx + T.vk[0], cy + T.vk[1], cz + T.vk[2])
            : 0.f;
    int u[3];
    face_shape(a.plan, T.field, u);
    const int vx = cx + T.vo[0], vy = cy + T.vo[1], vz = cz + T.vo[2];
    float vv = 0.f;
    if (vx >= 0 && vx < u[0] && vy >= 0 && vy < u[1] && vz >= 0 && vz < u[2]) {
      const long j = a.plan.off[T.field] + ((long)vx * u[1] + vy) * u[2] + vz;
      vv = kCoherent ? __ldcg(v + j) : v[j];
    }
    acc = acc + coef * vv;
  }
  return acc;
}

__device__ __forceinline__ void decode(const Plan& p, long i, int* f, int* cx,
                                       int* cy, int* cz) {
  const int ff = i < p.off[1] ? 0 : (i < p.off[2] ? 1 : 2);
  int s[3];
  face_shape(p, ff, s);
  const long l = i - p.off[ff];
  *f = ff;
  *cz = (int)(l % s[2]);
  *cy = (int)((l / s[2]) % s[1]);
  *cx = (int)(l / ((long)s[1] * s[2]));
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
    decode(a.plan, i, &f, &cx, &cy, &cz);
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
      decode(a.plan, i, &f, &cx, &cy, &cz);
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
