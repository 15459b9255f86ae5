// The coupled viscosity operator with its coefficients rebuilt from the
// parity-class geometry: the stencil plan and the per-face apply, shared by
// the fused Jacobi-PCG (coupled_visc_pcg.cu, phase A) and the standalone
// matvec (coupled_matvec.cu).
//
// The plan (which class, offset and sign*factor feeds each term) is built
// on the host from solvers/viscosity.py::_terms_for_axis (it depends only
// on the grid resolution) and passed by value in each kernel's
// __grid_constant__ parameter, so this file holds no copy of the term
// table.  Products follow viscosity_term_fields' fp32 order:
// w = (sign*factor)*s_mu; term = where(mask, w*vol, 0) * v; the fluid test
// is sphi >= 0.  Geometry reads outside a class array read 0 (vol) or -1
// (sphi); velocity reads outside a face array read 0.
//
// Index widths: the plan's class and field offsets are 32-bit words (the
// host checks that the geometry and the three face arrays each hold fewer
// than 2^31 entries: 64.6M and 24.2M at 126x504x126 cells); every element
// index is computed in 64 bits from them.
#pragma once

#include <cuda_runtime.h>

namespace pfs {
namespace coupled {

constexpr int kTerms = 14;
// the 6 same-field couplings lead each axis' term table
// (_terms_for_axis: the face-axis pair, then the transverse pairs)
constexpr int kSameTerms = 6;
constexpr int kDiag = 7;  // center + 6 neighbours
constexpr int kClasses = 10;

struct Term {
  int field;
  int vo[3];  // velocity offset into face array `field`
  int scls;   // sphi class of the coupling's fluid test
  int ck[3];
  int vcls;  // vol class of the control volume
  int vk[3];
  float sf;  // sign * factor
};

struct AxisPlan {
  int active_cls;
  int diag_cls[kDiag];
  int diag_k[kDiag][3];
  float diag_factor[kDiag];  // [0] unused (the centre is unscaled)
  Term terms[kTerms];
};

// Every member is a 4-byte word; the host builds the same layout
// (ops/cuda_cg.py::plan_words).
struct Plan {
  AxisPlan ax[3];
  int cls_dim[kClasses][3];
  int cls_off[kClasses];  // offset of each class in the geometry buffer
  int cls_is_sphi[kClasses];
  int n[3];    // cell resolution
  int off[4];  // field offsets in the concatenated layout
};

__device__ __forceinline__ float geom(const Plan& p, const float* g, int c,
                                      int gx, int gy, int gz) {
  const int* dim = p.cls_dim[c];
  if (gx < 0 || gx >= dim[0] || gy < 0 || gy >= dim[1] || gz < 0 ||
      gz >= dim[2])
    return p.cls_is_sphi[c] ? -1.f : 0.f;
  return __ldg(g + p.cls_off[c] + ((long)gx * dim[1] + gy) * dim[2] + gz);
}

__device__ __forceinline__ void face_shape(const Plan& p, int f, int* s) {
  s[0] = p.n[0] + (f == 0);
  s[1] = p.n[1] + (f == 1);
  s[2] = p.n[2] + (f == 2);
}

// (A v) at face (cx, cy, cz) of field f; v is the concatenated 3-field
// vector, read through L2 (kCoherent) when it is written inside the kernel.
// kNTerms = kTerms: the coupled operator; kSameTerms: its block-diagonal
// part (the diagonal and the 6 same-field couplings).  Every product and
// sum is rounded on its own (no FMA contraction), so the result is bitwise
// the plain PyTorch version's.
template <bool kCoherent, int kNTerms>
__device__ __forceinline__ float apply_a(const Plan& p, const float* g,
                                         const float* v, int f, int cx,
                                         int cy, int cz, float smu) {
  const AxisPlan& P = p.ax[f];
  int s[3];
  face_shape(p, f, s);
  const bool interior = cx >= 1 && cx <= s[0] - 2 && cy >= 1 &&
                        cy <= s[1] - 2 && cz >= 1 && cz <= s[2] - 2;
  const bool active = interior && geom(p, g, P.active_cls, cx, cy, cz) >= 0.f;
  const float center = geom(p, g, P.diag_cls[0], cx + P.diag_k[0][0],
                            cy + P.diag_k[0][1], cz + P.diag_k[0][2]);
  float extra = 0.f;
#pragma unroll
  for (int j = 1; j < kDiag; ++j)
    extra = __fadd_rn(
        extra, __fmul_rn(P.diag_factor[j],
                           geom(p, g, P.diag_cls[j], cx + P.diag_k[j][0],
                                cy + P.diag_k[j][1], cz + P.diag_k[j][2])));
  const float diag_raw = __fadd_rn(center, __fmul_rn(smu, extra));
  const long self = p.off[f] + ((long)cx * s[1] + cy) * s[2] + cz;
  const float vself = kCoherent ? __ldcg(v + self) : v[self];
  float acc = __fmul_rn(active ? diag_raw : 0.f, vself);
#pragma unroll
  for (int t = 0; t < kNTerms; ++t) {
    const Term& T = P.terms[t];
    const float w = __fmul_rn(T.sf, smu);
    const bool fluid =
        geom(p, g, T.scls, cx + T.ck[0], cy + T.ck[1], cz + T.ck[2]) >= 0.f;
    const float coef =
        (active && fluid)
            ? __fmul_rn(w, geom(p, g, T.vcls, cx + T.vk[0], cy + T.vk[1],
                                  cz + T.vk[2]))
            : 0.f;
    int u[3];
    face_shape(p, T.field, u);
    const int vx = cx + T.vo[0], vy = cy + T.vo[1], vz = cz + T.vo[2];
    float vv = 0.f;
    if (vx >= 0 && vx < u[0] && vy >= 0 && vy < u[1] && vz >= 0 && vz < u[2]) {
      const long j = p.off[T.field] + ((long)vx * u[1] + vy) * u[2] + vz;
      vv = kCoherent ? __ldcg(v + j) : v[j];
    }
    acc = __fadd_rn(acc, __fmul_rn(coef, vv));
  }
  return acc;
}

// Element i of the concatenated 3-field layout -> (field, cx, cy, cz).
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

}  // namespace coupled
}  // namespace pfs
