// The coupled viscosity operator with its coefficients rebuilt from the
// parity-class geometry: the stencil plan's layout, shared by the tiled
// operator (coupled_tile.cuh) and its two kernels, the standalone matvec
// (coupled_matvec.cu) and the coupled PCG (coupled_visc_pcg.cu).
//
// The plan (which class, offset and sign*factor feeds each term) is built
// on the host from solvers/viscosity.py::_terms_for_axis (it depends on no
// resolution) and passed by value in each kernel's __grid_constant__
// parameter; coupled_tile.cuh compiles the same table in and refuses a
// host plan that differs.  Products follow viscosity_term_fields' fp32
// order: w = (sign*factor)*s_mu; term = where(mask, w*vol, 0) * v; the
// fluid test is sphi >= 0.  Geometry reads outside a class array read 0
// (vol) or -1 (sphi); velocity reads outside a face array read 0.
//
// Index widths: the plan's class and field offsets are 32-bit words (the
// host checks that the geometry and the three face arrays each hold fewer
// than 2^31 entries: 64.6M and 24.2M at 126x504x126 cells); every element
// index is computed in 64 bits from them.
#pragma once

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

}  // namespace coupled
}  // namespace pfs
