// The coupled viscosity operator as a tiled stencil: q = A v on the three
// face arrays, coefficients rebuilt from the parity-class geometry, each
// block walking a brick of faces out of shared memory.  The standalone
// matvec (coupled_matvec.cu) launches one brick a block; the coupled PCG
// (coupled_visc_pcg.cu) calls `matvec_brick` for each brick its persistent
// blocks own, in its init (A x0) and in every phase A (A d).
//
// The term table.  ops/cuda_cg.py::stencil_plan() (built from
// solvers/viscosity.py::_terms_for_axis) depends on no resolution, so it
// is compiled in here (`axis_plan`, class ids numbered as
// ops/cuda_cg.py::_class_ids numbers them): every class, shift and
// sign*factor is a compile-time constant of the kernel, so no face reads a
// plan through a runtime axis.  tests/test_torch_kernel_plans.py holds
// this table to stencil_plan(), and the launchers compare it with the
// host's plan (ops/cuda_cg.py::plan_words) on every launch and refuse one
// that differs.  Only the class extents and the array offsets (Plan's
// cls_dim, cls_off, n, off) stay runtime.
//
// The tiling.  A brick is kTY x kTZ (y, z) columns of the union face box
// (n0+1) x (n1+1) x (n2+1), one a thread, walking `chunk` x planes (the
// host's plan: ops/cuda_cg.py::matvec_tiling).  At each x plane a thread
// computes the faces of all three fields at its (x, y, z) that lie inside
// that field's array, so the 10 geometry classes and the 3 velocity
// fields are staged once for all three fields (a face reads 7 classes and
// all 3 fields).  Staged per plane: each array's (kTY + 2) x (kTZ + 2)
// window with its one-cell halo (every shift of the table is within one
// cell, checked below), into a ring of kRing planes of shared memory:
// x - 1, x and x + 1 are read while x + 2 lands through cp.async, one
// barrier a plane.  A face reads shared memory with no bounds test: the
// staged values outside an array are its fill -- -1 for sphi, 0 for vol
// and v, the fills of the plain version's `sample`.
//
// Two stagings fill the ring (`Ring` gives each its row width):
// - `stage_plane` (the standalone matvec, `ArrayRing`, rows of 34) reads
//   the caller's arrays in 4-byte cp.async.ca copies behind bounds tests,
//   and writes the fills itself;
// - `stage_box_plane` (the coupled PCG, `BoxRing`, rows of 36) reads the
//   PCG's padded box, where every array already holds its fills in a
//   one-cell border and z rows start on 16 bytes: 16-byte copies, no
//   bounds test but the box's edge.  They are cp.async.cg, through L2:
//   other blocks of the persistent kernel wrote the staged d (and the box
//   itself) before the last grid barrier, and L1 is not coherent with
//   their writes.
//
// Arithmetic: the products of viscosity_term_fields, in its order, each
// rounded on its own (__fmul_rn / __fadd_rn, no FMA), so q is bitwise
// ops/cuda_cg.py::coupled_matvec_plain, full and same-axis (kNTerms =
// kSameTerms: the first 6 terms of each axis).
#pragma once

#include <cuda_runtime.h>

#include <utility>

#include "coupled_geom.cuh"

namespace pfs {
namespace coupled {
namespace tile {

// ---- the term table: per axis {active sphi class, the 7 diagonal vol
// classes, their shifts, their factors ([0] unused), the 14 terms {field,
// v shift, sphi class, its shift, vol class, its shift, sign*factor}}
__host__ __device__ constexpr AxisPlan axis_plan(int a) {
  constexpr AxisPlan kAxisPlans[3] = {
      {  // axis 0
          7,  // active: sphi class
          {2, 6, 6, 0, 0, 1, 1},
          {{0, 0, 0}, {0, 0, 0}, {-1, 0, 0}, {0, 1, 0}, {0, 0, 0}, {0, 0, 1}, {0, 0, 0}},
          {0.0f, 2.0f, 2.0f, 1.0f, 1.0f, 1.0f, 1.0f},
          {
              {0, {1, 0, 0}, 7, {1, 0, 0}, 6, {0, 0, 0}, -2.0f},
              {0, {-1, 0, 0}, 7, {-1, 0, 0}, 6, {-1, 0, 0}, -2.0f},
              {0, {0, 1, 0}, 7, {0, 1, 0}, 0, {0, 1, 0}, -1.0f},
              {0, {0, -1, 0}, 7, {0, -1, 0}, 0, {0, 0, 0}, -1.0f},
              {0, {0, 0, 1}, 7, {0, 0, 1}, 1, {0, 0, 1}, -1.0f},
              {0, {0, 0, -1}, 7, {0, 0, -1}, 1, {0, 0, 0}, -1.0f},
              {1, {0, 1, 0}, 8, {0, 1, 0}, 0, {0, 1, 0}, -1.0f},
              {1, {-1, 1, 0}, 8, {-1, 1, 0}, 0, {0, 1, 0}, 1.0f},
              {1, {0, 0, 0}, 8, {0, 0, 0}, 0, {0, 0, 0}, 1.0f},
              {1, {-1, 0, 0}, 8, {-1, 0, 0}, 0, {0, 0, 0}, -1.0f},
              {2, {0, 0, 1}, 9, {0, 0, 1}, 1, {0, 0, 1}, -1.0f},
              {2, {-1, 0, 1}, 9, {-1, 0, 1}, 1, {0, 0, 1}, 1.0f},
              {2, {0, 0, 0}, 9, {0, 0, 0}, 1, {0, 0, 0}, 1.0f},
              {2, {-1, 0, 0}, 9, {-1, 0, 0}, 1, {0, 0, 0}, -1.0f},
          },
      },
      {  // axis 1
          8,  // active: sphi class
          {4, 0, 0, 6, 6, 3, 3},
          {{0, 0, 0}, {1, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, -1, 0}, {0, 0, 1}, {0, 0, 0}},
          {0.0f, 1.0f, 1.0f, 2.0f, 2.0f, 1.0f, 1.0f},
          {
              {1, {0, 1, 0}, 8, {0, 1, 0}, 6, {0, 0, 0}, -2.0f},
              {1, {0, -1, 0}, 8, {0, -1, 0}, 6, {0, -1, 0}, -2.0f},
              {1, {1, 0, 0}, 8, {1, 0, 0}, 0, {1, 0, 0}, -1.0f},
              {1, {-1, 0, 0}, 8, {-1, 0, 0}, 0, {0, 0, 0}, -1.0f},
              {1, {0, 0, 1}, 8, {0, 0, 1}, 3, {0, 0, 1}, -1.0f},
              {1, {0, 0, -1}, 8, {0, 0, -1}, 3, {0, 0, 0}, -1.0f},
              {0, {1, 0, 0}, 7, {1, 0, 0}, 0, {1, 0, 0}, -1.0f},
              {0, {1, -1, 0}, 7, {1, -1, 0}, 0, {1, 0, 0}, 1.0f},
              {0, {0, 0, 0}, 7, {0, 0, 0}, 0, {0, 0, 0}, 1.0f},
              {0, {0, -1, 0}, 7, {0, -1, 0}, 0, {0, 0, 0}, -1.0f},
              {2, {0, 0, 1}, 9, {0, 0, 1}, 3, {0, 0, 1}, -1.0f},
              {2, {0, -1, 1}, 9, {0, -1, 1}, 3, {0, 0, 1}, 1.0f},
              {2, {0, 0, 0}, 9, {0, 0, 0}, 3, {0, 0, 0}, 1.0f},
              {2, {0, -1, 0}, 9, {0, -1, 0}, 3, {0, 0, 0}, -1.0f},
          },
      },
      {  // axis 2
          9,  // active: sphi class
          {5, 1, 1, 3, 3, 6, 6},
          {{0, 0, 0}, {1, 0, 0}, {0, 0, 0}, {0, 1, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, -1}},
          {0.0f, 1.0f, 1.0f, 1.0f, 1.0f, 2.0f, 2.0f},
          {
              {2, {0, 0, 1}, 9, {0, 0, 1}, 6, {0, 0, 0}, -2.0f},
              {2, {0, 0, -1}, 9, {0, 0, -1}, 6, {0, 0, -1}, -2.0f},
              {2, {1, 0, 0}, 9, {1, 0, 0}, 1, {1, 0, 0}, -1.0f},
              {2, {-1, 0, 0}, 9, {-1, 0, 0}, 1, {0, 0, 0}, -1.0f},
              {2, {0, 1, 0}, 9, {0, 1, 0}, 3, {0, 1, 0}, -1.0f},
              {2, {0, -1, 0}, 9, {0, -1, 0}, 3, {0, 0, 0}, -1.0f},
              {0, {1, 0, 0}, 7, {1, 0, 0}, 1, {1, 0, 0}, -1.0f},
              {0, {1, 0, -1}, 7, {1, 0, -1}, 1, {1, 0, 0}, 1.0f},
              {0, {0, 0, 0}, 7, {0, 0, 0}, 1, {0, 0, 0}, 1.0f},
              {0, {0, 0, -1}, 7, {0, 0, -1}, 1, {0, 0, 0}, -1.0f},
              {1, {0, 1, 0}, 8, {0, 1, 0}, 3, {0, 1, 0}, -1.0f},
              {1, {0, 1, -1}, 8, {0, 1, -1}, 3, {0, 1, 0}, 1.0f},
              {1, {0, 0, 0}, 8, {0, 0, 0}, 3, {0, 0, 0}, 1.0f},
              {1, {0, 0, -1}, 8, {0, 0, -1}, 3, {0, 0, 0}, -1.0f},
          },
      },
  };
  return kAxisPlans[a];
}

__host__ __device__ constexpr bool within_one(const int* k) {
  return k[0] >= -1 && k[0] <= 1 && k[1] >= -1 && k[1] <= 1 && k[2] >= -1 &&
         k[2] <= 1;
}

// Every shift within the one-cell halo; the same-field terms lead.
__host__ __device__ constexpr bool table_fits_tiles() {
  for (int a = 0; a < 3; ++a) {
    const AxisPlan p = axis_plan(a);
    for (int j = 0; j < kDiag; ++j)
      if (!within_one(p.diag_k[j])) return false;
    for (int t = 0; t < kTerms; ++t) {
      const Term& T = p.terms[t];
      if (!within_one(T.vo) || !within_one(T.ck) || !within_one(T.vk)) return false;
      if ((T.field == a) != (t < kSameTerms)) return false;
    }
  }
  return true;
}
static_assert(table_fits_tiles(), "coupled_tile.cuh: a shift leaves the one-cell halo");

// The host's plan (from stencil_plan()) against the compiled table.
inline bool plan_matches(const Plan& p) {
  for (int a = 0; a < 3; ++a) {
    const AxisPlan c = axis_plan(a);
    const AxisPlan& h = p.ax[a];
    if (c.active_cls != h.active_cls) return false;
    for (int j = 0; j < kDiag; ++j) {
      if (c.diag_cls[j] != h.diag_cls[j] || c.diag_factor[j] != h.diag_factor[j]) return false;
      for (int i = 0; i < 3; ++i)
        if (c.diag_k[j][i] != h.diag_k[j][i]) return false;
    }
    for (int t = 0; t < kTerms; ++t) {
      const Term &x = c.terms[t], &y = h.terms[t];
      if (x.field != y.field || x.scls != y.scls || x.vcls != y.vcls || x.sf != y.sf) return false;
      for (int i = 0; i < 3; ++i)
        if (x.vo[i] != y.vo[i] || x.ck[i] != y.ck[i] || x.vk[i] != y.vk[i]) return false;
    }
  }
  return true;
}

// ---- the tiling
constexpr int kTY = 16;                  // y columns of a brick
constexpr int kTZ = 32;                  // z columns of a brick: a warp's lanes
constexpr int kThreads = kTY * kTZ;      // one (y, z) column a thread
constexpr int kArrays = kClasses + 3;    // the 10 classes, then v's 3 fields
constexpr int kRing = 4;                 // staged planes: x-1, x, x+1 read, x+2 landing

// The ring's layout: staged rows of W floats (a brick's kTZ columns, the
// halo, and any padding of the copies).
template <int W>
struct Ring {
  static_assert(W >= kTZ + 2 && W < 64, "a row holds the brick's columns and halo");
  static constexpr int kRowW = W;
  static constexpr int kPlane = (kTY + 2) * W;  // a staged plane of one array
  static constexpr int kSlot = kArrays * kPlane;  // one ring slot: every array's plane
  static constexpr int kSmemBytes = kRing * kSlot * (int)sizeof(float);
};
using ArrayRing = Ring<kTZ + 2>;  // stage_plane: 127,296 bytes
using BoxRing = Ring<kTZ + 4>;    // stage_box_plane, 9 copies of 16 bytes a row: 134,784 bytes

struct Tiling {
  int tiles_y, tiles_z;  // bricks across the union box's y and z
  int chunk;             // x planes a brick walks
};

// A staged array: element (0, 0, 0), extents, and the value read outside.
struct Src {
  const float* p;
  int d[3];
  float fill;
};

// Array j: classes 0-9 of the flat geometry, then v's field j - 10.
__device__ __forceinline__ Src source(const Plan& p, const float* geom,
                                      const float* const* v, int j) {
  Src s;
  if (j < kClasses) {
    s.p = geom + p.cls_off[j];
    for (int i = 0; i < 3; ++i) s.d[i] = p.cls_dim[j][i];
    s.fill = p.cls_is_sphi[j] ? -1.f : 0.f;
  } else {
    const int f = j - kClasses;
    s.p = v[f];
    for (int i = 0; i < 3; ++i) s.d[i] = p.n[i] + (f == i);
    s.fill = 0.f;
  }
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16_cg(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Plane x of every array's window at (y0 - 1 .. y0 + kTY, z0 - 1 .. z0 +
// kTZ) into `slot`: a warp stages half the rows of one array at a time
// (its extents and first row set up once for them), its lanes on
// consecutive elements of those rows taken as one run (the rows are
// consecutive in `slot`), each lane stepping 32 along it with no
// division; in-range elements by cp.async, the others written with the
// array's fill.  (Lanes on the run rather than a row each: 10 cp.async
// for a half of 9 rows of 34, where a row each took 18, half of them 2
// lanes wide.)
__device__ __forceinline__ void stage_plane(const Src* src, float* slot, int x,
                                            int y0, int z0) {
  using R = ArrayRing;
  constexpr int kRowW = R::kRowW;
  static_assert(kRowW > 32, "stage_plane steps a lane at most one row at a time");
  constexpr int kRows = kTY + 2, kHalf = (kRows + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int u = warp; u < 2 * kArrays; u += kThreads / 32) {
    const Src s = src[u >> 1];
    const int r0 = (u & 1) * kHalf, rows = min(kHalf, kRows - r0);
    const bool in_x = x >= 0 && x < s.d[0];
    float* dst = slot + (u >> 1) * R::kPlane + r0 * kRowW;
    const int gy0 = y0 - 1 + r0;
    const float* row = s.p + ((long)x * s.d[1] + gy0) * s.d[2];
    int gy = gy0, zz = lane;  // element e's row and column (e = lane + 32 i)
    bool in_y = in_x && gy >= 0 && gy < s.d[1];
    for (int e = lane; e < rows * kRowW; e += 32) {
      const int gz = z0 - 1 + zz;
      if (in_y && gz >= 0 && gz < s.d[2])
        cp_async4(dst + e, row + gz);
      else
        dst[e] = s.fill;
      zz += 32;  // kRowW > 32: at most one row ahead
      if (zz >= kRowW) {
        zz -= kRowW;
        ++gy;
        row += s.d[2];
        in_y = in_x && gy >= 0 && gy < s.d[1];
      }
    }
  }
}

// The coupled PCG's padded box (csrc/coupled_visc_pcg.cu): every array in
// one layout, the union face box with a one-cell border, X planes of Y
// rows of Z floats (Z a multiple of 4); element (gx, gy, gz) of an array
// at ((gx + 1) * Y + gy + 1) * Z + gz + 1 of its box (ops/cuda_cg.py::
// pcg_box_offset).
struct Box {
  int X, Y, Z;
  long size;  // X * Y * Z floats a box
};

// Plane x of the kArrays staged arrays of brick (y0, z0) from their boxes
// (`box_of(j)`: array j's box) into `slot`: each window row is 9 copies of 16
// bytes, box z0 .. z0 + 35 (the brick's columns and halo are z0 .. z0 +
// 33); consecutive threads take consecutive copies, which are consecutive
// in `slot`.  Rows and copies past the box's edge are skipped: they feed
// only faces outside the union face box, which are not kept.
template <class BoxOf>
__device__ __forceinline__ void stage_box_plane(BoxOf box_of, const Box& bx, float* slot, int x,
                                                int y0, int z0) {
  using R = BoxRing;
  constexpr int kQuads = R::kRowW / 4, kRows = kTY + 2, kPerArray = kRows * kQuads;
  static_assert(R::kRowW % 4 == 0 && kPerArray * 4 == R::kPlane, "16-byte copies fill the window rows");
  const int rows = min(kRows, bx.Y - y0), quads = min(kQuads, (bx.Z - z0) / 4);
  const long plane = (long)(x + 1) * bx.Y + y0;
  for (int t = threadIdx.x; t < kArrays * kPerArray; t += kThreads) {
    const int j = t / kPerArray, e = t - j * kPerArray;
    const int i = e / kQuads, k = e - i * kQuads;
    if (i < rows && k < quads) cp_async16_cg(slot + 4 * t, box_of(j) + (plane + i) * bx.Z + z0 + 4 * k);
  }
}

// Array J at this thread's (x + DX, y + DY, z + DZ); pl[i] is this
// thread's (y, z) in the staged planes x - 1, x, x + 1.
template <class R, int J, int DX, int DY, int DZ>
__device__ __forceinline__ float at(const float* const* pl) {
  return pl[DX + 1][J * R::kPlane + DY * R::kRowW + DZ];
}

template <class R, int F, int J>
__device__ __forceinline__ float diag_vol(const float* const* pl) {
  constexpr int c = axis_plan(F).diag_cls[J];
  constexpr int kx = axis_plan(F).diag_k[J][0];
  constexpr int ky = axis_plan(F).diag_k[J][1];
  constexpr int kz = axis_plan(F).diag_k[J][2];
  return at<R, c, kx, ky, kz>(pl);
}

template <class R, int F, int J>
__device__ __forceinline__ float add_diag(float extra, const float* const* pl) {
  constexpr float factor = axis_plan(F).diag_factor[J];
  return __fadd_rn(extra, __fmul_rn(factor, diag_vol<R, F, J>(pl)));
}

template <class R, int F, int... J>
__device__ __forceinline__ float diag_extra(const float* const* pl,
                                            std::integer_sequence<int, J...>) {
  float extra = 0.f;
  ((extra = add_diag<R, F, J + 1>(extra, pl)), ...);  // neighbours 1..6, in order
  return extra;
}

template <class R, int F, int T>
__device__ __forceinline__ float add_term(float acc, bool active, float smu,
                                          const float* const* pl) {
  constexpr Term t = axis_plan(F).terms[T];
  constexpr int field = t.field;
  constexpr int scls = t.scls, vcls = t.vcls;
  constexpr int vo0 = t.vo[0], vo1 = t.vo[1], vo2 = t.vo[2];
  constexpr int ck0 = t.ck[0], ck1 = t.ck[1], ck2 = t.ck[2];
  constexpr int vk0 = t.vk[0], vk1 = t.vk[1], vk2 = t.vk[2];
  constexpr float sf = t.sf;
  const float w = __fmul_rn(sf, smu);
  const bool fluid = at<R, scls, ck0, ck1, ck2>(pl) >= 0.f;
  const float coef = (active && fluid) ? __fmul_rn(w, at<R, vcls, vk0, vk1, vk2>(pl)) : 0.f;
  return __fadd_rn(acc, __fmul_rn(coef, at<R, kClasses + field, vo0, vo1, vo2>(pl)));
}

template <class R, int F, int... T>
__device__ __forceinline__ float add_terms(float acc, bool active, float smu,
                                           const float* const* pl,
                                           std::integer_sequence<int, T...>) {
  ((acc = add_term<R, F, T>(acc, active, smu, pl)), ...);  // terms in table order
  return acc;
}

// (A v) at face (cx, cy, cz) of field F, whose array is s0 x s1 x s2.
template <class R, int F, int kNTerms>
__device__ __forceinline__ float face(const float* const* pl, int cx, int cy,
                                      int cz, int s0, int s1, int s2,
                                      float smu) {
  const bool interior = cx >= 1 && cx <= s0 - 2 && cy >= 1 && cy <= s1 - 2 &&
                        cz >= 1 && cz <= s2 - 2;
  constexpr int act = axis_plan(F).active_cls;
  const bool active = interior && at<R, act, 0, 0, 0>(pl) >= 0.f;
  const float center = diag_vol<R, F, 0>(pl);
  const float extra = diag_extra<R, F>(pl, std::make_integer_sequence<int, kDiag - 1>{});
  const float diag_raw = __fadd_rn(center, __fmul_rn(smu, extra));
  const float acc = __fmul_rn(active ? diag_raw : 0.f, at<R, kClasses + F, 0, 0, 0>(pl));
  return add_terms<R, F>(acc, active, smu, pl, std::make_integer_sequence<int, kNTerms>{});
}

// Whether face (x, cy, cz) of the union box lies in field F's array.
template <int F>
__device__ __forceinline__ bool in_field(const Plan& p, int x, int cy, int cz) {
  return x < p.n[0] + (F == 0) && cy < p.n[1] + (F == 1) && cz < p.n[2] + (F == 2);
}

template <int F>
__device__ __forceinline__ void store_face(const Plan& p, float* q, int x,
                                           int cy, int cz, float value) {
  const int s1 = p.n[1] + (F == 1), s2 = p.n[2] + (F == 2);
  if (in_field<F>(p, x, cy, cz)) q[((long)x * s1 + cy) * s2 + cz] = value;
}

// (A v) at every face of brick b (bricks numbered z fastest, then y, then
// the x chunk), all three fields.  Every thread of the block calls it;
// `ring` is kRing * R::kSlot floats of shared memory, free again when it
// returns.  `stage(slot, x, y0, z0)` stages plane x of the brick's
// windows; `out(pl, x, cy, cz, f0, f1, f2)` takes this thread's three
// faces at plane x (pl[i]: its (y, z) in the staged planes x - 1, x, x +
// 1), which may lie outside their fields' arrays.
template <class R, int kNTerms, class Stage, class Out>
__device__ __forceinline__ void matvec_brick(const Plan& p, const Tiling& t, float smu, long b,
                                             float* ring, Stage stage, Out out) {
  const long tiles = (long)t.tiles_y * t.tiles_z;
  const int z0 = (int)(b % t.tiles_z) * kTZ;
  const int y0 = (int)((b / t.tiles_z) % t.tiles_y) * kTY;
  const int x0 = (int)(b / tiles) * t.chunk;
  const int x1 = min(x0 + t.chunk, p.n[0] + 1);
  const int cy = y0 + (int)threadIdx.x / kTZ, cz = z0 + (int)threadIdx.x % kTZ;
  const int mine = ((int)threadIdx.x / kTZ + 1) * R::kRowW + (int)threadIdx.x % kTZ + 1;
  const auto slot = [&](int x) { return ring + (x + kRing) % kRing * R::kSlot; };
  for (int x = x0 - 1; x <= x0 + 1; ++x) stage(slot(x), x, y0, z0);
  cp_async_commit();
  for (int x = x0; x < x1; ++x) {
    cp_async_wait_all();  // plane x + 1 has landed (this thread's copies)
    __syncthreads();      // ... everyone's; and plane x - 2's slot is free
    if (x + 2 <= x1) stage(slot(x + 2), x + 2, y0, z0);
    cp_async_commit();
    const float* pl[3] = {slot(x - 1) + mine, slot(x) + mine, slot(x + 1) + mine};
    // the three faces, then their stores: no global store between the
    // shared-memory reads, which the faces then share
    const float f0 = face<R, 0, kNTerms>(pl, x, cy, cz, p.n[0] + 1, p.n[1], p.n[2], smu);
    const float f1 = face<R, 1, kNTerms>(pl, x, cy, cz, p.n[0], p.n[1] + 1, p.n[2], smu);
    const float f2 = face<R, 2, kNTerms>(pl, x, cy, cz, p.n[0], p.n[1], p.n[2] + 1, smu);
    out(pl, x, cy, cz, f0, f1, f2);
  }
  cp_async_wait_all();
  __syncthreads();
}

}  // namespace tile
}  // namespace coupled
}  // namespace pfs
