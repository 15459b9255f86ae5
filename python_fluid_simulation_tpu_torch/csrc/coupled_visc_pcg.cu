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
//   B: r -= alpha q; partial r.(r/pd) and r.r
//   C: x += alpha d; d = r/pd + beta d
// so no scalar crosses to the host.
//
// What bounds it: device-memory bytes.  From 128^3 up neither the 10
// geometry classes (G entries) nor the six CG vectors (N faces each) stay
// in the 50 MB L2 through an iteration, so an iteration streams the
// geometry once and makes 12 vector passes -- A reads d and writes q, B
// reads r, q, pd and writes r, C reads x, d, r, pd and writes x and d:
// (G + 12 N) * 4 bytes, 0.335 ms at 154x256x154 cells (18.3M faces) and
// 0.442 ms at 126x504x126 (24.1M) at 3.35 TB/s.  At the flagship (0.56M
// faces) everything stays in L2, and the three grid barriers of an
// iteration and the latency of each phase bound it.
//
// The design:
// - The padded box (coupled_tile.cuh::Box; ops/cuda_cg.py::pcg_boxes).
//   The init copies the 10 geometry classes, x0 and pd from the caller's
//   arrays into the kernel's workspace of 25 boxes (the classes, then x,
//   pd, r, d, q, three fields each): the union face box with a one-cell
//   border that holds each array's fill (0 for vol, for v and the CG
//   vectors, -1 for sphi, 1 for pd so that r / pd stays 0 there), z rows
//   padded to 16 bytes.  So phase A stages with 16-byte copies and no
//   bounds test, B and C are one flat float4 stream over the three fields
//   (the pads add 0 to every dot), and the caller's arrays are read and
//   written apart: the wrapper concatenates nothing.  At the end x and r
//   are copied out to the caller's shapes.
// - Phase A and the init's A x0: coupled_tile.cuh::matvec_brick, one
//   512-thread block a SM (a 134,784-byte ring), each block walking the
//   bricks of ops/cuda_cg.py::matvec_tiling in the fixed order blockIdx.x,
//   blockIdx.x + gridDim.x, ...  d.q is summed from the staged d and the
//   computed q, over the faces that each field's array has.
// - Coherence.  Other blocks write d between grid barriers, and L1 is not
//   coherent with their writes, so d is staged through L2: cp.async.cg,
//   which copies only 16 bytes, hence the aligned rows of the box.  The
//   geometry takes the same path (this kernel wrote its boxes too, and a
//   brick stages each window once, so L1 would save nothing).  B and C
//   read through L2 (__ldcg) as well.
// - B and C: float4 loads and stores, kUnroll float4s of each stream in
//   flight a thread, every load before the first store.  x += alpha d
//   moved from B to C (13 -> 12 passes), which reads d anyway.  C runs in
//   every iteration the loop starts, before the exit test, so x gets each
//   update it got when B made it.
//
// The dots are fixed-order per-block partials summed in one order by every
// block (pcg_common.cuh), with no atomics, so a solve repeats bitwise.
// Each face of A rounds every operation on its own, as coupled_tile.cuh
// says, so A d is bitwise ops/cuda_cg.py::coupled_matvec_plain.  (With
// contraction allowed, the products that cancel in a face's sum left
// last-bit differences of up to 1.9e-5 at 24M faces, on an H100.)

#include <cstdint>
#include <cstring>

#include "coupled_tile.cuh"
#include "pcg_common.cuh"

namespace {

namespace cg = cooperative_groups;
namespace tile = pfs::coupled::tile;
using pfs::coupled::kClasses;
using pfs::coupled::kTerms;
using pfs::coupled::Plan;
using R = tile::BoxRing;
constexpr int kBlock = tile::kThreads;  // 512: one brick's (y, z) columns
constexpr int kUnroll = 2;              // float4s of each stream in flight a thread

// The workspace's boxes, in order: the classes, then three fields each
// of x, pd, r, d and q (ops/cuda_cg.py::pcg_boxes).
constexpr int kXBox = kClasses;
constexpr int kPdBox = kXBox + 3;
constexpr int kRBox = kPdBox + 3;
constexpr int kDBox = kRBox + 3;
constexpr int kQBox = kDBox + 3;
constexpr int kBoxes = kQBox + 3;

struct CoupledArgs {
  Plan plan;
  tile::Tiling tiling;
  tile::Box box;
  const float* geom[kClasses];  // each class contiguous, in Plan's class order
  const float* b[3];            // the caller's face arrays
  const float* x0[3];
  const float* pd[3];
  const float* s_mu;  // device scalar
  float* x[3];        // outputs, in the caller's shapes
  float* r[3];
  float* work;  // kBoxes boxes
  float* part;  // 3 * gridDim.x floats: [dq | (delta, res) pairs]
  int* iters_out;
  float* res_out;
  float* res0_out;
  float* thresh_out;
  float tol2, rel2;
  int max_iter;
};

__device__ __forceinline__ float* box(const CoupledArgs& a, int j) { return a.work + j * a.box.size; }

// Box j's source array (null: none, the fill everywhere), its extents
// and its fill.
__device__ __forceinline__ const float* box_source(const CoupledArgs& a, int j, int* s, float* fill) {
  if (j < kClasses) {
    for (int i = 0; i < 3; ++i) s[i] = a.plan.cls_dim[j][i];
    *fill = a.plan.cls_is_sphi[j] ? -1.f : 0.f;
    return a.geom[j];
  }
  const int f = (j - kClasses) % 3;
  for (int i = 0; i < 3; ++i) s[i] = a.plan.n[i] + (f == i);
  *fill = j >= kPdBox && j < kRBox ? 1.f : 0.f;
  return j < kPdBox ? a.x0[f] : (j < kRBox ? a.pd[f] : nullptr);
}

// Every element of every box: its array's value inside the array, the
// fill outside.  A warp a box row.
__device__ void fill_boxes(const CoupledArgs& a) {
  const tile::Box& bx = a.box;
  const long rows = (long)bx.X * bx.Y;
  const int lane = threadIdx.x & 31;
  const long warps = (long)gridDim.x * (kBlock / 32);
  for (long t = ((long)blockIdx.x * kBlock + threadIdx.x) / 32; t < kBoxes * rows; t += warps) {
    const int j = (int)(t / rows);
    const long row = t - j * rows;
    const int gx = (int)(row / bx.Y) - 1, gy = (int)(row % bx.Y) - 1;
    int s[3];
    float fill;
    const float* src = box_source(a, j, s, &fill);
    const bool in = src != nullptr && gx >= 0 && gx < s[0] && gy >= 0 && gy < s[1];
    const float* line = in ? src + ((long)gx * s[1] + gy) * s[2] - 1 : nullptr;
    float* dst = box(a, j) + row * bx.Z;
    for (int z = lane; z < bx.Z; z += 32) dst[z] = in && z >= 1 && z <= s[2] ? line[z] : fill;
  }
}

// Face (x, cy, cz) of field F, at element e of its boxes, when the
// field's array has it: the init (r = b - A x0, d = r / pd; partials r.d
// and r.r) or phase A (q = A d; partial d.q, d the staged centre).
template <int F, bool kInit>
__device__ __forceinline__ void face_out(const CoupledArgs& a, const float* const* pl, long e, int x,
                                         int cy, int cz, float av, float* dot0, float* dot1) {
  if (!tile::in_field<F>(a.plan, x, cy, cz)) return;
  if (kInit) {
    const int s1 = a.plan.n[1] + (F == 1), s2 = a.plan.n[2] + (F == 2);
    const float rv = a.b[F][((long)x * s1 + cy) * s2 + cz] - av;
    const float zv = rv / __ldcg(box(a, kPdBox + F) + e);
    box(a, kRBox + F)[e] = rv;
    box(a, kDBox + F)[e] = zv;
    *dot0 += rv * zv;
    *dot1 += rv * rv;
  } else {
    box(a, kQBox + F)[e] = av;
    *dot0 += tile::at<R, kClasses + F, 0, 0, 0>(pl) * av;
  }
}

// The init's A x0 (kInit) or phase A's A d over this block's bricks.
template <bool kInit>
__device__ __forceinline__ void brick_phase(const CoupledArgs& a, float* ring, float smu, float* dot0,
                                            float* dot1) {
  const tile::Box& bx = a.box;
  const float* v = box(a, kInit ? kXBox : kDBox);
  const auto box_of = [&](int j) -> const float* {
    return j < kClasses ? a.work + j * bx.size : v + (j - kClasses) * bx.size;
  };
  const long bricks = (long)a.tiling.tiles_y * a.tiling.tiles_z *
                      ((a.plan.n[0] + a.tiling.chunk) / a.tiling.chunk);
  for (long b = blockIdx.x; b < bricks; b += gridDim.x)
    tile::matvec_brick<R, kTerms>(
        a.plan, a.tiling, smu, b, ring,
        [&](float* slot, int x, int y0, int z0) { tile::stage_box_plane(box_of, bx, slot, x, y0, z0); },
        [&](const float* const* pl, int x, int cy, int cz, float f0, float f1, float f2) {
          const long e = ((long)(x + 1) * bx.Y + cy + 1) * bx.Z + cz + 1;
          face_out<0, kInit>(a, pl, e, x, cy, cz, f0, dot0, dot1);
          face_out<1, kInit>(a, pl, e, x, cy, cz, f1, dot0, dot1);
          face_out<2, kInit>(a, pl, e, x, cy, cz, f2, dot0, dot1);
        });
}

__device__ __forceinline__ float& lane4(float4& v, int c) { return reinterpret_cast<float*>(&v)[c]; }

// B: r -= alpha q; partials r.(r/pd) and r.r.  One float4 stream over
// the three fields' boxes.
__device__ __forceinline__ void update_r(const CoupledArgs& a, float alpha, float* ld, float* lr) {
  const long n4 = 3 * a.box.size / 4;
  float4* r = reinterpret_cast<float4*>(box(a, kRBox));
  const float4* q = reinterpret_cast<const float4*>(box(a, kQBox));
  const float4* pd = reinterpret_cast<const float4*>(box(a, kPdBox));
  const long stride = (long)gridDim.x * kBlock;
  for (long i0 = (long)blockIdx.x * kBlock + threadIdx.x; i0 < n4; i0 += kUnroll * stride) {
    float4 rv[kUnroll], qv[kUnroll], pv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long i = i0 + u * stride;
      if (i < n4) {
        rv[u] = __ldcg(r + i);
        qv[u] = __ldcg(q + i);
        pv[u] = __ldcg(pd + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long i = i0 + u * stride;
      if (i < n4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float rc = lane4(rv[u], c) - alpha * lane4(qv[u], c);
          lane4(rv[u], c) = rc;
          *ld += rc * (rc / lane4(pv[u], c));
          *lr += rc * rc;
        }
        r[i] = rv[u];
      }
    }
  }
}

// C: x += alpha d; d = r / pd + beta d, with this iteration's d in both.
__device__ __forceinline__ void update_xd(const CoupledArgs& a, float alpha, float beta) {
  const long n4 = 3 * a.box.size / 4;
  float4* x = reinterpret_cast<float4*>(box(a, kXBox));
  float4* d = reinterpret_cast<float4*>(box(a, kDBox));
  const float4* r = reinterpret_cast<const float4*>(box(a, kRBox));
  const float4* pd = reinterpret_cast<const float4*>(box(a, kPdBox));
  const long stride = (long)gridDim.x * kBlock;
  for (long i0 = (long)blockIdx.x * kBlock + threadIdx.x; i0 < n4; i0 += kUnroll * stride) {
    float4 xv[kUnroll], dv[kUnroll], rv[kUnroll], pv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long i = i0 + u * stride;
      if (i < n4) {
        xv[u] = __ldcg(x + i);
        dv[u] = __ldcg(d + i);
        rv[u] = __ldcg(r + i);
        pv[u] = __ldcg(pd + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long i = i0 + u * stride;
      if (i < n4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float dc = lane4(dv[u], c);
          lane4(xv[u], c) = lane4(xv[u], c) + alpha * dc;
          lane4(dv[u], c) = lane4(rv[u], c) / lane4(pv[u], c) + beta * dc;
        }
        x[i] = xv[u];
        d[i] = dv[u];
      }
    }
  }
}

// x and r from their boxes to the caller's arrays.  A warp a row.
__device__ void write_out(const CoupledArgs& a) {
  const tile::Box& bx = a.box;
  const int lane = threadIdx.x & 31;
  const long warps = (long)gridDim.x * (kBlock / 32);
  const long warp = ((long)blockIdx.x * kBlock + threadIdx.x) / 32;
  for (int f = 0; f < 3; ++f) {
    const int s1 = a.plan.n[1] + (f == 1), s2 = a.plan.n[2] + (f == 2);
    const long rows = (long)(a.plan.n[0] + (f == 0)) * s1;
    const float* xb = box(a, kXBox + f);
    const float* rb = box(a, kRBox + f);
    for (long t = warp; t < rows; t += warps) {
      const long gx = t / s1, gy = t - gx * s1;
      const long from = ((gx + 1) * bx.Y + gy + 1) * bx.Z + 1, to = t * s2;
      for (int z = lane; z < s2; z += 32) {
        a.x[f][to + z] = __ldcg(xb + from + z);
        a.r[f][to + z] = __ldcg(rb + from + z);
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock, 1)
    coupled_visc_pcg_kernel(const __grid_constant__ CoupledArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 ring4[];  // tile::kRing * R::kSlot floats, 16-byte aligned
  float* ring = reinterpret_cast<float*>(ring4);
  __shared__ float sh[kBlock / 32 + 1];
  const int nb = gridDim.x;
  float* part_dq = a.part;
  float* part_dr = a.part + nb;
  const float smu = *a.s_mu;

  fill_boxes(a);
  grid.sync();

  // init: r = b - A x0, d = r / pd (x = x0: the x box holds it)
  float ld = 0.f, lr = 0.f;
  brick_phase<true>(a, ring, smu, &ld, &lr);
  ld = pfs::block_sum<kBlock>(ld, sh);
  lr = pfs::block_sum<kBlock>(lr, sh);
  if (threadIdx.x == 0) {
    part_dr[2 * blockIdx.x] = ld;
    part_dr[2 * blockIdx.x + 1] = lr;
  }
  grid.sync();
  float delta = pfs::grid_total<kBlock>(part_dr, nb, 2, 0, sh);
  const float res0 = pfs::grid_total<kBlock>(part_dr, nb, 2, 1, sh);
  const float thresh = fmaxf(a.tol2, a.rel2 * res0);
  float res = res0;
  int k = 0;

  while (res >= thresh && k < a.max_iter && delta != 0.f) {
    // A: q = A d, partial d.q
    float ldq = 0.f, unused = 0.f;
    brick_phase<false>(a, ring, smu, &ldq, &unused);
    ldq = pfs::block_sum<kBlock>(ldq, sh);
    if (threadIdx.x == 0) part_dq[blockIdx.x] = ldq;
    grid.sync();
    const float dq = pfs::grid_total<kBlock>(part_dq, nb, 1, 0, sh);
    const float alpha = dq != 0.f ? delta / dq : 0.f;

    // B: r -= alpha q, partial r.z and r.r
    ld = 0.f;
    lr = 0.f;
    update_r(a, alpha, &ld, &lr);
    ld = pfs::block_sum<kBlock>(ld, sh);
    lr = pfs::block_sum<kBlock>(lr, sh);
    if (threadIdx.x == 0) {
      part_dr[2 * blockIdx.x] = ld;
      part_dr[2 * blockIdx.x + 1] = lr;
    }
    grid.sync();
    const float new_delta = pfs::grid_total<kBlock>(part_dr, nb, 2, 0, sh);
    const float new_res = pfs::grid_total<kBlock>(part_dr, nb, 2, 1, sh);
    const float beta = delta != 0.f ? new_delta / delta : 0.f;

    // C: x += alpha d, d = r / pd + beta d
    update_xd(a, alpha, beta);
    delta = new_delta;
    res = new_res;
    ++k;
    grid.sync();
  }
  write_out(a);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.iters_out = k;
    *a.res_out = res;
    *a.res0_out = res0;
    *a.thresh_out = thresh;
  }
}

}  // namespace

// `plan` is a host buffer of `plan_bytes` bytes laid out as `Plan`; its term
// table must be the compiled one.  The bricks as for pfs_coupled_matvec
// (ops/cuda_cg.py::matvec_tiling); box_x/y/z the padded box
// (ops/cuda_cg.py::pcg_box), which `work` (16-byte aligned, `work_cap`
// floats) holds kBoxes of.  Host arrays of device pointers: `geom` the 10
// classes in Plan's order, `fields` b, x0 and pd (three fields each), `outs`
// x and r (three fields each); every array contiguous.
extern "C" int pfs_coupled_visc_pcg(
    const void* plan, int plan_bytes, int tiles_y, int tiles_z, int chunk, int box_x, int box_y,
    int box_z, const void* const* geom, const void* const* fields, const void* s_mu,
    void* const* outs, void* work, long long work_cap, void* part, int part_cap, void* iters,
    void* res, void* res0, void* thresh, float tol2, float rel2, int max_iter, void* stream) {
  if (plan_bytes != (int)sizeof(Plan)) return (int)cudaErrorInvalidValue;
  CoupledArgs a;
  memcpy(&a.plan, plan, sizeof(Plan));
  if (!tile::plan_matches(a.plan)) return (int)cudaErrorInvalidValue;
  const int* n = a.plan.n;
  if (chunk < 1 || (long)tiles_y * tile::kTY < n[1] + 1 || (long)tiles_z * tile::kTZ < n[2] + 1)
    return (int)cudaErrorInvalidValue;
  if (box_x != n[0] + 3 || box_y != n[1] + 3 || box_z != (n[2] + 3 + 3) / 4 * 4)
    return (int)cudaErrorInvalidValue;
  a.tiling = {tiles_y, tiles_z, chunk};
  a.box = {box_x, box_y, box_z, (long)box_x * box_y * box_z};
  if (work_cap < kBoxes * a.box.size || reinterpret_cast<uintptr_t>(work) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < kClasses; ++j) a.geom[j] = static_cast<const float*>(geom[j]);
  for (int f = 0; f < 3; ++f) {
    a.b[f] = static_cast<const float*>(fields[f]);
    a.x0[f] = static_cast<const float*>(fields[3 + f]);
    a.pd[f] = static_cast<const float*>(fields[6 + f]);
    a.x[f] = static_cast<float*>(outs[f]);
    a.r[f] = static_cast<float*>(outs[3 + f]);
  }
  a.s_mu = static_cast<const float*>(s_mu);
  a.work = static_cast<float*>(work);
  a.part = static_cast<float*>(part);
  a.iters_out = static_cast<int*>(iters);
  a.res_out = static_cast<float*>(res);
  a.res0_out = static_cast<float*>(res0);
  a.thresh_out = static_cast<float*>(thresh);
  a.tol2 = tol2;
  a.rel2 = rel2;
  a.max_iter = max_iter;
  int grid = 0;
  cudaError_t e = pfs::coop_grid(coupled_visc_pcg_kernel, 3 * a.box.size / 4, &grid, kBlock, R::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  if (3 * grid > part_cap) return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)coupled_visc_pcg_kernel, grid, kBlock, args,
                                  R::kSmemBytes, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
