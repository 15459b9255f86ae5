// One application of the coupled viscosity operator, q = A v, with the
// coefficients rebuilt from the parity-class geometry (no materialised
// coefficient fields), on the three face arrays.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_cg.py::
// make_blocked_coupled_matvec_geom (the fused CG's pass A behind a pad ->
// kernel -> slice round trip, streaming x-slabs of 10 geometry and 3
// velocity fields through VMEM).  It is the outer CG operator of the
// viscosity MG-PCG route and the 'unet_warm' line search
// (solvers/viscosity.py); with same_axis it is the block-diagonal
// sub-operator (the diagonal and the 6 same-field couplings per axis) of
// the lean route, the TPU function's second form.
//
// What bounds it: bytes.  The 10 geometry classes and v read once and q
// written once: 68 MB at 64x256x64 cells (0.020 ms at 3.35 TB/s), 516 MB
// at 126x504x126 (0.154 ms); ~100 fp32 operations a face are ~20x below
// that.  The first version (one thread a face on the flat concatenated
// index, the plan read through a runtime axis, every one of a face's ~50
// geometry and velocity loads behind its own bounds test, a face's
// x-neighbours a whole plane away) ran at 14x that bound (0.289 ms and
// 2.164 ms, PERF.md).  This one is coupled_tile.cuh's tiled operator: a
// block stages a brick's 13 arrays with their halo into shared memory once
// for all three fields, plane by plane through cp.async, and computes
// from there with the term table compiled in; each array is read ~1.4
// times (the halo of its kTY x kTZ windows, and the chunk's two extra
// planes) instead of ~50 loads a face through L1 and L2.
//
// Every product and sum is rounded on its own, in viscosity_term_fields'
// order, so the result is bitwise ops/cuda_cg.py::coupled_matvec_plain's.

#include <cstring>

#include "coupled_tile.cuh"

namespace {

namespace tile = pfs::coupled::tile;
using pfs::coupled::Plan;

struct MatvecArgs {
  Plan plan;
  tile::Tiling tiling;
  const float* geom;  // the 10 classes, concatenated
  const float* v[3];  // the 3 face fields
  const float* s_mu;  // device scalar
  float* q[3];
};

// One brick a block, one block (127.3 KB of shared memory) a SM.
template <int kNTerms>
__global__ void __launch_bounds__(tile::kThreads, 1)
    coupled_matvec_kernel(const __grid_constant__ MatvecArgs a) {
  using R = tile::ArrayRing;
  extern __shared__ float ring[];  // tile::kRing * R::kSlot
  __shared__ tile::Src src[tile::kArrays];
  if (threadIdx.x < tile::kArrays)
    src[threadIdx.x] = tile::source(a.plan, a.geom, a.v, threadIdx.x);
  const float smu = *a.s_mu;
  __syncthreads();
  tile::matvec_brick<R, kNTerms>(
      a.plan, a.tiling, smu, blockIdx.x, ring,
      [&](float* slot, int x, int y0, int z0) { tile::stage_plane(src, slot, x, y0, z0); },
      [&](const float* const*, int x, int cy, int cz, float f0, float f1, float f2) {
        tile::store_face<0>(a.plan, a.q[0], x, cy, cz, f0);
        tile::store_face<1>(a.plan, a.q[1], x, cy, cz, f1);
        tile::store_face<2>(a.plan, a.q[2], x, cy, cz, f2);
      });
}

template <int kNTerms>
cudaError_t launch(const MatvecArgs& a, long blocks, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(coupled_matvec_kernel<kNTerms>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       tile::ArrayRing::kSmemBytes);
  if (e != cudaSuccess) return e;
  coupled_matvec_kernel<kNTerms><<<(unsigned)blocks, tile::kThreads, tile::ArrayRing::kSmemBytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// `plan` is a host buffer of `plan_bytes` bytes laid out as `Plan`; its term
// table must be the compiled one.  The bricks: tiles_y x tiles_z columns of
// kTY x kTZ faces covering the union face box's y and z, each walking
// `chunk` x planes (ops/cuda_cg.py::matvec_tiling).  v0-v2 and q0-q2: the
// three face fields, each contiguous.
extern "C" int pfs_coupled_matvec(const void* plan, int plan_bytes,
                                  int tiles_y, int tiles_z, int chunk,
                                  const void* geom, const void* v0,
                                  const void* v1, const void* v2,
                                  const void* s_mu, void* q0, void* q1,
                                  void* q2, int same_axis, void* stream) {
  if (plan_bytes != (int)sizeof(Plan)) return (int)cudaErrorInvalidValue;
  MatvecArgs a;
  memcpy(&a.plan, plan, sizeof(Plan));
  if (!tile::plan_matches(a.plan)) return (int)cudaErrorInvalidValue;
  const int u[3] = {a.plan.n[0] + 1, a.plan.n[1] + 1, a.plan.n[2] + 1};
  if (chunk < 1 || (long)tiles_y * tile::kTY < u[1] || (long)tiles_z * tile::kTZ < u[2])
    return (int)cudaErrorInvalidValue;
  if (a.plan.off[3] <= 0) return 0;
  a.tiling = {tiles_y, tiles_z, chunk};
  a.geom = static_cast<const float*>(geom);
  a.v[0] = static_cast<const float*>(v0);
  a.v[1] = static_cast<const float*>(v1);
  a.v[2] = static_cast<const float*>(v2);
  a.s_mu = static_cast<const float*>(s_mu);
  a.q[0] = static_cast<float*>(q0);
  a.q[1] = static_cast<float*>(q1);
  a.q[2] = static_cast<float*>(q2);
  const long blocks = (long)tiles_y * tiles_z * ((u[0] + chunk - 1) / chunk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(same_axis ? launch<pfs::coupled::kSameTerms>(a, blocks, st)
                         : launch<pfs::coupled::kTerms>(a, blocks, st));
}
