// One application of the coupled viscosity operator, q = A v, with the
// coefficients rebuilt from the parity-class geometry (no materialised
// coefficient fields), on the three face arrays concatenated.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_cg.py::
// make_blocked_coupled_matvec_geom (the fused CG's pass A behind a pad ->
// kernel -> slice round trip, streaming x-slabs of 10 geometry and 3
// velocity fields through VMEM).  Here it is the same per-face apply as
// phase A of coupled_visc_pcg.cu (coupled_geom.cuh), one thread per face,
// an ordinary launch.  It is the outer CG operator of the viscosity MG-PCG
// route (solvers/viscosity.py); with same_axis it is the block-diagonal
// sub-operator (the diagonal and the 6 same-field couplings per axis), the
// TPU function's second form.
//
// Every product and sum is rounded on its own, in viscosity_term_fields'
// order, so the result is bitwise ops/cuda_cg.py::coupled_matvec_plain's.
//
// What bounds it: the recomputed stencil's ~50 geometry and velocity loads
// a face (L1/L2 hits: neighbouring threads read neighbouring z) and its
// ~100 fp32 operations; the device-memory bytes (10 geometry classes and v
// read once, q written once: ~68 MB at 64x256x64) take ~20 us at 3.35 TB/s.

#include <cstring>

#include "coupled_geom.cuh"
#include "pcg_common.cuh"

namespace {

using pfs::coupled::Plan;

struct MatvecArgs {
  Plan plan;
  const float* geom;  // the 10 classes, concatenated
  const float* v;     // 3 face fields, concatenated
  const float* s_mu;  // device scalar
  float* q;
};

template <int kNTerms>
__global__ void __launch_bounds__(pfs::kThreads)
    coupled_matvec_kernel(const __grid_constant__ MatvecArgs a) {
  const long n = a.plan.off[3];
  const long stride = (long)gridDim.x * pfs::kThreads;
  const float smu = *a.s_mu;
  for (long i = (long)blockIdx.x * pfs::kThreads + threadIdx.x; i < n;
       i += stride) {
    int f, cx, cy, cz;
    pfs::coupled::decode(a.plan, i, &f, &cx, &cy, &cz);
    a.q[i] = pfs::coupled::apply_a<false, kNTerms>(a.plan, a.geom, a.v, f,
                                                   cx, cy, cz, smu);
  }
}

}  // namespace

// `plan` is a host buffer of `plan_bytes` bytes laid out as `Plan`.
extern "C" int pfs_coupled_matvec(const void* plan, int plan_bytes,
                                  const void* geom, const void* v,
                                  const void* s_mu, void* q, int same_axis,
                                  void* stream) {
  if (plan_bytes != (int)sizeof(Plan)) return (int)cudaErrorInvalidValue;
  MatvecArgs a;
  memcpy(&a.plan, plan, sizeof(Plan));
  a.geom = static_cast<const float*>(geom);
  a.v = static_cast<const float*>(v);
  a.s_mu = static_cast<const float*>(s_mu);
  a.q = static_cast<float*>(q);
  const long n = a.plan.off[3];
  if (n <= 0) return 0;
  const long blocks = (n + pfs::kThreads - 1) / pfs::kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (same_axis)
    coupled_matvec_kernel<pfs::coupled::kSameTerms>
        <<<(unsigned)blocks, pfs::kThreads, 0, st>>>(a);
  else
    coupled_matvec_kernel<pfs::coupled::kTerms>
        <<<(unsigned)blocks, pfs::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
