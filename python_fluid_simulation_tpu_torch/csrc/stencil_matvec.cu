// One application of the 7-point cell-centred operator, q = A p.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_stencils.py::
// make_blocked_stencil_matvec: the TPU kernel streams x-slabs of p (with a
// one-plane halo on each side, hence x offsets of +-1 only) and the seven
// coefficient slabs through VMEM.  On Hopper there is no slab schedule to
// manage: one thread per cell reads its diagonal, six coefficients and
// seven p values, neighbours outside the grid read 0.
//
// What bounds it: bytes.  It reads 8 fields (diag, 6 coefficients, p) and
// writes one, 36 bytes a cell against 13 fp32 operations, far below the
// H100's ~20 operations a byte; the 6 neighbour reads of p hit L1/L2.  The
// design keeps every access coalesced along z (the fastest axis) and does
// nothing else.  Used by the MG-PCG route as the outer CG operator and as
// the level-0 smoother / residual of the V-cycle (solvers/multigrid.py),
// and on a stack of B systems as the level-0 operator of the batched
// viscosity V-cycle (each system's x bounds its own, B = 1 for one grid).

#include "pcg_common.cuh"

namespace {

// kBatched: a stack of B > 1 systems (the x index costs one more division
// a cell, so one grid takes the plain 3D form).
template <bool kBatched>
__global__ void __launch_bounds__(pfs::kThreads)
    stencil_matvec_kernel(const __grid_constant__ pfs::Stencil7 s,
                          const float* __restrict__ p, float* __restrict__ q) {
  const long n = (long)s.B * s.X * s.Y * s.Z;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    q[i] = pfs::stencil7<kBatched>(s, p, i);
}

}  // namespace

extern "C" int pfs_stencil_matvec(const void* diag, const void* cxp,
                                  const void* cxm, const void* cyp,
                                  const void* cym, const void* czp,
                                  const void* czm, const void* p, void* q,
                                  int B, int X, int Y, int Z, void* stream) {
  const pfs::Stencil7 s = pfs::make_stencil7(diag, cxp, cxm, cyp, cym, czp, czm, X, Y, Z, B);
  const long n = (long)B * X * Y * Z;
  if (n <= 0) return 0;
  const long blocks = (n + pfs::kThreads - 1) / pfs::kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  float* qp = static_cast<float*>(q);
  if (B > 1)
    stencil_matvec_kernel<true><<<(unsigned)blocks, pfs::kThreads, 0, st>>>(s, pp, qp);
  else
    stencil_matvec_kernel<false><<<(unsigned)blocks, pfs::kThreads, 0, st>>>(s, pp, qp);
  return (int)cudaGetLastError();
}
