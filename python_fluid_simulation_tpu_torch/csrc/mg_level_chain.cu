// Damped-Jacobi smoothing chains of one multigrid level, one launch per
// chain:
//   presmooth + residual  x = n relaxations from 0;  r = b - A x
//   postsmooth            x = n relaxations from a given x
//   coarse solve          x = coarse_iters relaxations from 0
// with the relaxation x <- x + (b - A x) * inv, inv = omega / (diag > 0 ?
// diag : 1), and the first relaxation from 0 taken as b * inv (A 0 = 0).
//
// Replaces python_fluid_simulation_tpu/ops/pallas_mg.py::
// make_level_kernels (_chain): the TPU kernel holds the whole level in
// VMEM and relaxes it as whole-array values, so every relaxation reads
// the previous iterate at the neighbours for free.  Here the level lives
// in device memory (level 1 of the 77x128x77 hierarchy is 39x64x39, 0.4 MB
// a field; every level fits the 50 MB L2) and one cooperative persistent
// kernel runs the chain with a grid barrier between relaxations.  Jacobi
// must read the OLD iterate at the neighbours, so an in-place update
// would race: relaxations ping-pong between two buffers, arranged so the
// last one lands in the output.
//
// The arithmetic follows the TPU chain's form (x + (b - A x) * inv, inv
// computed once per cell as one IEEE division), not the XLA V-cycle's
// x + omega * r / safe_diag, and every operation is rounded on its own, so
// the kernel is bitwise the plain version (ops/cuda_mg.py::
// level_chain_plain).
//
// A level may be a stack of B independent systems (the batched viscosity
// V-cycle stacks its three axis blocks, padded to one shape).  The TPU
// kernel flattens (B, X) into rows and relies on zero x couplings across
// systems; here the batch has an index of its own and each system's x
// bounds are checked (pcg_common.cuh::stencil7<true>), so nothing depends
// on the padding.  The cooperative grid covers B x cells; B = 1, the one
// grid of the cell V-cycle, runs the 3D instantiation unchanged.
//
// What bounds it: grid barriers.  A relaxation moves ~40 bytes a cell
// (L2-resident) and the levels are small (97k cells down to 36), so each
// relaxation costs about one barrier.  The grid is sized to the level
// (one block for the 3x4x3 coarse level), which keeps the barrier cheap
// where the chain is longest (24 coarse relaxations).

#include "pcg_common.cuh"

namespace {

namespace cg = cooperative_groups;

struct ChainArgs {
  pfs::Stencil7 A;
  const float* b;
  const float* x0;  // nullptr: start from 0
  float* x;         // result
  float* tmp;       // ping-pong partner of x
  float* r;         // nullptr: no residual
  int iters;        // >= 1
  float omega;
};

// kBatched: a stack of B > 1 systems; one grid (B = 1) takes the plain
// 3D stencil, which saves a division a neighbour read.
template <bool kBatched>
__global__ void __launch_bounds__(pfs::kThreads)
    mg_level_chain_kernel(const __grid_constant__ ChainArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long n = (long)a.A.B * a.A.X * a.A.Y * a.A.Z;
  const long stride = (long)gridDim.x * pfs::kThreads;
  const long i0 = (long)blockIdx.x * pfs::kThreads + threadIdx.x;
  const float* src = a.x0;
  for (int k = 0; k < a.iters; ++k) {
    // the last relaxation (k = iters - 1) writes a.x
    float* dst = ((a.iters - 1 - k) & 1) ? a.tmp : a.x;
    for (long i = i0; i < n; i += stride) {
      const float d = a.A.diag[i];
      const float inv = a.omega / (d > 0.f ? d : 1.f);
      const float bv = a.b[i];
      dst[i] = src == nullptr
                   ? __fmul_rn(bv, inv)
                   : __fadd_rn(__ldcg(src + i),
                               __fmul_rn(__fsub_rn(bv, pfs::stencil7<kBatched>(a.A, src, i)), inv));
    }
    grid.sync();
    src = dst;
  }
  if (a.r != nullptr)
    for (long i = i0; i < n; i += stride)
      a.r[i] = __fsub_rn(a.b[i], pfs::stencil7<kBatched>(a.A, a.x, i));
}

}  // namespace

extern "C" int pfs_mg_level_chain(const void* diag, const void* cxp,
                                  const void* cxm, const void* cyp,
                                  const void* cym, const void* czp,
                                  const void* czm, const void* b,
                                  const void* x0, void* x, void* tmp, void* r,
                                  int B, int X, int Y, int Z, int iters,
                                  float omega, void* stream) {
  if (iters < 1 || B < 1) return (int)cudaErrorInvalidValue;
  ChainArgs a;
  a.A = pfs::make_stencil7(diag, cxp, cxm, cyp, cym, czp, czm, X, Y, Z, B);
  a.b = static_cast<const float*>(b);
  a.x0 = static_cast<const float*>(x0);
  a.x = static_cast<float*>(x);
  a.tmp = static_cast<float*>(tmp);
  a.r = static_cast<float*>(r);
  a.iters = iters;
  a.omega = omega;
  auto* kernel = B > 1 ? mg_level_chain_kernel<true> : mg_level_chain_kernel<false>;
  int grid = 0;
  cudaError_t e = pfs::coop_grid(kernel, (long)B * X * Y * Z, &grid);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, grid, pfs::kThreads,
                                  args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
