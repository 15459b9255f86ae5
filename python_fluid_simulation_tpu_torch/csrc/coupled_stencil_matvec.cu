// One application of the coupled viscosity operator from its materialised
// coefficients, q = A v, on the three face arrays (vx, vy, vz).
//
// Replaces python_fluid_simulation_tpu/ops/pallas_stencils.py::
// make_blocked_coupled_matvec (x-slabs of the 45 coefficient fields and
// the three velocity fields streamed through VMEM, one call per output
// axis) and ::make_coupled_stencil_matvec (the same on whole arrays, for
// grids whose 56 arrays fit VMEM).  Both pad every field to one common
// box and read neighbours by lane rolls; those reads land only on zero
// coefficients, a VMEM layout device.  Here one launch serves all three
// output axes (blockIdx.y = axis), one thread per output face, z the
// fastest axis so that every coefficient, diagonal and output access is
// coalesced; a neighbour outside the sampled field's own shape reads 0,
// as ops/indexing.py::sample does.
//
// The field pointers, the face shapes and the term table (field, offset)
// of solvers/viscosity.py::viscosity_term_fields travel in one
// __grid_constant__ parameter struct, each term with the pointer and the
// extents of the field it samples.  The block's output axis selects one
// of three instantiations, so every parameter offset is a compile-time
// constant: the pointers and offsets are read as constant-bank operands
// and take no registers (a first version indexed the struct by the
// runtime axis and needed 228 registers a thread).  Every product and sum
// is rounded on its own (__fmul_rn / __fadd_rn), in the plain version's
// order (diag * v first, then the 14 terms as listed), so the result is
// bitwise ops/cuda_stencils.py::coupled_stencil_matvec_plain.
//
// What bounds it: bytes.  A face reads its diagonal and 14 coefficients
// once (60 bytes) and writes one value, against 29 fp32 operations; the
// 15 velocity reads a face come mostly from L1/L2 (neighbouring threads
// read neighbouring z).  Each input read once and the output written
// once is 17 floats a face: ~38 MB at 48x80x48 cells, ~11 us at
// 3.35 TB/s.  Indices are 32-bit (the wrapper checks every face array
// holds fewer than 2^31 entries).

#include "pcg_common.cuh"

namespace {

constexpr int kTerms = 14;  // couplings an axis: 6 same-field, 8 cross-field

struct Term {
  const float* coef;
  const float* v;  // the face field it samples
  int dim[3];      // that field's extents (z fastest)
  int off[3];      // the sample offset
};

struct CoupledStencil {
  const float* diag[3];
  const float* v[3];
  float* q[3];
  int dim[3][3];  // face array a: X, Y, Z
  Term term[3][kTerms];
};

template <int A>
__device__ __forceinline__ void apply_axis(const CoupledStencil& s) {
  const int Y = s.dim[A][1], Z = s.dim[A][2];
  const int n = s.dim[A][0] * Y * Z;
  const int i = blockIdx.x * pfs::kThreads + threadIdx.x;
  if (i >= n) return;
  const int cz = i % Z;
  const int cy = (i / Z) % Y;
  const int cx = i / (Y * Z);
  float acc = __fmul_rn(s.diag[A][i], s.v[A][i]);
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
    const Term& T = s.term[A][t];
    const int nx = cx + T.off[0], ny = cy + T.off[1], nz = cz + T.off[2];
    float val = 0.f;  // outside the sampled field's own shape
    if ((unsigned)nx < (unsigned)T.dim[0] && (unsigned)ny < (unsigned)T.dim[1] &&
        (unsigned)nz < (unsigned)T.dim[2])
      val = T.v[(nx * T.dim[1] + ny) * T.dim[2] + nz];
    acc = __fadd_rn(acc, __fmul_rn(T.coef[i], val));
  }
  s.q[A][i] = acc;
}

__global__ void __launch_bounds__(pfs::kThreads)
    coupled_stencil_matvec_kernel(const __grid_constant__ CoupledStencil s) {
  switch (blockIdx.y) {
    case 0: apply_axis<0>(s); break;
    case 1: apply_axis<1>(s); break;
    default: apply_axis<2>(s); break;
  }
}

}  // namespace

// ptrs: 51 device pointers (3 diagonals, 42 coefficient fields axis by
// axis in term order, 3 velocity fields, 3 outputs); dims: the 9 face
// extents; terms: 3 x 14 x (field, x, y, z offset).
extern "C" int pfs_coupled_stencil_matvec(const void* ptrs, const void* dims,
                                          const void* terms, void* stream) {
  const float* const* p = static_cast<const float* const*>(ptrs);
  const int(*dm)[3] = static_cast<const int(*)[3]>(dims);
  const int(*tm)[kTerms][4] = static_cast<const int(*)[kTerms][4]>(terms);
  CoupledStencil s;
  long most = 0;
  for (int a = 0; a < 3; ++a) {
    s.diag[a] = p[a];
    s.v[a] = p[3 + 3 * kTerms + a];
    s.q[a] = const_cast<float*>(p[6 + 3 * kTerms + a]);
    for (int k = 0; k < 3; ++k) s.dim[a][k] = dm[a][k];
    const long n = (long)dm[a][0] * dm[a][1] * dm[a][2];
    if (n > most) most = n;
  }
  for (int a = 0; a < 3; ++a)
    for (int t = 0; t < kTerms; ++t) {
      const int f = tm[a][t][0];
      if (f < 0 || f > 2) return (int)cudaErrorInvalidValue;
      Term& T = s.term[a][t];
      T.coef = p[3 + a * kTerms + t];
      T.v = s.v[f];
      for (int k = 0; k < 3; ++k) {
        T.dim[k] = dm[f][k];
        T.off[k] = tm[a][t][1 + k];
      }
    }
  if (most <= 0) return 0;
  const dim3 grid((unsigned)((most + pfs::kThreads - 1) / pfs::kThreads), 3);
  coupled_stencil_matvec_kernel<<<grid, pfs::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(s);
  return (int)cudaGetLastError();
}
