// The multigrid V-cycle below level 0 in one launch (the "tail"): given
// the level-0 iterate x and residual r of a V-cycle, it writes
//   out = x + P e1,   e1 = the V-cycle of levels 1..L on R r,
// where every level k >= 1 runs
//   presmooth   n_smooth relaxations from 0, then r_k = b_k - A_k x_k
//   (recurse)   b_{k+1} = R r_k,  e_{k+1} = V-cycle of the coarser levels
//   postsmooth  n_smooth relaxations from x_k + P e_{k+1}
// and the last level L runs coarse_iters relaxations from 0.  The
// relaxation is x <- x + (b - A x) * inv, inv = omega / (diag > 0 ? diag :
// 1), the first from 0 taken as b * inv (A 0 = 0).  R sums the 2^3
// children of a coarse cell (odd axes zero-padded), P injects the parent.
//
// Replaces python_fluid_simulation_tpu/ops/pallas_mg.py::
// make_level_kernels (_chain): the TPU holds each level in VMEM and runs
// one pallas_call a chain, leaving the transfers to XLA, which fuses
// them.  Here a chain a launch and the transfers as PyTorch ops came to
// about 50 launches a V-cycle, each a few microseconds of work behind a
// launch and a grid barrier.  One cooperative launch runs the whole tail:
//   - the large levels (more than BLOCK_CELLS cells, ops/cuda_mg.py) run
//     across the grid, one grid barrier after each phase; they are
//     L2-resident (level 1 of the 128^3 hierarchy is 97k cells);
//   - from the first level at or below BLOCK_CELLS, the levels down to
//     the coarse solve and back run inside block 0 with __syncthreads()
//     between phases, their b and iterates in shared memory (the stencil
//     fields stay in device memory, read-only and L1-cached), while the
//     other blocks wait at one grid barrier: the grid restricts into the
//     first of them, block 0 stages it into shared memory and at the end
//     writes its result back for the grid; a coarse level of one or two
//     cells a thread keeps its stencils in registers through the coarse
//     solve;
//   - the restriction is fused with the first relaxation of the coarser
//     level (8 lanes a coarse cell compute its children's residuals, warp
//     butterflies sum them, one lane writes b and b * inv), and the
//     prolongation with the first post-relaxation (each read of the
//     iterate adds the parent's correction), so a level costs 2 n_smooth
//     phases, the coarse level coarse_iters, and no residual is stored.
// Each grid phase reads what other threads wrote before the last barrier
// through L2 (__ldcg).  The level descriptors (pointers, shapes) and the
// workspace (b and two ping-pong iterates a level) are built once per
// preconditioner by ops/cuda_mg.py::make_vcycle_tail.
//
// What bounds it: barriers and latency, not bytes.  At 128^3 the function
// reads and writes 12 MB (3.7 us at 3.35 TB/s) and takes 49 us on an H100
// (PERF.md row 9): 10 grid barriers and 32 block ones a cycle, and moving
// the coarse solve's 24 relaxations from the grid into the block saves
// 1.4 us each.  Hence the block levels, the registers of the coarse
// solve, the fused transfers and 32-bit indices with coordinates divided
// out once a cell.
//
// Every operation is rounded on its own (no FMA contraction) in the order
// of the plain composition (ops/cuda_mg.py::vcycle_tail_plain:
// level_chain_plain, restrict, prolong and the add): the stencil in
// OFFSETS order, the residual b - A x, the child sums along x, then z,
// then y (the JAX package's order), x + e at each prolongation; so the
// kernel is bitwise the plain version.
//
// A level may be a stack of B independent systems (the batched viscosity
// V-cycle): the batch has an index of its own, each system's x bounds are
// checked and transfers stay within a system, so padding carries nothing.

#include <cstdint>

#include "pcg_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxLevels = 12;  // levels below level 0 (build_hierarchy stops at 10 levels)
constexpr int kTailThreads = 1024;
constexpr int kWords = 14;  // int64 words of a packed level descriptor (ops/cuda_mg.py::TAIL_WORDS)
// dynamic shared memory for the levels inside block 0 (ops/cuda_mg.py::
// TAIL_SMEM_BYTES): with the static level table, within a block's 227 KB
constexpr long kSmemBytes = 220 * 1024;

struct TailLevel {
  pfs::Stencil7 A;
  float* b;
  float* buf[2];  // the iterate and its ping-pong partner
};

struct TailArgs {
  TailLevel lv[kMaxLevels + 1];  // levels 1..L (lv[0] unused)
  const float* x0;               // level 0
  const float* r0;
  float* out;
  int B, X, Y, Z;  // level 0's shape
  int L;
  int block_level;  // first level run inside block 0 (L + 1: none)
  int n_smooth, coarse_iters;
  float omega;
};

// A grid-stride (or block-stride) range of cells.  Indices are 32-bit
// (the launcher refuses a level 0 of 2^31 cells or more), and each cell's
// coordinates are divided out once: its neighbours', children's and
// parent's follow by adding and halving.
struct Span {
  int i0, stride;
};

__host__ __device__ __forceinline__ long cells_of(const pfs::Stencil7& s) { return (long)s.B * s.X * s.Y * s.Z; }

__device__ __forceinline__ float inv_of(float d, float omega) { return omega / (d > 0.f ? d : 1.f); }

__device__ __forceinline__ int flat(int bb, int x, int y, int z, int X, int Y, int Z) {
  return ((bb * X + x) * Y + y) * Z + z;
}

// Cell i of a stack of X x Y x Z grids: its system bb and (x, y, z).
template <bool kB>
__device__ __forceinline__ void coords(int i, int X, int Y, int Z, int& bb, int& x, int& y, int& z) {
  z = i % Z;
  int q = i / Z;
  y = q % Y;
  q /= Y;
  x = kB ? q % X : q;
  bb = kB ? q / X : 0;
}

// (A p)[i] at cell (bb, x, y, z), p read through at(j, bb, x, y, z):
// pcg_common.cuh::stencil7's order, neighbours outside the system read 0.
template <typename At>
__device__ __forceinline__ float stencil_at(const pfs::Stencil7& s, int i, int bb, int x, int y, int z, At at) {
  const int yz = s.Y * s.Z;
  float acc = __fmul_rn(s.diag[i], at(i, bb, x, y, z));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[0][i], x + 1 < s.X ? at(i + yz, bb, x + 1, y, z) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[1][i], x > 0 ? at(i - yz, bb, x - 1, y, z) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[2][i], y + 1 < s.Y ? at(i + s.Z, bb, x, y + 1, z) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[3][i], y > 0 ? at(i - s.Z, bb, x, y - 1, z) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[4][i], z + 1 < s.Z ? at(i + 1, bb, x, y, z + 1) : 0.f));
  acc = __fadd_rn(acc, __fmul_rn(s.coef[5][i], z > 0 ? at(i - 1, bb, x, y, z - 1) : 0.f));
  return acc;
}

// A value another thread wrote before the last barrier: from shared
// memory (a level inside block 0), or through L2 from device memory
// (another SM may have written it).
template <bool kSmem>
__device__ __forceinline__ float ld(const float* p) {
  return kSmem ? *p : __ldcg(p);
}

// Level k's right-hand side b = R r_{k-1} and the first relaxation from
// 0, b * inv, into buf[0].  Level 1 restricts the input residual r_0: a
// thread a coarse cell sums its 8 children, x pairs, then z pairs, then
// the y pair.
template <bool kB>
__device__ void restrict_input(const TailArgs& a, const TailLevel& c, Span sp) {
  const int n = (int)cells_of(c.A);
  for (int I = sp.i0; I < n; I += sp.stride) {
    int bb, cx, cy, cz;
    coords<kB>(I, c.A.X, c.A.Y, c.A.Z, bb, cx, cy, cz);
    float s2[2];
#pragma unroll
    for (int jy = 0; jy < 2; ++jy) {
      float s1[2];
#pragma unroll
      for (int jz = 0; jz < 2; ++jz) {
        float v[2];
#pragma unroll
        for (int jx = 0; jx < 2; ++jx) {
          const int x = 2 * cx + jx, y = 2 * cy + jy, z = 2 * cz + jz;
          v[jx] = x < a.X && y < a.Y && z < a.Z ? a.r0[flat(bb, x, y, z, a.X, a.Y, a.Z)] : 0.f;  // 0: padding
        }
        s1[jz] = __fadd_rn(v[0], v[1]);  // the x pair
      }
      s2[jy] = __fadd_rn(s1[0], s1[1]);  // the z pair
    }
    const float bv = __fadd_rn(s2[0], s2[1]);  // the y pair
    c.b[I] = bv;
    c.buf[0][I] = __fmul_rn(bv, inv_of(c.A.diag[I], a.omega));
  }
}

// The same for a level k > 1, whose children's values are the residuals
// of level k-1's presmoothed iterate (read from shared memory with
// kFineSmem), a stencil each: a thread a child, the 8 children of a
// coarse cell in 8 adjacent lanes (bit 0 x, bit 1 z, bit 2 y), and
// butterflies over lane bits 0, 1, 2 add the x pairs, then the z pairs,
// then the y pair (each add commutes, so every lane of the group holds
// the same sum); the warp runs the loop together.
template <bool kB, bool kFineSmem>
__device__ void restrict_residual(const TailArgs& a, const TailLevel& c, const TailLevel& f, Span sp) {
  const float* xf = f.buf[(a.n_smooth - 1) & 1];
  const auto at = [=](int m, int, int, int, int) { return ld<kFineSmem>(xf + m); };
  const int n = (int)cells_of(c.A);
  const int lane = threadIdx.x & 31;
  for (int t = sp.i0; t - lane < 8 * n; t += sp.stride) {
    const int I = t >> 3, child = t & 7;
    float v = 0.f;  // a zero-padded child, or a lane past the last cell
    if (I < n) {
      int bb, cx, cy, cz;
      coords<kB>(I, c.A.X, c.A.Y, c.A.Z, bb, cx, cy, cz);
      const int x = 2 * cx + (child & 1), y = 2 * cy + (child >> 2), z = 2 * cz + ((child >> 1) & 1);
      if (x < f.A.X && y < f.A.Y && z < f.A.Z) {
        const int j = flat(bb, x, y, z, f.A.X, f.A.Y, f.A.Z);
        v = __fsub_rn(ld<kFineSmem>(f.b + j), stencil_at(f.A, j, bb, x, y, z, at));
      }
    }
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));  // the x pairs
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));  // the z pairs
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));  // the y pair
    if (I < n && child == 0) {
      c.b[I] = v;
      c.buf[0][I] = __fmul_rn(v, inv_of(c.A.diag[I], a.omega));
    }
  }
}

template <bool kB, bool kFineSmem>
__device__ void restrict_relax(const TailArgs& a, const TailLevel* lv, int k, Span sp) {
  if (k == 1)
    restrict_input<kB>(a, lv[1], sp);
  else
    restrict_residual<kB, kFineSmem>(a, lv[k], lv[k - 1], sp);
}

// One relaxation of level l: dst = p + (b - A p) * inv, p read through at.
template <bool kB, bool kSmem, typename At>
__device__ void relax(const TailArgs& a, const TailLevel& l, At at, float* dst, Span sp) {
  const int n = (int)cells_of(l.A);
  for (int i = sp.i0; i < n; i += sp.stride) {
    int bb, x, y, z;
    coords<kB>(i, l.A.X, l.A.Y, l.A.Z, bb, x, y, z);
    const float inv = inv_of(l.A.diag[i], a.omega);
    dst[i] = __fadd_rn(at(i, bb, x, y, z),
                       __fmul_rn(__fsub_rn(ld<kSmem>(l.b + i), stencil_at(l.A, i, bb, x, y, z, at)), inv));
  }
}

// The coarse solve's relaxations 2..coarse_iters inside block 0 when the
// level has kPer cells a thread at most: each thread keeps its cells'
// stencils, b and inv in registers for all of them, so a relaxation reads
// only the iterate (shared memory) and costs little more than its
// barrier.  The arithmetic is `relax`'s.
template <bool kB, int kPer, typename Sync>
__device__ void coarse_in_block(const TailArgs& a, const TailLevel& l, Sync sync) {
  const pfs::Stencil7& s = l.A;
  const int n = (int)cells_of(s), yz = s.Y * s.Z;
  const int off[6] = {yz, -yz, s.Z, -s.Z, 1, -1};
  float d[kPer], co[kPer][6], bv[kPer], inv[kPer];
  unsigned in[kPer];  // bit q: neighbour q inside the system
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int i = threadIdx.x + c * blockDim.x;
    in[c] = 0;
    if (i >= n) continue;
    int bb, x, y, z;
    coords<kB>(i, s.X, s.Y, s.Z, bb, x, y, z);
    d[c] = s.diag[i];
    inv[c] = inv_of(d[c], a.omega);
    bv[c] = l.b[i];
    in[c] = (x + 1 < s.X) | (x > 0) << 1 | (y + 1 < s.Y) << 2 | (y > 0) << 3 | (z + 1 < s.Z) << 4 | (z > 0) << 5;
#pragma unroll
    for (int q = 0; q < 6; ++q) co[c][q] = s.coef[q][i];
  }
  for (int j = 1; j < a.coarse_iters; ++j) {
    const float* src = l.buf[(j - 1) & 1];
    float* dst = l.buf[j & 1];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int i = threadIdx.x + c * blockDim.x;
      if (i >= n) continue;
      const float p = src[i];
      float acc = __fmul_rn(d[c], p);
#pragma unroll
      for (int q = 0; q < 6; ++q) acc = __fadd_rn(acc, __fmul_rn(co[c][q], in[c] >> q & 1 ? src[i + off[q]] : 0.f));
      dst[i] = __fadd_rn(p, __fmul_rn(__fsub_rn(bv[c], acc), inv[c]));
    }
    sync();
  }
}

// Level k on the way down after its restriction: relaxations 2..iters
// (relaxation j + 1 reads buf[(j - 1) & 1] and writes buf[j & 1]); the
// presmoothed (or coarse-solved) iterate ends in buf[(iters - 1) & 1].
// kSmem: the level lives in shared memory.
template <bool kB, bool kSmem, typename Sync>
__device__ void smooth_down(const TailArgs& a, const TailLevel& l, int k, Span sp, Sync sync) {
  if (kSmem && k == a.L && cells_of(l.A) <= (long)blockDim.x) return coarse_in_block<kB, 1>(a, l, sync);
  if (kSmem && k == a.L && cells_of(l.A) <= 2L * blockDim.x) return coarse_in_block<kB, 2>(a, l, sync);
  const int iters = k == a.L ? a.coarse_iters : a.n_smooth;
  for (int j = 1; j < iters; ++j) {
    const float* src = l.buf[(j - 1) & 1];
    relax<kB, kSmem>(a, l, [=](int m, int, int, int, int) { return ld<kSmem>(src + m); }, l.buf[j & 1], sp);
    sync();
  }
}

// Level k on the way down: the restriction with the first relaxation,
// then the others.  kSmem: the levels k-1 and k live in shared memory.
template <bool kB, bool kSmem, typename Sync>
__device__ void down(const TailArgs& a, const TailLevel* lv, int k, Span sp, Sync sync) {
  restrict_relax<kB, kSmem>(a, lv, k, sp);
  sync();
  smooth_down<kB, kSmem>(a, lv[k], k, sp, sync);
}

// Level k < L on the way up: the first post-relaxation reads the
// presmoothed iterate plus the parent's correction (the prolongation and
// its add), the others ping-pong; the result ends in buf[1].
template <bool kB, bool kSmem, typename Sync>
__device__ void up(const TailArgs& a, const TailLevel* lv, int k, Span sp, Sync sync) {
  const TailLevel& l = lv[k];
  const TailLevel& c = lv[k + 1];
  const int n = a.n_smooth;
  const float* xpre = l.buf[(n - 1) & 1];
  const float* ec = c.buf[k + 1 == a.L ? (a.coarse_iters - 1) & 1 : 1];
  const int cX = c.A.X, cY = c.A.Y, cZ = c.A.Z;
  relax<kB, kSmem>(a, l, [=](int m, int bb, int x, int y, int z) {
    return __fadd_rn(ld<kSmem>(xpre + m), ld<kSmem>(ec + flat(bb, x >> 1, y >> 1, z >> 1, cX, cY, cZ)));
  }, l.buf[n & 1], sp);
  sync();
  for (int j = 1; j < n; ++j) {
    const float* src = l.buf[(n - 1 + j) & 1];
    relax<kB, kSmem>(a, l, [=](int m, int, int, int, int) { return ld<kSmem>(src + m); }, l.buf[(n + j) & 1], sp);
    sync();
  }
}

template <bool kB>
__global__ void __launch_bounds__(kTailThreads) mg_vcycle_tail_kernel(const __grid_constant__ TailArgs a) {
  extern __shared__ float smem[];  // b, buf[0], buf[1] of each level run inside block 0
  __shared__ TailLevel blv[kMaxLevels + 1];
  cg::grid_group grid = cg::this_grid();
  const Span g{(int)(blockIdx.x * blockDim.x + threadIdx.x), (int)(gridDim.x * blockDim.x)};
  const Span blk{(int)threadIdx.x, (int)blockDim.x};
  auto grid_sync = [&] { grid.sync(); };
  auto block_sync = [] { __syncthreads(); };
  const int L = a.L, s = a.block_level;
  for (int k = 1; k <= min(s - 1, L); ++k) down<kB, false>(a, a.lv, k, g, grid_sync);
  if (s <= L) {
    // the grid restricts into level s (the block alone would walk the
    // finer level's residuals a few cells a thread)
    restrict_relax<kB, false>(a, a.lv, s, g);
    grid_sync();
    if (blockIdx.x == 0) {
      // the levels from s on get their b and iterates in shared memory;
      // level s's b and first iterate come from device memory
      if (threadIdx.x == 0) {
        float* p = smem;
        for (int k = 1; k <= L; ++k) {
          blv[k] = a.lv[k];
          if (k < s) continue;
          const long n = cells_of(a.lv[k].A);
          blv[k].b = p;
          blv[k].buf[0] = p + n;
          blv[k].buf[1] = p + 2 * n;
          p += 3 * n;
        }
      }
      __syncthreads();
      const int ns = (int)cells_of(a.lv[s].A);
      for (int i = threadIdx.x; i < ns; i += blockDim.x) {
        blv[s].b[i] = __ldcg(a.lv[s].b + i);
        blv[s].buf[0][i] = __ldcg(a.lv[s].buf[0] + i);
      }
      block_sync();
      smooth_down<kB, true>(a, blv[s], s, blk, block_sync);
      for (int k = s + 1; k <= L; ++k) down<kB, true>(a, blv, k, blk, block_sync);
      for (int k = L - 1; k >= s; --k) up<kB, true>(a, blv, k, blk, block_sync);
      // level s's result to device memory, where the grid reads it
      const int res = s == L ? (a.coarse_iters - 1) & 1 : 1;
      for (int i = threadIdx.x; i < ns; i += blockDim.x) a.lv[s].buf[res][i] = blv[s].buf[res][i];
    }
    grid.sync();  // the other blocks wait here for block 0's levels
  }
  for (int k = min(s - 1, L - 1); k >= 1; --k) up<kB, false>(a, a.lv, k, g, grid_sync);
  // out = x + P e1: each level-1 cell adds its value to its children
  const TailLevel& l1 = a.lv[1];
  const float* e1 = l1.buf[L == 1 ? (a.coarse_iters - 1) & 1 : 1];
  const int n1 = (int)cells_of(l1.A);
  for (int I = g.i0; I < n1; I += g.stride) {
    int bb, cx, cy, cz;
    coords<kB>(I, l1.A.X, l1.A.Y, l1.A.Z, bb, cx, cy, cz);
    const float e = __ldcg(e1 + I);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int x = 2 * cx + (c >> 2), y = 2 * cy + ((c >> 1) & 1), z = 2 * cz + (c & 1);
      if (x < a.X && y < a.Y && z < a.Z) {
        const int j = flat(bb, x, y, z, a.X, a.Y, a.Z);
        a.out[j] = __fadd_rn(a.x0[j], e);
      }
    }
  }
}

}  // namespace

// desc: nlev packed level descriptors (levels 1..nlev), kWords int64 each:
// diag, the six coefficients (+x, -x, +y, -y, +z, -z), b, x, its partner
// (device pointers), then B, X, Y, Z.
extern "C" int pfs_mg_vcycle_tail(const long long* desc, int nlev, int block_level, const void* x0,
                                  const void* r0, void* out, int B, int X, int Y, int Z, int n_smooth,
                                  int coarse_iters, float omega, void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || block_level < 1 || block_level > nlev + 1 || n_smooth < 1 ||
      coarse_iters < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  TailArgs a{};
  for (int k = 1; k <= nlev; ++k) {
    const long long* w = desc + (long)(k - 1) * kWords;
    auto ptr = [&](int j) { return reinterpret_cast<void*>(static_cast<uintptr_t>(w[j])); };
    if (w[10] != B) return (int)cudaErrorInvalidValue;
    a.lv[k].A = pfs::make_stencil7(ptr(0), ptr(1), ptr(2), ptr(3), ptr(4), ptr(5), ptr(6), (int)w[11], (int)w[12],
                                   (int)w[13], B);
    a.lv[k].b = static_cast<float*>(ptr(7));
    a.lv[k].buf[0] = static_cast<float*>(ptr(8));
    a.lv[k].buf[1] = static_cast<float*>(ptr(9));
  }
  a.x0 = static_cast<const float*>(x0);
  a.r0 = static_cast<const float*>(r0);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  a.L = nlev;
  a.block_level = block_level;
  a.n_smooth = n_smooth;
  a.coarse_iters = coarse_iters;
  a.omega = omega;
  if ((long)B * X * Y * Z >= (1L << 31)) return (int)cudaErrorInvalidValue;  // 32-bit indices
  long smem = 0;  // the block levels' b and iterates
  for (int k = block_level; k <= nlev; ++k) smem += 3 * sizeof(float) * cells_of(a.lv[k].A);
  if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
  auto* kernel = B > 1 ? mg_vcycle_tail_kernel<true> : mg_vcycle_tail_kernel<false>;
  int per_sm = 0, sms = 0;
  cudaError_t e = pfs::coop_capacity((const void*)kernel, kTailThreads, (int)smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // a thread a level-1 cell (the largest phase: its restriction, its
  // relaxations, its children's output), one block a SM at most: the
  // fewer the blocks, the cheaper the grid barrier
  const long need = (cells_of(a.lv[1].A) + kTailThreads - 1) / kTailThreads;
  const int grid = (int)(need < sms ? (need < 1 ? 1 : need) : sms);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, grid, kTailThreads, args, (size_t)smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
