"""[Frozen copy of ``python_fluid_simulation_tpu_torch/solvers/multigrid.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Geometric multigrid V-cycle preconditioners: for the cell-centred
ghost-fluid Poisson systems (pressure and density projections), and the
batched cycle over the three same-axis blocks of the coupled viscosity
operator (``make_batched_mg_preconditioner``).

Counterpart of ``python_fluid_simulation_tpu.solvers.multigrid``.
Galerkin coarsening
with piecewise-constant transfers keeps the operator 7-point on every
level and reduces to sums of the coefficient fields:

  coarse offdiag(I, I+e_a) = sum of the 4 fine couplings crossing the face
  coarse diag(I)           = sum of children diag + 2 sum of internal couplings

restrict = 8-child sum (P^T), prolong = parent injection (P); smoother:
damped Jacobi, the same count before and after, so the V-cycle is a fixed
SPD operator, safe inside plain PCG.

The transfers and the coarsening are plain tensor code (pair sums of
zero-padded axes, broadcasts), taken axis by axis in the JAX package's
order, so each pair sum rounds as there.  Level 0 smooths with
`stencil_matvec` (the CUDA matvec on the card); everything below it, the
levels k >= 1 with their transfers, is the tail of ``ops/cuda_mg.py``
(one kernel launch a V-cycle on the card), made once per preconditioner.
The batched cycle stacks its systems' levels as (B, X, Y, Z) fields and
runs the same kernels on the stack.  Nothing in the cycle reads a value
back to the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from portbench.reference.ops.cuda_mg import halve as _halve
from portbench.reference.ops.cuda_mg import make_vcycle_tail
from portbench.reference.ops.cuda_mg import prolong as _prolong
from portbench.reference.ops.cuda_mg import restrict as _restrict
from portbench.reference.ops.cuda_mg import vcycle_tail
from portbench.reference.ops.cuda_stencils import stencil_matvec


class _Level(NamedTuple):
    diag: torch.Tensor
    coefs: Tuple  # ((off, coef), ...) both signs per axis
    safe_diag: torch.Tensor


def _coarsen(diag, coefs):
    """Galerkin RAP with piecewise-constant transfers, as separable
    per-axis halvings (x, then y, then z):

      coarse diag        = sum of children diag + 2 sum_axis (even child
                           along the axis, summed along the others) coef(+axis)
      coarse coef(+-axis) = (odd / even child along the axis, summed along
                           the others) coef(+-axis)
    """
    d = diag.ndim

    def halve(a, parities):
        for axis in range(d):
            a = _halve(a, axis, parities[axis])
        return a.contiguous()  # a child selection is a strided view

    cmap = dict(coefs)
    diag_c = halve(diag, (None,) * d)
    for axis in range(d):
        plus = tuple(1 if k == axis else 0 for k in range(d))
        par = tuple(0 if k == axis else None for k in range(d))
        diag_c = diag_c + 2.0 * halve(cmap[plus], par)
    coefs_c = []
    for axis in range(d):
        for sgn in (+1, -1):
            off = tuple(sgn if k == axis else 0 for k in range(d))
            par = tuple((1 if sgn > 0 else 0) if k == axis else None for k in range(d))
            coefs_c.append((off, halve(cmap[off], par)))
    return diag_c, coefs_c


def build_hierarchy(diag, coefs, min_dim: int = 4, max_levels: int = 10) -> List[_Level]:
    levels = []
    cur_diag, cur_coefs = diag, list(coefs)
    for _ in range(max_levels):
        safe = torch.where(cur_diag > 0, cur_diag, 1.0)
        levels.append(_Level(cur_diag, tuple(cur_coefs), safe))
        if min(cur_diag.shape) <= min_dim:
            break
        cur_diag, cur_coefs = _coarsen(cur_diag, cur_coefs)
    return levels


def _vcycle(levels, tail, *, omega, n_smooth, coarse_iters):
    """One symmetric V-cycle from a zero guess over `levels` (fields
    (X, Y, Z), or (B, X, Y, Z) stacks of independent systems): level 0
    smooths in the XLA V-cycle's form with `stencil_matvec` (the CUDA
    matvec on the card), the levels below it are `tail` (None for a
    one-level hierarchy: level 0 is the coarse solve)."""
    top = levels[0]

    def matvec0(p):
        return stencil_matvec(top.diag, top.coefs, p)

    def smooth0(x, b, iters):
        """Level-0 damped Jacobi in the XLA V-cycle's form; x None = from
        zero (the first relaxation is the scaled right-hand side)."""
        for _ in range(iters):
            if x is None:
                x = omega * b / top.safe_diag
                continue
            x = x + omega * (b - matvec0(x)) / top.safe_diag
        return x

    def cycle(b):
        if tail is None:
            return smooth0(None, b, coarse_iters)
        x = smooth0(None, b, n_smooth)
        x = vcycle_tail(tail, x, b - matvec0(x))
        return smooth0(x, b, n_smooth)

    return cycle


def _tail(levels, *, omega, n_smooth, coarse_iters):
    if len(levels) < 2:
        return None
    return make_vcycle_tail(levels, omega=omega, n_smooth=n_smooth, coarse_iters=coarse_iters)


def make_mg_preconditioner(diag, coefs, *, n_smooth: int = 2, omega: float = 0.8, coarse_iters: int = 24, min_dim: int = 4):
    """Returns M^{-1}: r -> z, one symmetric V-cycle with zero initial
    guess, restricted to the active rows (diag > 0)."""
    levels = build_hierarchy(diag, coefs, min_dim=min_dim)
    tail = _tail(levels, omega=omega, n_smooth=n_smooth, coarse_iters=coarse_iters)
    cycle = _vcycle(levels, tail, omega=omega, n_smooth=n_smooth, coarse_iters=coarse_iters)
    active = levels[0].diag > 0

    def precond(r):
        # identity on the inactive rows (A's row and column are zero
        # there): keeps M SPD and x from drifting where the residual
        # cannot see it
        return torch.where(active, cycle(r), r)

    precond.tail = tail  # the levels below level 0, for inspection
    return precond


# ---------------------------------------------------------------------------
# Batched V-cycle: one cycle for several same-shaped independent systems
# (the per-axis diagonal blocks of the coupled viscosity operator), each
# level a (B, X, Y, Z) stack: one tail launch a cycle for all B systems.
# ---------------------------------------------------------------------------


def _pad_to(a, shape, fill=0.0):
    """`a` zero- (or `fill`-) padded at the high end of each axis to `shape`."""
    if tuple(a.shape) == tuple(shape):
        return a
    out = a.new_full(tuple(shape), fill)
    out[tuple(slice(0, int(s)) for s in a.shape)] = a
    return out


def _canon(coefs):
    """Coefficients in the canonical (+x, -x, +y, -y, +z, -z) order —
    `_coarsen`'s output order, so every level of every hierarchy lines up
    for stacking (and the kernels' 7-point order)."""

    def key(item):
        off = item[0]
        axis = next(i for i, o in enumerate(off) if o)
        return (axis, 0 if off[axis] > 0 else 1)

    return sorted(coefs, key=key)


def make_batched_mg_preconditioner(systems, *, n_smooth: int = 2, omega: float = 0.8, coarse_iters: int = 24, min_dim: int = 4):
    """M^{-1} for B independent same-stencil systems in ONE V-cycle.

    ``systems``: list of (diag, coefs), e.g. the per-axis same-field
    sub-operators of the viscosity block preconditioner.  Hierarchies
    are built per system (their shapes differ by +-1 face plane) and
    stacked per level onto the common padded shape; padded rows carry
    diag = 0, coefs = 0 and safe_diag = 1 (identity).  Returns a function
    mapping a tuple of B residual arrays to B corrected arrays.
    """
    hiers = [build_hierarchy(diag, _canon(coefs), min_dim=min_dim) for diag, coefs in systems]
    n_lev = min(len(h) for h in hiers)
    levels = []
    for k in range(n_lev):
        common = tuple(max(int(h[k].diag.shape[i]) for h in hiers) for i in range(hiers[0][k].diag.ndim))
        offs = [off for off, _ in hiers[0][k].coefs]
        for h in hiers:
            assert [off for off, _ in h[k].coefs] == offs
        levels.append(_Level(
            torch.stack([_pad_to(h[k].diag, common) for h in hiers]),
            tuple((off, torch.stack([_pad_to(h[k].coefs[j][1], common) for h in hiers]))
                  for j, off in enumerate(offs)),
            torch.stack([_pad_to(h[k].safe_diag, common, 1.0) for h in hiers]),
        ))
    tail = _tail(levels, omega=omega, n_smooth=n_smooth, coarse_iters=coarse_iters)
    cycle = _vcycle(levels, tail, omega=omega, n_smooth=n_smooth, coarse_iters=coarse_iters)
    active = levels[0].diag > 0
    shapes = [tuple(h[0].diag.shape) for h in hiers]
    common0 = tuple(levels[0].diag.shape[1:])

    def precond(rs):
        rb = torch.stack([_pad_to(r, common0) for r in rs])
        zb = torch.where(active, cycle(rb), rb)
        return tuple(zb[i][tuple(slice(0, s) for s in shapes[i])] for i in range(len(shapes)))

    precond.levels = levels  # the stacked hierarchy, for inspection
    precond.tail = tail
    return precond
