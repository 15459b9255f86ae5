"""Geometric multigrid V-cycle preconditioner for the cell-centred
ghost-fluid Poisson systems (pressure and density projections).

Counterpart of the cell-Poisson half of
``python_fluid_simulation_tpu.solvers.multigrid``.  Galerkin coarsening
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
`stencil_matvec` (the CUDA matvec on the card); levels k >= 1 run their
smoothing chains through ``ops/cuda_mg.py`` (one kernel launch per chain
on the card).  Nothing in the cycle reads a value back to the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from python_fluid_simulation_tpu_torch.ops.cuda_mg import level_kernels
from python_fluid_simulation_tpu_torch.ops.cuda_stencils import stencil_matvec


class _Level(NamedTuple):
    diag: torch.Tensor
    coefs: Tuple  # ((off, coef), ...) both signs per axis
    safe_diag: torch.Tensor


def _halve(a, axis: int, parity):
    """Halve one axis (zero-padded to even): parity None sums each child
    pair, 0 / 1 takes the even / odd child."""
    if a.shape[axis] % 2:
        pad = list(a.shape)
        pad[axis] = 1
        a = torch.cat([a, a.new_zeros(pad)], dim=axis)
    shp = a.shape[:axis] + (a.shape[axis] // 2, 2) + a.shape[axis + 1 :]
    r = a.reshape(shp)
    if parity is None:
        return r.select(axis + 1, 0) + r.select(axis + 1, 1)
    return r.select(axis + 1, parity)


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


def _restrict(r, coarse_shape):
    """P^T r: 2^d-child sum onto the coarse grid (x, then z, then y, the
    JAX package's order)."""
    assert all(c == (s + 1) // 2 for s, c in zip(r.shape, coarse_shape)), (r.shape, coarse_shape)
    d = r.ndim
    for axis in tuple(range(d - 2)) + (d - 1, d - 2):
        r = _halve(r, axis, None)
    return r


def _prolong(e, fine_shape):
    """P e: inject the parent value into all children."""
    for axis, n in enumerate(fine_shape):
        shp = list(e.shape)
        e = e.unsqueeze(axis + 1).expand(*shp[: axis + 1], 2, *shp[axis + 1 :])
        e = e.reshape(*shp[:axis], 2 * shp[axis], *shp[axis + 1 :]).narrow(axis, 0, n)
    return e.contiguous()


def make_mg_preconditioner(diag, coefs, *, n_smooth: int = 2, omega: float = 0.8, coarse_iters: int = 24, min_dim: int = 4):
    """Returns M^{-1}: r -> z, one symmetric V-cycle with zero initial
    guess, restricted to the active rows (diag > 0)."""
    levels = build_hierarchy(diag, coefs, min_dim=min_dim)
    chains = {
        k: level_kernels(lv.diag, lv.coefs, omega=omega, n_smooth=n_smooth, coarse_iters=coarse_iters)
        for k, lv in enumerate(levels) if k >= 1
    }
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

    def vcycle(k: int, b):
        if k == len(levels) - 1:
            if k in chains:
                return chains[k].coarse_solve(b)
            return smooth0(None, b, coarse_iters)
        if k in chains:
            x, r = chains[k].presmooth_resid(b)
        else:
            x = smooth0(None, b, n_smooth)
            r = b - matvec0(x)
        ec = vcycle(k + 1, _restrict(r, levels[k + 1].diag.shape))
        x = x + _prolong(ec, b.shape)
        if k in chains:
            return chains[k].postsmooth(x, b)
        return smooth0(x, b, n_smooth)

    active = top.diag > 0

    def precond(r):
        # identity on the inactive rows (A's row and column are zero
        # there): keeps M SPD and x from drifting where the residual
        # cannot see it
        return torch.where(active, vcycle(0, r), r)

    return precond
