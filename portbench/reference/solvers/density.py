"""[Frozen copy of ``python_fluid_simulation_tpu_torch/solvers/density.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Implicit density/position projection (3D): volume conservation by
moving particles.

Counterpart of ``python_fluid_simulation_tpu.solvers.density`` (the
reference's ``solver/DensityCGSolver3D.py``).  Pipeline (reference solve
:312-350): scatter particle mass/volume to cell centers -> fix_volume
clamp -> RHS b = (1 - rho_frac)/dt with solid imputation -> 7-point PCG
(unit-weight diagonal; Jacobi or multigrid, as configured) -> face displacement field ->
trilinear gather onto particles.

The 2D variant (`density_solve_2d`, the reference's
``solver/DensityCGSolver2D.py``) scatters mass only (the reference's
volume scatter is commented out, :33), takes the cell volume from the
9-point weighted sum of the dual-lattice fluid volume (`fix_volume_2d`),
gathers the displacement plainly, and solves with the generic CG over
the plain 5-point matvec (``pressure.py::solve_cell_poisson``).

Documented divergence (as in the JAX package): the reference's -z matvec
face weight reads ``wz[x,y,z+1]`` instead of ``wz[x,y,z]``
(DensityCGSolver3D.py:184); fixed by default, ``wz_bug=True``
reproduces it.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Sequence, Tuple

import torch

from portbench.reference.ops.fractions import edge_in_fraction
from portbench.reference.ops.indexing import (
    const,
    dual_sample,
    interior_mask,
    sample,
    shift,
)
from portbench.reference.ops.scatter import (
    fold_scattered_sep,
    segment_broadcast_sorted,
    segment_reduce_cf,
    unsort_rows,
)
from portbench.reference.ops.transfers import (
    _corner_setup,
    _corner_weight,
    _flat_index,
    _weight_cols,
    corner_table,
    make_sort_info,
)
from portbench.reference.solvers.cg import SolveStats
from portbench.reference.solvers.pressure import (
    _ghost_frac,
    _offset,
    solve_cell_poisson,
)


def _face_bias(a, d):
    b = [0.5] * d
    b[a] = 0.0
    return tuple(b)


def scatter_mass_volume(px, pm, pvol, gres, bound_min, cell_size, with_sort_info=False, sort_info=None):
    """Cell-center trilinear scatter of particle mass and volume
    (reference initialize_density_kernel, DensityCGSolver3D.py:8-36).

    The sort key is the bias-0 home cell b0: the center-biased home is
    b0 - {0,1} per axis, so the 2^d corners land in b0 + {-1,0,1} and
    the channels widen to 3^d with exact (zero) weights on the
    inapplicable offsets.
    """
    d = px.shape[-1]
    if sort_info is None:
        sort_info = make_sort_info(px, pm, gres, bound_min, cell_size)
    sorted_ids, order, ext, px_s = sort_info
    pm_s = pm[order]
    gi0_s, _, _ = _corner_setup(px_s, bound_min, cell_size, (0.0,) * d)
    gi_c, _, w = _corner_setup(px_s, bound_min, cell_size, (0.5,) * d)
    delta = gi_c - gi0_s
    corners = list(itertools.product((-1, 0, 1), repeat=d))
    pv = pvol * (pm_s > 0)  # zero-mass particles are padding
    weight = None
    for dd in range(d):
        wd, _ = _weight_cols(corners, delta, w, dd)
        weight = wd if weight is None else weight * wd
    # interleave [m0, v0, m1, v1, ...] per corner
    vals = torch.stack([weight * pm_s[:, None], weight * pv[:, None]], dim=-1).reshape(px.shape[0], -1)
    size = 1
    for s in ext:
        size *= s
    seg_cf = segment_reduce_cf(vals, sorted_ids, size, ext)
    gm = fold_scattered_sep(seg_cf[0::2], [(-2, -1, 0)] * d, tuple(gres), "add", 0.0)
    gvol = fold_scattered_sep(seg_cf[1::2], [(-2, -1, 0)] * d, tuple(gres), "add", 0.0)
    if with_sort_info:
        return gm, gvol, sort_info
    return gm, gvol


def _nonsolid_frac(w_faces, shape):
    d = len(shape)
    acc = torch.zeros(shape, dtype=w_faces[0].dtype, device=w_faces[0].device)
    for a in range(d):
        for side in (+1, -1):
            off = [0] * d
            if side > 0:
                off[a] = 1
            acc = acc + sample(w_faces[a], tuple(off), shape, 0.0)
    return acc / (2.0 * d)


def fix_volume(gvol, sphi, lphi, w_faces, cell_size):
    """Clamp the scattered cell volume (fix_volume_kernel,
    DensityCGSolver3D.py:38-84): interior fluid cells away from solids
    count as full; every cell is clamped by cell_vol * non-solid
    fraction."""
    shape = tuple(lphi.shape)
    d = len(shape)
    cvol = 1.0
    for c in cell_size:
        cvol *= c
    dx = min(cell_size)
    near_solid = dual_sample(sphi, (1,) * d, (0,) * d, shape, 1e9) < dx
    fluid_internal = lphi < 0
    for a in range(d):
        for side in (+1, -1):
            fluid_internal = fluid_internal & (shift(lphi, _offset(d, a, side), 1.0) < 0)
    fluid_vol = torch.where(fluid_internal & ~near_solid, cvol, gvol)
    new = torch.minimum(fluid_vol, cvol * _nonsolid_frac(w_faces, shape))
    return torch.where(interior_mask(shape, device=lphi.device), new, gvol)


def density_rhs(rho0, dt, gm, gvol, lphi, w_faces, cell_size):
    """b = (1 - clamp(rho_frac, 0.5, 1.5)) / dt with solid-mass
    imputation (initialize_solver_kernel, DensityCGSolver3D.py:86-115)."""
    shape = tuple(lphi.shape)
    cvol = 1.0
    for c in cell_size:
        cvol *= c
    solid_vol = (1.0 - _nonsolid_frac(w_faces, shape)) * cvol
    cell_mass = gm + rho0 * solid_vol
    cell_vol = gvol + solid_vol
    density_frac = cell_mass / torch.clamp(cell_vol, min=1e-10) / rho0
    density_frac = torch.where(cell_mass < 1e-10, 1.0, density_frac)
    density_frac = torch.clamp(density_frac, 0.5, 1.5)
    b = (1.0 - density_frac) / dt
    active = interior_mask(shape, device=lphi.device) & (lphi < 0)
    return torch.where(active, b, 0.0)


def _density_w(w_faces, a, side, shape, wz_bug):
    """Face weight of the (a, side) neighbour; the bug reads
    wz[x,y,z+1] for the -z face."""
    woff = [0] * len(shape)
    if side > 0 or (wz_bug and len(shape) == 3 and a == 2):
        woff[a] = 1
    return sample(w_faces[a], tuple(woff), shape, 0.0)


def density_coefficients(w_faces, lphi, wz_bug: bool = False):
    """Coefficient fields of the density matvec (matvecmul_kernel,
    DensityCGSolver3D.py:117-194): off-diagonals use the face weight w,
    the diagonal accumulates 1 (or 1/frac) unweighted.  Returns
    (diag, [(off, coef)], precond_diag)."""
    shape = tuple(lphi.shape)
    d = len(shape)
    active = interior_mask(shape, device=lphi.device) & (lphi < 0)
    diag = torch.zeros(shape, dtype=lphi.dtype, device=lphi.device)
    coefs = []
    for a in range(d):
        for side in (+1, -1):
            off = _offset(d, a, side)
            nphi = shift(lphi, off, 1.0)
            w = _density_w(w_faces, a, side, shape, wz_bug)
            fluid_n = nphi < 0
            frac = _ghost_frac(lphi, nphi)
            diag = diag + torch.where(fluid_n, 1.0, 1.0 / frac)
            coefs.append((off, torch.where(active & fluid_n, -w, 0.0)))
    diag = torch.where(active, diag, 0.0)
    precond_diag = torch.where(active & (diag > 0), diag, 1.0)
    return diag, coefs, precond_diag


def compute_displacement(p, lphi, dt, cell_size, face_shapes) -> Tuple[torch.Tensor, ...]:
    """Face displacement (p[i] - p[i-1]) dt h_a / theta_ghost on every
    face with axis index in [1, gres-1] (compute_displacement_kernel,
    DensityCGSolver3D.py:196-209)."""
    gres = tuple(lphi.shape)
    d = len(gres)
    out = []
    for a in range(d):
        fshape = tuple(face_shapes[a])
        off_m = _offset(d, a, -1)
        phi_c = sample(lphi, (0,) * d, fshape, 1.0)
        phi_m = sample(lphi, off_m, fshape, 1.0)
        theta = torch.clamp(edge_in_fraction(phi_c, phi_m), 0.01, 1.0)
        p_c = sample(p, (0,) * d, fshape, 0.0)
        p_m = sample(p, off_m, fshape, 0.0)
        disp = (p_c - p_m) * dt * cell_size[a] / theta
        active = interior_mask(fshape, active_hi=gres, device=lphi.device)
        out.append(torch.where(active, disp, 0.0))
    return tuple(out)


def apply_displacement(px, disp_faces, bound_min, cell_size) -> torch.Tensor:
    """Gather the face displacement fields onto particle positions
    (reference apply_displacement_kernel, DensityCGSolver3D.py:211-238;
    JAX ``apply_displacement``): plain gathers, each corner index clamped
    to the *face array* dims (``shape - 1``), unlike P2G, which clamps
    to the base resolution.  Returns the moved positions."""
    d = px.shape[-1]
    moved = []
    for a in range(d):
        arr = disp_faces[a]
        gi, _, w = _corner_setup(px, bound_min, cell_size, _face_bias(a, d))
        hi = const(tuple(int(n) - 1 for n in arr.shape), torch.int32, px.device)
        flat = arr.reshape(-1)
        acc = torch.zeros(px.shape[0], dtype=px.dtype, device=px.device)
        for offs in itertools.product((0, 1), repeat=d):
            corner = torch.minimum(torch.clamp(gi + const(tuple(offs), torch.int32, px.device), min=0), hi)
            acc = acc + _corner_weight(w, offs) * flat[_flat_index(corner, arr.shape)]
        moved.append(px[:, a] + acc)
    return torch.stack(moved, dim=-1)


def apply_displacement_all(disp_faces, sort_info, bound_min, cell_size) -> torch.Tensor:
    """Per-particle displacement (apply_displacement_kernel,
    DensityCGSolver3D.py:211-238) by segment broadcast over the scatter's
    cell sort.  The gather clamps to the face array dims
    (:232-234), unlike G2P.  Returns the (K, d) displacement in original
    particle order."""
    px_s = sort_info.px_sorted
    d = px_s.shape[-1]
    offs_lists = [
        list(itertools.product(*[(0, 1) if k == a else (-1, 0, 1) for k in range(d)]))
        for a in range(d)
    ]
    table = corner_table(disp_faces, offs_lists, sort_info.ext)
    vals = segment_broadcast_sorted(table, sort_info.sorted_ids)
    gi_0, _, _ = _corner_setup(px_s, bound_min, cell_size, (0.0,) * d)
    outs = []
    col = 0
    for a in range(d):
        gi_a, _, w_a = _corner_setup(px_s, bound_min, cell_size, _face_bias(a, d))
        delta = gi_a - gi_0
        C = len(offs_lists[a])
        v_a = vals[:, col : col + C]
        col += C
        weight = None
        for dd in range(d):
            wd, _ = _weight_cols(offs_lists[a], delta, w_a, dd)
            weight = wd if weight is None else weight * wd
        outs.append(torch.sum(weight * v_a, dim=-1))
    return unsort_rows(torch.stack(outs, dim=-1), sort_info.order)


class DensityResult(NamedTuple):
    px: torch.Tensor
    stats: SolveStats


def density_solve_3d(
    rho0: float, dt, px, pm, pvol: float, sphi, lphi, w_faces,
    bound_min: Sequence[float], cell_size: Sequence[float], *,
    tol: float = 1e-3, rel_tol: float = 1e-6, max_iter: int = 2000,
    wz_bug: bool = False, sort_info=None, precond: str = "jacobi", mg_opts=None, jacobi_precond: bool = True,
    mesh=None, bucket=None, probe=None,
) -> DensityResult:
    """Full density projection; returns moved particle positions
    (DensityCGSolver3D.solve :312-350, initial guess x = 0).
    ``sort_info`` shares an existing bias-0 cell sort of `px`;
    ``precond`` / ``mg_opts`` / ``jacobi_precond`` pick the solve, and
    ``mesh`` runs it distributed (`solve_cell_poisson`); the scatter and
    the displacement run on the particles' device.  ``bucket=(mesh,
    BucketSpec)`` takes the shard-local scatter and displacement gather
    of bucketed particles (``parallel/particles.py``; with a
    ``BucketSpec2D``, ``parallel/particles2d.py``) instead."""
    gres = tuple(lphi.shape)
    d = len(gres)
    if bucket is not None:
        raise NotImplementedError("the frozen reference runs no bucketed particles")
    else:
        gm, gvol, sort_info = scatter_mass_volume(
            px, pm, pvol, gres, bound_min, cell_size, with_sort_info=True, sort_info=sort_info,
        )
    gvol = fix_volume(gvol, sphi, lphi, w_faces, cell_size)
    b = density_rhs(rho0, dt, gm, gvol, lphi, w_faces, cell_size)
    x, stats = solve_cell_poisson(
        b, density_coefficients(w_faces, lphi, wz_bug), tol=tol, rel_tol=rel_tol, max_iter=max_iter,
        precond=precond, mg_opts=mg_opts, jacobi_precond=jacobi_precond, mesh=mesh, probe=probe,
    )
    face_shapes = [tuple(n + (1 if i == a else 0) for i, n in enumerate(gres)) for a in range(d)]
    disp = compute_displacement(x, lphi, dt, cell_size, face_shapes)
    return DensityResult(px + apply_displacement_all(disp, sort_info, bound_min, cell_size), stats)


def fix_volume_2d(lvol, sphi, lphi, w_faces, cell_size, gvol0):
    """The 2D cell volume (fix_volume_kernel, DensityCGSolver2D.py:36-57):
    the 9-point weighted sum of the dual-lattice fluid volume ``lvol``
    about each cell center (a raw array or its parity-class dict), full
    in interior fluid cells away from solids, clamped by cell_vol * the
    non-solid fraction; ``gvol0`` outside the interior."""
    shape = tuple(lphi.shape)
    cvol = cell_size[0] * cell_size[1]
    dx = min(cell_size)

    def lv(i, j):
        return dual_sample(lvol, (1, 1), (i, j), shape, 0.0)

    fluid_vol = (
        lv(0, 0)
        + 0.5 * (lv(1, 0) + lv(-1, 0) + lv(0, 1) + lv(0, -1))
        + 0.25 * (lv(1, 1) + lv(-1, 1) + lv(1, -1) + lv(-1, -1))
    )
    near_solid = dual_sample(sphi, (1, 1), (0, 0), shape, 1e9) < dx
    fluid_internal = lphi < 0
    for a in range(2):
        for side in (+1, -1):
            fluid_internal = fluid_internal & (shift(lphi, _offset(2, a, side), 1.0) < 0)
    fluid_vol = torch.where(fluid_internal & ~near_solid, cvol, fluid_vol)
    new = torch.minimum(fluid_vol, cvol * _nonsolid_frac(w_faces, shape))
    return torch.where(interior_mask(shape, device=lphi.device), new, gvol0)


def density_solve_2d(
    rho0: float, dt, px, pm, pvol: float, sphi, lphi, lvol, w_faces,
    bound_min: Sequence[float], cell_size: Sequence[float], *,
    tol: float = 1e-3, rel_tol: float = 1e-6, max_iter: int = 2000, jacobi_precond: bool = True,
) -> DensityResult:
    """The 2D density projection (DensityCGSolver2D.solve :262-295): the
    mass scatter, `fix_volume_2d`, the RHS, the CG solve from x = 0 and
    the plain displacement gather; returns the moved positions."""
    gres = tuple(lphi.shape)
    gm, _ = scatter_mass_volume(px, pm, 0.0, gres, bound_min, cell_size)
    gvol = fix_volume_2d(lvol, sphi, lphi, w_faces, cell_size, torch.zeros_like(gm))
    b = density_rhs(rho0, dt, gm, gvol, lphi, w_faces, cell_size)
    x, stats = solve_cell_poisson(b, density_coefficients(w_faces, lphi), tol=tol, rel_tol=rel_tol,
                                  max_iter=max_iter, jacobi_precond=jacobi_precond)
    face_shapes = [tuple(n + (1 if i == a else 0) for i, n in enumerate(gres)) for a in range(2)]
    disp = compute_displacement(x, lphi, dt, cell_size, face_shapes)
    return DensityResult(apply_displacement(px, disp, bound_min, cell_size), stats)
