"""[Frozen copy of ``python_fluid_simulation_tpu_torch/solvers/pressure.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Variational cut-cell pressure projection (3D), matrix-free.

Counterpart of ``python_fluid_simulation_tpu.solvers.pressure`` (the
reference's ``solver/PressureCGSolver3D.py``): the 7-point ghost-fluid
system, its RHS and the velocity update are PyTorch stencils (shifts +
where).  The solve takes the configured preconditioner: 'jacobi' is the
Poisson PCG kernel (``ops/cuda_stencils.py``: `cell_poisson_pcg`, or
above `FUSED_POISSON_CELLS` cells `fused_poisson_pcg`, the two JAX
routes), 'mg' the generic CG
(``solvers/cg.py``) over the 7-point matvec kernel with the multigrid
V-cycle (``solvers/multigrid.py``) as preconditioner, and 'jacobi' with
``jacobi_precond=False`` the same CG with no preconditioner.  The
generic CG tests its exit on the host once per iteration, as the JAX
package's ``while_loop`` does.  ``dt_scale`` solves the uniformly scaled
system (s A) x = s b of the JAX package's dt-scaled assembly.

Solution convention matches the reference: x = -pressure * dt / (rho V)
(PressureCGSolver3D.py:225).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from portbench.reference.ops.cuda_cg import squared_tols
from portbench.reference.ops.cuda_stencils import (
    cell_poisson_pcg,
    fused_poisson_pcg,
    poisson_live_cells_plain,
    stencil_matvec,
    stencil_matvec_plain,
)
from portbench.reference.ops.fractions import edge_in_fraction
from portbench.reference.ops.indexing import (
    dual_sample,
    face_parity,
    interior_mask,
    sample,
    shift,
)
from portbench.reference.solvers.cg import SolveStats, cg
from portbench.reference.solvers.multigrid import make_mg_preconditioner

# Jacobi solves of more cells take the `fused_poisson_pcg` route, fewer
# the `cell_poisson_pcg` route, mirroring the JAX package's two routes:
# its blocked (make_fused_poisson_cg) and its VMEM (make_stencil_cg)
# kernel.  Both routes launch one kernel (csrc/poisson_pcg.cu) with a
# null x0 and run Jacobi-PCG from x0 = 0; they differ only in how the
# tolerances are rounded (fused: f32(rel^2), as the blocked TPU solve
# loop; cell: f32(rel)^2, as make_stencil_cg).  The gate is kept for
# that alone and has no speed basis.  The JAX package chooses by whether
# the system fits in VMEM, so its boundary differs from this one.
FUSED_POISSON_CELLS = 3_000_000

_GHOST_CLIP = (0.01, 1.0)  # frac = clamp(phi/(phi-nphi), 0.01, 1)


def _ghost_frac(phi, nphi):
    denom = phi - nphi
    safe = torch.where(denom == 0, 1.0, denom)
    return torch.clamp(phi / safe, *_GHOST_CLIP)


def _sv_component(sv, a):
    """sv is the raw (dual..., d) array or a per-component tuple of
    parity-class dicts."""
    return sv[a] if isinstance(sv, (list, tuple)) else sv[..., a]


def _face_w_v(arr, axis, side, cell_shape):
    """Face-array value seen from cells: side=+1 the high face (idx+1),
    side=-1 the low face (idx)."""
    off = [0] * len(cell_shape)
    if side > 0:
        off[axis] = 1
    return sample(arr, tuple(off), cell_shape, 0.0)


def _offset(d, a, side):
    off = [0] * d
    off[a] = side
    return tuple(off)


def pressure_rhs_3d(v_faces, sv, lphi, w_faces, cell_size) -> torch.Tensor:
    """Divergence RHS with solid-velocity flux correction.

    Reference: initialize_solver_kernel (PressureCGSolver3D.py:6-50).
    """
    shape = tuple(lphi.shape)
    d = len(shape)
    b = torch.zeros(shape, dtype=v_faces[0].dtype, device=lphi.device)
    for a in range(d):
        h = cell_size[a]
        for side in (+1, -1):
            w = _face_w_v(w_faces[a], a, side, shape)
            v = _face_w_v(v_faces[a], a, side, shape)
            sgn = 1.0 if side > 0 else -1.0
            b = b + sgn * w * v / h
            svf = dual_sample(_sv_component(sv, a), (1,) * d, _offset(d, a, side), shape, 0.0)
            b = b - torch.where(w < 1, sgn * w * svf / h, 0.0)
    active = interior_mask(shape, device=lphi.device) & (lphi < 0)
    return torch.where(active, b, 0.0)


def pressure_coefficients(w_faces, lphi, unit_diag_weight: bool = False):
    """Loop-invariant stencil coefficient fields: (diag, [(off, coef)],
    precond_diag), coefficient offsets in the order +x, -x, +y, -y, +z, -z.
    The diagonal accumulates w (or w/frac at a ghost-fluid face); with
    ``unit_diag_weight`` 1 (or 1/frac)."""
    shape = tuple(lphi.shape)
    d = len(shape)
    active = interior_mask(shape, device=lphi.device) & (lphi < 0)
    diag = torch.zeros(shape, dtype=lphi.dtype, device=lphi.device)
    coefs = []
    for a in range(d):
        for side in (+1, -1):
            off = _offset(d, a, side)
            nphi = shift(lphi, off, 1.0)
            w = _face_w_v(w_faces[a], a, side, shape)
            fluid_n = nphi < 0
            frac = _ghost_frac(lphi, nphi)
            dw = torch.ones_like(w) if unit_diag_weight else w
            diag = diag + torch.where(fluid_n, dw, dw / frac)
            coefs.append((off, torch.where(active & fluid_n, -w, 0.0)))
    diag = torch.where(active, diag, 0.0)
    precond_diag = torch.where(active & (diag > 0), diag, 1.0)
    return diag, coefs, precond_diag


def prepare_stencil_matvec(coefficients):
    """(matvec, precond_diag) of a 7-point system (diag, [(off, coef)],
    precond_diag): matvec is `stencil_matvec` on its fields."""
    diag, coefs, precond_diag = coefficients
    return (lambda p: stencil_matvec(diag, coefs, p)), precond_diag


def apply_pressure_3d(v_faces, p, w_faces, sv, lphi, cell_size) -> Tuple[torch.Tensor, ...]:
    """Velocity update v += grad(x) h / theta with solid-velocity blending.

    Reference: apply_pressure_kernel (PressureCGSolver3D.py:132-153);
    the trailing face plane (index gres) is never updated (:135).
    """
    gres = tuple(lphi.shape)
    d = len(gres)
    out = []
    for a in range(d):
        fshape = tuple(v_faces[a].shape)
        off_m = _offset(d, a, -1)
        phi_c = sample(lphi, (0,) * d, fshape, 1.0)
        phi_m = sample(lphi, off_m, fshape, 1.0)
        p_c = sample(p, (0,) * d, fshape, 0.0)
        p_m = sample(p, off_m, fshape, 0.0)
        theta = torch.clamp(edge_in_fraction(phi_c, phi_m), *_GHOST_CLIP)
        new_v = v_faces[a] + (p_c - p_m) * cell_size[a] / theta
        w = w_faces[a]
        svf = dual_sample(_sv_component(sv, a), face_parity(a, d), (0,) * d, fshape, 0.0)
        blended = w * new_v + (1.0 - w) * svf
        active = interior_mask(fshape, active_hi=gres, device=lphi.device) & ((phi_c < 0) | (phi_m < 0))
        out.append(torch.where(active, blended, v_faces[a]))
    return tuple(out)


def solve_cell_poisson(b, coefficients, *, tol: float, rel_tol: float, max_iter: int,
                       precond: str = "jacobi", mg_opts=None, jacobi_precond: bool = True, dt_scale=None,
                       mesh=None, probe=None):
    """PCG solve of a cell-centred ghost-fluid system (pressure or
    density) from x0 = 0.

    ``coefficients`` is (diag, [(off, coef)], precond_diag) from
    `pressure_coefficients` or ``density.density_coefficients``.
    ``precond`` 'jacobi' runs the Poisson PCG kernel on the
    `cell_poisson_pcg` route, or above `FUSED_POISSON_CELLS` cells on the
    `fused_poisson_pcg` route; with
    ``jacobi_precond=False`` CG over `stencil_matvec` with no
    preconditioner.  'mg' (which ignores ``jacobi_precond``, as the JAX
    package does) runs CG with a V-cycle preconditioner shaped by
    ``mg_opts`` = (n_smooth, min_dim, coarse_iters) (None: 2, 4, 24).
    ``dt_scale`` = s solves (s A) x = s b: the Jacobi kernels take the
    scaled fields, the generic CG the operator s A and, for 'mg', the
    preconditioner mg(r) / s (JAX ``pressure.py:379-470``).
    ``probe`` = (dict, key): the Jacobi route puts its system's live
    cells (`poisson_live_cells_plain`) under that key.
    A 2D system (the 2D engine's pressure and density) is the generic CG
    over the plain 5-point matvec (`stencil_matvec_plain`), Jacobi or
    unpreconditioned: the JAX package takes its kernels for ``d == 3``
    only (``pressure.py:226``, ``:355``, ``:412``) and solves in 2D in XLA.
    Returns (x, SolveStats).
    """
    diag, coefs, precond_diag = coefficients
    s = dt_scale
    if precond not in ("jacobi", "mg"):
        raise ValueError(f"unknown cell-Poisson preconditioner {precond!r}")
    if b.ndim != 3:
        # the dimension gate of JAX pressure.py:226 / :355 / :412
        if mesh is not None or precond != "jacobi":
            raise NotImplementedError("a 2D cell solve takes the Jacobi preconditioner (or none) and no mesh")

        def matvec2(v):
            q = stencil_matvec_plain(diag, coefs, v[0])
            return (q if s is None else s * q,)

        pd2 = precond_diag if s is None else s * precond_diag
        tol2, rel2 = squared_tols(tol, rel_tol)
        (x,), stats, _, _ = cg(matvec2, (b if s is None else s * b,), (torch.zeros_like(b),), tol2=tol2, rel2=rel2,
                               max_iter=max_iter, precond=(lambda r: (r[0] / pd2,)) if jacobi_precond else None)
        return x, stats
    if mesh is not None:
        raise NotImplementedError("the frozen reference runs no mesh")
    if precond == "jacobi" and jacobi_precond:
        if s is not None:
            b, diag, precond_diag = s * b, s * diag, s * precond_diag
            coefs = [(off, s * c) for off, c in coefs]
        kw = dict(tol=tol, rel_tol=rel_tol, max_iter=max_iter)
        if probe is not None:
            probe[0][probe[1]] = int(poisson_live_cells_plain(b, None, diag, coefs).numel())
        if b.numel() > FUSED_POISSON_CELLS:
            x, iters, res, res0, thresh = fused_poisson_pcg(b, None, diag, coefs, precond_diag, **kw)
        else:
            x, iters, res, res0, thresh = cell_poisson_pcg(b, diag, coefs, precond_diag, **kw)
        return x, SolveStats(iters=iters, residual=res, initial_residual=res0, converged=res < thresh)
    mv, _ = prepare_stencil_matvec(coefficients)
    if s is None:
        def matvec(v):
            return (mv(v[0]),)
    else:
        b = s * b

        def matvec(v):
            return (s * mv(v[0]),)
    pre = None
    if precond == "mg":
        kw = {}
        if mg_opts is not None:
            kw = dict(n_smooth=int(mg_opts[0]), min_dim=int(mg_opts[1]), coarse_iters=int(mg_opts[2]))
        mg = make_mg_preconditioner(diag, coefs, **kw)

        def pre(r):
            return (mg(r[0]),) if s is None else (mg(r[0]) / s,)
    # the JAX package's generic cg rounds tol^2 in fp32 and rel_tol^2 in
    # double before the fp32 product
    tol2, rel2 = squared_tols(tol, rel_tol)
    (x,), stats, _, _ = cg(matvec, (b,), (torch.zeros_like(b),), tol2=tol2, rel2=rel2, max_iter=max_iter, precond=pre)
    return x, stats


class PressureResult(NamedTuple):
    v_faces: Tuple[torch.Tensor, ...]
    pressure: torch.Tensor  # x = -p dt/(rho Vcell)
    stats: SolveStats


def pressure_solve_3d(
    v_faces: Sequence[torch.Tensor], sv, lphi, w_faces, cell_size, *,
    tol: float = 1e-3, rel_tol: float = 1e-6, max_iter: int = 2000,
    precond: str = "jacobi", mg_opts=None, jacobi_precond: bool = True, dt_scale=None, mesh=None, probe=None,
) -> PressureResult:
    """Full projection: RHS -> PCG -> apply (PressureCGSolver3D.solve
    :192-226, initial guess x = 0); ``dt_scale`` scales both sides of the
    system (the solution is the same after unscaling); ``mesh`` runs the
    solve distributed (`solve_cell_poisson`)."""
    b = pressure_rhs_3d(v_faces, sv, lphi, w_faces, cell_size)
    x, stats = solve_cell_poisson(
        b, pressure_coefficients(w_faces, lphi), tol=tol, rel_tol=rel_tol, max_iter=max_iter,
        precond=precond, mg_opts=mg_opts, jacobi_precond=jacobi_precond, dt_scale=dt_scale, mesh=mesh, probe=probe,
    )
    return PressureResult(apply_pressure_3d(v_faces, x, w_faces, sv, lphi, cell_size), x, stats)


