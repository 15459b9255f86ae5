"""[Frozen copy of ``python_fluid_simulation_tpu_torch/solvers/viscosity.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Variational implicit viscosity (3D): the coupled (vx, vy, vz) solve.

Counterpart of ``python_fluid_simulation_tpu.solvers.viscosity`` (the
reference's ``solver/ViscosityCGSolver3D.py``): per axis 6 same-field +
8 cross-field couplings, with control volumes sampled from the
dual-lattice fluid-volume field.  The three per-axis operators come from
ONE term table exploiting the operator's cyclic symmetry; in
dual-lattice offsets from a face site (e_k = one dual step along axis k):

  diag  = vol(0) + s*( 2*vol(+e_a) + 2*vol(-e_a) + sum_{t!=a} vol(+e_t)+vol(-e_t) )
  same-field a-dir:  cond +-2e_a  -> -2s*vol(+-e_a)*v_a(+-1_a)
  same-field t-dir:  cond +-2e_t  -> -s*vol(+-e_t)*v_a(+-1_t)
  cross-field t, hi: cond  e_a+e_t -> -s*vol(+e_t)*v_t(+1_t)
                     cond -e_a+e_t -> +s*vol(+e_t)*v_t(+1_t,-1_a)
  cross-field t, lo: cond  e_a-e_t -> +s*vol(-e_t)*v_t(0)
                     cond -e_a-e_t -> -s*vol(-e_t)*v_t(-1_a)

The matvec couples where the neighbour face site is fluid (sphi >= 0 in
3D); the RHS moves solid (Dirichlet) neighbour contributions to b,
evaluated on velocities first extrapolated 3 Jacobi layers into the
solid (solve :573).  scale = dt/(cell_vol*rho); vol = lvol/(cell_vol/8)
(solve :567-568).  The Jacobi-PCG solve is the coupled kernel
(``ops/cuda_cg.py``), which rebuilds the couplings from the geometry; the
MG-PCG solve is CG over the geometry-recompute matvec (``ops/cuda_cg.py::
coupled_matvec_geom``) with the batched block V-cycle of
``solvers/multigrid.py`` (above `MG_FACE_CELLS` face cells the lean
two-grid cycle, whose fine level is the same-axis geometry matvec).
With ``jacobi_precond=False`` the non-MG solves are CG over the
materialised matvec (`prepare_viscosity_matvec`, ``ops/cuda_stencils.py::
coupled_stencil_matvec``), as in the JAX package.  The JAX package's
axis permutations (``_PERM_CANDIDATES``) lay tall grids out for the
TPU's VMEM and have no counterpart here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch

from portbench.reference.ops.cuda_cg import coupled_matvec_geom, coupled_visc_pcg, flat_geometry, squared_tols
from portbench.reference.ops.cuda_stencils import (
    coupled_stencil_matvec,
    coupled_stencil_matvec_plain,
)
from portbench.reference.ops.extrapolate import extrapolate
from portbench.reference.ops.indexing import (
    dual_sample,
    face_parity,
    interior_mask,
    sample,
    split_parity,
)
from portbench.reference.solvers.cg import SolveStats, cg
from portbench.reference.solvers.multigrid import (
    _coarsen,
    _prolong,
    _restrict,
    make_batched_mg_preconditioner,
)


def _terms_for_axis(a: int, d: int = 3):
    """(cond_dual_offset, field, v_face_offset, vol_dual_offset, factor, sign)

    sign/factor are the MATVEC convention: val += sign*factor*s*vol*v.
    The RHS uses -sign with the solid-side condition.
    """
    terms = []

    def e(k, n=1):
        v = [0] * d
        v[k] = n
        return tuple(v)

    def plus(u, v):
        return tuple(x + y for x, y in zip(u, v))

    def neg(u):
        return tuple(-x for x in u)

    # same-field, face-axis direction (factor 2)
    for sgn in (+1, -1):
        terms.append((e(a, 2 * sgn), a, e(a, sgn), e(a, sgn), 2.0, -1.0))
    # same-field, transverse directions
    for t in range(d):
        if t == a:
            continue
        for sgn in (+1, -1):
            terms.append((e(t, 2 * sgn), a, e(t, sgn), e(t, sgn), 1.0, -1.0))
    # cross-field couplings
    for t in range(d):
        if t == a:
            continue
        ea, et = e(a), e(t)
        # hi side (+e_t volume)
        terms.append((plus(ea, et), t, et, et, 1.0, -1.0))
        terms.append((plus(neg(ea), et), t, plus(et, neg(ea)), et, 1.0, +1.0))
        # lo side (-e_t volume)
        terms.append((plus(ea, neg(et)), t, (0,) * d, neg(et), 1.0, +1.0))
        terms.append((plus(neg(ea), neg(et)), t, neg(ea), neg(et), 1.0, -1.0))
    return terms


def _is_fluid(sphi_vals, strict: bool = False):
    """3D convention: fluid = sphi >= 0 (ViscosityCGSolver3D.py:272);
    2D (``strict``): fluid = sphi > 0 (ViscosityCGSolver2D.py:129), so a
    face site with sphi == 0 is solid there."""
    return sphi_vals > 0 if strict else sphi_vals >= 0


def _active(a, sphi, shape, strict: bool = False):
    d = len(shape)
    sph0 = dual_sample(sphi, face_parity(a, d), (0,) * d, shape, -1.0)
    return interior_mask(shape, device=sph0.device) & _is_fluid(sph0, strict)


def _diag_axis(a, s_mu, vol, shape):
    d = len(shape)
    p = face_parity(a, d)
    acc = dual_sample(vol, p, (0,) * d, shape, 0.0)
    extra = torch.zeros(shape, dtype=acc.dtype, device=acc.device)
    for k in range(d):
        factor = 2.0 if k == a else 1.0
        for sgn in (+1, -1):
            off = [0] * d
            off[k] = sgn
            extra = extra + factor * dual_sample(vol, p, tuple(off), shape, 0.0)
    return acc + s_mu * extra


def _neighbour_interior(shape, voff, device):
    """interior_mask of the site at f + voff, as a mask over f."""
    m = None
    for j, n in enumerate(shape):
        idx = torch.arange(n, device=device) + voff[j]
        bshape = [1] * len(shape)
        bshape[j] = n
        mj = ((idx >= 1) & (idx < n - 1)).reshape(bshape)
        m = mj if m is None else (m & mj)
    return m


def _axis_system(a, s_mu, sphi, vol, shape, same_axis_only=False, symmetrize=False, strict=False):
    """Face axis a's rows: (diag, [(field, voff, coef)], pdiag, active) in
    `_terms_for_axis` order, only the 6 same-field couplings with
    ``same_axis_only``; ``symmetrize`` also masks each coupling with the
    neighbour's interior test (see `viscosity_axis_block_stencil`);
    ``strict`` is the 2D fluid test (`_is_fluid`)."""
    d = len(shape)
    p = face_parity(a, d)
    active = _active(a, sphi, shape, strict)
    diag_raw = _diag_axis(a, s_mu, vol, shape)
    terms = []
    for cond_off, field, voff, vol_off, factor, sign in _terms_for_axis(a, d):
        if same_axis_only and field != a:
            continue
        mask = active & _is_fluid(dual_sample(sphi, p, cond_off, shape, -1.0), strict)
        if symmetrize:
            mask = mask & _neighbour_interior(shape, voff, active.device)
        vcoef = dual_sample(vol, p, vol_off, shape, 0.0)
        terms.append((field, voff, torch.where(mask, sign * factor * s_mu * vcoef, 0.0)))
    diag = torch.where(active, diag_raw, 0.0)
    pdiag = torch.where(active & (diag_raw > 0), diag_raw, 1.0)
    return diag, terms, pdiag, active


def viscosity_term_fields(s_mu, sphi, vol, face_shapes, same_axis_only: bool = False, strict_fluid: bool = False):
    """The 14-term coefficient fields per axis (6 in 2D): (diags,
    per_axis, pdiags) where per_axis[a] is a list of (field, voff, coef)
    with coef shaped like face array a.  ``same_axis_only`` builds only
    the 6 same-field terms an axis (what the MG block preconditioner
    reads); ``strict_fluid`` is the 2D fluid test (`_is_fluid`)."""
    diags, per_axis, pdiags = [], [], []
    for a in range(len(face_shapes)):
        diag, terms, pdiag, _ = _axis_system(a, s_mu, sphi, vol, tuple(face_shapes[a]), same_axis_only,
                                             strict=strict_fluid)
        diags.append(diag)
        per_axis.append(terms)
        pdiags.append(pdiag)
    return diags, per_axis, pdiags


def viscosity_axis_block_stencil(a, s_mu, sphi, vol, shape, symmetrize: bool = False):
    """Same-axis 7-point sub-operator of velocity component a: the
    diagonal block the MG preconditioner smooths and Galerkin-coarsens,
    built for one axis at a time (the lean route's transient peak is 7
    fields of one face array).  Bitwise `viscosity_term_fields` filtered
    to ``field == a``.

    ``symmetrize`` also masks each coupling with the neighbour's interior
    test, making the stencil exactly Pi A Pi (Pi = diag(active)): the
    operator the lean cycle smooths on active-supported vectors, so every
    Galerkin level coarsened from it stays symmetric.
    Returns (diag, [(voff, coef)] * 6, pdiag, active)."""
    diag, terms, pdiag, active = _axis_system(a, s_mu, sphi, vol, tuple(shape), True, symmetrize)
    return diag, [(voff, coef) for _, voff, coef in terms], pdiag, active


def viscosity_matvec_3d(v_faces, s_mu, sphi, vol, strict_fluid: bool = False):
    """One application of the coupled operator to (vx, vy, vz) (or the
    2D pair, with ``strict_fluid``)."""
    diags, per_axis, _ = viscosity_term_fields(s_mu, sphi, vol, [v.shape for v in v_faces], strict_fluid=strict_fluid)
    return coupled_stencil_matvec_plain(diags, per_axis, v_faces)


def prepare_viscosity_matvec(s_mu, sphi, vol, face_shapes, fields=None):
    """(matvec, pdiags) from the materialised term fields (``fields``,
    or `viscosity_term_fields` built here); matvec equals
    `viscosity_matvec_3d` and is `coupled_stencil_matvec` on them."""
    diags, per_axis, pdiags = fields or viscosity_term_fields(s_mu, sphi, vol, face_shapes)
    return (lambda vs: coupled_stencil_matvec(diags, per_axis, vs)), tuple(pdiags)


def viscosity_rhs_3d(v_faces, s_mu, sphi, vol, strict_fluid: bool = False):
    """b_a = vol_c*v_a + sum of solid-neighbour Dirichlet terms
    (initialize_solver_{x,y,z}_kernel, :41-246); the input velocities
    must already be extrapolated into the solid (in 3D)."""
    d = len(v_faces)
    out = []
    for a in range(d):
        shape = tuple(v_faces[a].shape)
        p = face_parity(a, d)
        b = dual_sample(vol, p, (0,) * d, shape, 0.0) * v_faces[a]
        for cond_off, field, voff, vol_off, factor, sign in _terms_for_axis(a, d):
            solid_n = ~_is_fluid(dual_sample(sphi, p, cond_off, shape, -1.0), strict_fluid)
            vv = sample(v_faces[field], voff, shape, 0.0)
            vcoef = dual_sample(vol, p, vol_off, shape, 0.0)
            b = b + torch.where(solid_n, -sign * factor * s_mu * vcoef * vv, 0.0)
        out.append(torch.where(_active(a, sphi, shape, strict_fluid), b, 0.0))
    return tuple(out)


def viscosity_diag_3d(s_mu, sphi, vol, face_shapes, strict_fluid: bool = False):
    """Operator diagonal for Jacobi preconditioning (1 where inactive)."""
    out = []
    for a in range(len(face_shapes)):
        shape = tuple(face_shapes[a])
        diag = _diag_axis(a, s_mu, vol, shape)
        out.append(torch.where(_active(a, sphi, shape, strict_fluid) & (diag > 0), diag, 1.0))
    return tuple(out)


def make_viscosity_mg_preconditioner(diags, per_axis):
    """Block-diagonal multigrid preconditioner for the coupled system.

    It drops the cross-field couplings and runs one Galerkin-MG V-cycle
    per axis on the same-field 7-point sub-operator (diagonal blocks of
    an SPD matrix are SPD, and each is exactly the stencil form
    ``solvers/multigrid.py`` coarsens), the three axes batched into ONE
    cycle (one kernel launch a chain for all three).
    """
    systems = []
    for a in range(len(diags)):
        same = [
            (voff, coef) for field, voff, coef in per_axis[a]
            if field == a and sum(abs(o) for o in voff) == 1
        ]
        systems.append((diags[a], same))
    return make_batched_mg_preconditioner(systems)


def make_viscosity_mg_preconditioner_lean(s_mu, sphi, vol, face_shapes, fine_matvec, *, omega: float = 0.8):
    """Two-grid-entry MG preconditioner with no persistent fine-level
    stencil fields: the route above `MG_FACE_CELLS` face cells.

    The fine level is ``fine_matvec``, the same-axis geometry-recompute
    matvec (`coupled_matvec_geom(same_axis_only=True)`), whose operands
    are the geometry the outer solve already holds; the batched Galerkin
    hierarchy (`make_batched_mg_preconditioner`) starts at level 1, built
    from per-axis transient symmetrised fine stencils.  One application,
    in the JAX package's order (a symmetric two-grid cycle, a fixed SPD
    operator inside plain PCG):

      x1 = w r / pd                     (pre-smooth from zero)
      r1 = r - A_blk x1
      e  = Vcycle_1(restrict(r1))
      x2 = x1 + where(active, prolong(e), 0)
      x3 = x2 + w (r - A_blk x2) / pd   (post-smooth)
      z  = where(active, x3, r)
    """
    level1, pdiags, actives = [], [], []
    for a in range(len(face_shapes)):
        diag, coefs, pdiag, active = viscosity_axis_block_stencil(a, s_mu, sphi, vol, face_shapes[a], symmetrize=True)
        level1.append(_coarsen(diag, coefs))
        pdiags.append(pdiag)
        actives.append(active)
    inner = make_batched_mg_preconditioner(level1)

    def precond(rs):
        x1 = tuple(omega * r / pd for r, pd in zip(rs, pdiags))
        r1 = tuple(r - q for r, q in zip(rs, fine_matvec(x1)))
        ec = inner(tuple(_restrict(r, tuple((n + 1) // 2 for n in r.shape)) for r in r1))
        # the prolonged correction masked to active rows keeps every vector
        # active-supported, so the fine matvec acts as Pi A Pi
        x2 = tuple(x + torch.where(act, _prolong(e, tuple(x.shape)), 0.0) for x, e, act in zip(x1, ec, actives))
        x3 = tuple(x + omega * (r - q) / pd for x, r, q, pd in zip(x2, rs, fine_matvec(x2), pdiags))
        return tuple(torch.where(act, x, r) for x, r, act in zip(x3, rs, actives))

    precond.inner = inner
    return precond


class ViscosityResult(NamedTuple):
    v_faces: Tuple[torch.Tensor, ...]
    stats: SolveStats


# Above this many face cells of axis 0 the MG route takes the lean
# two-grid preconditioner (the JAX package's switch, `_mg_solve`): it
# chooses the preconditioner, so it changes the iterates.
MG_FACE_CELLS = 4_000_000


def viscosity_solve_3d(
    dt, mu: float, rho: float, v_faces: Sequence[torch.Tensor], sphi, lvol, cell_vol: float, *,
    tol: float = 1e-3, rel_tol: float = 1e-6, max_iter: int = 2000,
    jacobi_precond: bool = True, precond_kind: str = "jacobi", auto_use_mg=None, warm_start=None, mesh=None,
    extrap_iters: int = 3, strict_fluid: bool = False,
) -> ViscosityResult:
    """Full implicit viscosity solve (ViscosityCGSolver3D.solve :566-613):
    velocities are extrapolated 3 Jacobi layers into the solid (valid =
    sphi >= 0 at face sites), the RHS is built from the extrapolated
    field, PCG runs from the extrapolated field, and the solution is
    written back only at non-solid faces (apply_viscosity_kernel
    :458-470).

    ``precond_kind``: 'jacobi' (the coupled Jacobi-PCG kernel), 'mg' (CG
    over `coupled_matvec_geom` with the batched block V-cycle), or 'auto':
    MG when ``auto_use_mg`` (the engine's hysteresis flag) is true, else
    Jacobi — the flag is read on the host, once a solve.  The MG route
    builds its fields and hierarchy only when it runs.

    ``jacobi_precond=False`` keeps the JAX package's branches
    (``viscosity.py:882-926``): 'mg' and the MG branch of 'auto' ignore
    it; 'jacobi' (and 'auto' without a flag) run CG with no
    preconditioner over the materialised matvec; the Jacobi branch of
    'auto' runs CG over the same matvec WITH the Jacobi preconditioner
    (the JAX package's ``_jacobi_cg`` when no fused solve was built).
    The 45 term fields are built only on those branches.

    ``warm_start`` (face arrays, e.g. the velocities corrected by the
    learned operator's Δv) replaces the PCG's initial guess only: it is
    extrapolated like the velocities, then rescaled along the line from
    the extrapolated field (`rescaled_warm_start`) with the operator the
    branch builds — the geometry matvec (``coupled_matvec_geom``) on the
    Jacobi and MG branches, the materialised one with
    ``jacobi_precond=False``.  The system (RHS, coefficients) is still
    built from ``v_faces``.

    With a ``mesh`` (``parallel/mesh.py``) the solve is the distributed
    Jacobi-PCG over the mesh's blocks of the materialised term fields
    (``parallel/halo.py::distributed_coupled_cg``; pdiags = 1 under
    ``jacobi_precond=False``), taken before 'jacobi', 'mg' or 'auto' as in
    the JAX package (``viscosity.py:636-680``), so ``auto_use_mg`` is not
    read; a warm start there takes the line search over the materialised
    matvec (``coupled_stencil_matvec`` of those fields, rows 7-8).

    ``extrap_iters`` (3 in 3D, 0 in 2D: no pre-extrapolation) and
    ``strict_fluid`` (the 2D fluid test, solid = sphi <= 0) carry the 2D
    reference's conventions (`viscosity_solve_2d`).  A 2D system takes the
    generic CG over the plain coupled matvec (`coupled_stencil_matvec_plain`)
    with the Jacobi preconditioner or none, as the JAX package, whose
    Pallas routes are for ``d == 3`` only (``viscosity.py:497``, ``:696``),
    runs its 2D solve in XLA.

    ``lvol`` may be the raw dual-lattice array or its parity-class dict;
    ``dt`` a float or 0-dim tensor.
    """
    d = len(v_faces)
    dev = v_faces[0].device
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    s_mu = dt / cell_vol / rho * mu
    sphi_c = split_parity(sphi, d)
    vol_c = {k: v / (cell_vol * 0.125) for k, v in split_parity(lvol, d).items()}

    def extrapolated(fields):
        if not extrap_iters:
            return tuple(fields)
        return tuple(extrapolate(fields[a], _is_fluid(sphi_c[face_parity(a, d)], strict_fluid), extrap_iters)[0]
                     for a in range(d))

    ext = extrapolated(v_faces)
    warm = None if warm_start is None else extrapolated(warm_start)
    shapes = [tuple(v.shape) for v in v_faces]
    b = viscosity_rhs_3d(ext, s_mu, sphi_c, vol_c, strict_fluid)

    if precond_kind not in ("jacobi", "mg", "auto"):
        raise ValueError(f"unknown viscosity preconditioner {precond_kind!r}")
    flagged = precond_kind == "auto" and auto_use_mg is not None
    kw = dict(tol=tol, rel_tol=rel_tol, max_iter=max_iter)
    if d != 3:
        # the dimension gate of JAX viscosity.py:497 and :696 (Pallas for
        # d == 3 only): a 2D solve is the generic CG, its matvec plain
        if mesh is not None or warm is not None or precond_kind != "jacobi":
            raise NotImplementedError("a 2D viscosity solve takes the Jacobi preconditioner (or none), no mesh and "
                                      "no warm start")
        diags, per_axis, pdiags = viscosity_term_fields(s_mu, sphi_c, vol_c, shapes, strict_fluid=strict_fluid)
        precond = (lambda rs: tuple(r / p for r, p in zip(rs, pdiags))) if jacobi_precond else None
        tol2, rel2 = squared_tols(tol, rel_tol)
        x, stats, _, _ = cg(lambda vs: coupled_stencil_matvec_plain(diags, per_axis, vs), b, ext,
                            tol2=tol2, rel2=rel2, max_iter=max_iter, precond=precond)
    elif mesh is not None:
        raise NotImplementedError("the frozen reference runs no mesh")
    elif precond_kind == "mg" or (flagged and bool(auto_use_mg)):
        x, stats = _mg_solve(b, ext, s_mu, sphi_c, vol_c, shapes, warm=warm, **kw)
    elif jacobi_precond:
        pdiags = viscosity_diag_3d(s_mu, sphi_c, vol_c, shapes)
        x0 = ext
        if warm is not None:
            geom = flat_geometry(sphi_c, vol_c)
            x0 = rescaled_warm_start(lambda vs: coupled_matvec_geom(sphi_c, vol_c, s_mu, vs, geom=geom), b, ext, warm)[0]
        x, iters, res, res0, thresh, _ = coupled_visc_pcg(b, x0, pdiags, sphi_c, vol_c, s_mu, **kw)
        stats = SolveStats(iters=iters, residual=res, initial_residual=res0, converged=res < thresh)
    else:
        matvec, pdiags = prepare_viscosity_matvec(s_mu, sphi_c, vol_c, shapes)
        # the Jacobi branch of a flagged 'auto' keeps the preconditioner
        precond = (lambda rs: tuple(r / p for r, p in zip(rs, pdiags))) if flagged else None
        tol2, rel2 = squared_tols(tol, rel_tol)  # as the JAX package's generic cg rounds them
        x0 = ext if warm is None else rescaled_warm_start(matvec, b, ext, warm)[0]
        x, stats, _, _ = cg(matvec, b, x0, tol2=tol2, rel2=rel2, max_iter=max_iter, precond=precond)
    out = []
    for a in range(d):
        shape = shapes[a]
        hi = tuple(s - (1 if i == a else 0) for i, s in enumerate(shape))
        active = interior_mask(shape, active_hi=hi, device=dev) & _is_fluid(sphi_c[face_parity(a, d)], strict_fluid)
        out.append(torch.where(active, x[a], v_faces[a]))
    return ViscosityResult(tuple(out), stats)


def rescaled_warm_start(matvec, b, ext, warm):
    """One residual line search along the predicted correction (JAX
    ``viscosity.py:612-630``): x0 = ext + α (warm - ext) with
    α = <b - A ext, A p> / <A p, A p>, p = warm - ext, and α = 0 where
    <A p, A p> = 0.  α minimises the residual on that line, so x0's
    residual is never larger than the extrapolated field's.  Two
    matvecs; the dots in fp32, with no host sync.  Returns (x0, α)."""
    p = tuple(w - e for w, e in zip(warm, ext))
    ap = matvec(p)
    r = tuple(bb - q for bb, q in zip(b, matvec(ext)))
    num = sum(torch.dot(ri.reshape(-1), ai.reshape(-1)) for ri, ai in zip(r, ap))
    den = sum(torch.dot(ai.reshape(-1), ai.reshape(-1)) for ai in ap)
    alpha = torch.where(den > 0, num / torch.clamp(den, min=1e-30), 0.0)
    return tuple(e + alpha * pi for e, pi in zip(ext, p)), alpha


def _mg_solve(b, x0, s_mu, sphi_c, vol_c, shapes, *, tol, rel_tol, max_iter, warm=None):
    """MG-PCG (JAX ``_mg_solve``): the outer operator recomputes its
    coefficients from the geometry (`coupled_matvec_geom`), and with
    ``warm`` the solve starts from `rescaled_warm_start` along it.  Up to
    `MG_FACE_CELLS` face cells of axis 0 the block preconditioner
    coarsens the 21 same-axis fields (3 diagonals, 6 couplings an axis),
    which are all this route builds; above, the lean two-grid
    preconditioner smooths the fine level with the same-axis geometry
    matvec and keeps no fine stencil field."""
    geom = flat_geometry(sphi_c, vol_c)
    if math.prod(shapes[0]) > MG_FACE_CELLS:
        precond = make_viscosity_mg_preconditioner_lean(
            s_mu, sphi_c, vol_c, shapes,
            lambda vs: coupled_matvec_geom(sphi_c, vol_c, s_mu, vs, same_axis_only=True, geom=geom),
        )
    else:
        diags, same, _ = viscosity_term_fields(s_mu, sphi_c, vol_c, shapes, same_axis_only=True)
        precond = make_viscosity_mg_preconditioner(diags, same)
        del diags, same
    # the JAX package's generic cg rounds tol^2 in fp32 and rel_tol^2 in
    # double before the fp32 product
    tol2, rel2 = squared_tols(tol, rel_tol)
    def matvec(vs):
        return coupled_matvec_geom(sphi_c, vol_c, s_mu, vs, geom=geom)

    if warm is not None:
        x0 = rescaled_warm_start(matvec, b, x0, warm)[0]
    x, stats, _, _ = cg(matvec, b, x0, tol2=tol2, rel2=rel2, max_iter=max_iter, precond=precond)
    return x, stats


def viscosity_solve_2d(dt, mu, rho, v_faces, sphi, lvol, cell_vol, *, tol=1e-4, rel_tol=1e-6, max_iter=2000,
                       jacobi_precond=True) -> ViscosityResult:
    """The 2D implicit viscosity solve: `viscosity_solve_3d` with
    ``extrap_iters=0`` and ``strict_fluid=True``."""
    return viscosity_solve_3d(dt, mu, rho, v_faces, sphi, lvol, cell_vol, tol=tol, rel_tol=rel_tol,
                              max_iter=max_iter, jacobi_precond=jacobi_precond, extrap_iters=0, strict_fluid=True)
