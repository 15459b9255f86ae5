"""The time step: ``step_3d(state, cfg) -> (state, metrics)``, plain.

Frozen copy of ``python_fluid_simulation_tpu_torch/engine/step.py::
step_3d`` (see ``FROZEN_FROM.md``) for one device, static solids and the
'apic' viscosity mode: no mesh, no bucketed particles, no learned
operator, no CUDA graph.  Step order follows the reference notebook's
cell 13: dt (CFL) -> advect + SDF project -> sort + level set -> density
solve -> sort + level set again -> merged P2G + fluid-volume classes ->
gravity -> viscosity -> pressure -> extrapolate 2 iters -> boundary
condition -> G2P -> viscosity-preconditioner hysteresis flag.

``low``: where given (a dtype such as ``torch.bfloat16``), the step's
state and the grid velocities between its stages are held in that
precision (rounded to it and back to fp32 at each stage boundary): the
benchmark's control, a step that stores its fields in half the bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from portbench.reference.config import SimConfig
from portbench.reference.ops import sdf as sdf3d
from portbench.reference.ops.boundary import apply_boundary_condition
from portbench.reference.ops.extrapolate import extrapolate
from portbench.reference.ops.fractions import compute_solid_frac_3d
from portbench.reference.ops.indexing import const, rounded_sqrt, split_parity
from portbench.reference.ops.levelset import compute_fluid_levelset
from portbench.reference.ops.transfers import g2p_all, make_sort_info, p2g_all
from portbench.reference.solvers.density import density_solve_3d
from portbench.reference.solvers.pressure import pressure_solve_3d
from portbench.reference.solvers.viscosity import viscosity_solve_3d
from portbench.reference.state import Particles, SimState

_FACE_BIAS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))


@dataclasses.dataclass
class GeomCache:
    """Static solid geometry derived from the solid level set: the 2^3
    parity classes of sphi and sv and the cut-cell face weights.  Build
    it once while the rigid bodies do not move."""

    sphi_c: dict
    sv_c: Tuple[dict, ...]
    w_faces: Tuple[torch.Tensor, ...]


def build_geom_cache(solid) -> GeomCache:
    """The geometry of `solid`, on its device."""
    sphi_c = split_parity(solid.phi, 3)
    sv_c = tuple(split_parity(solid.v[..., c], 3) for c in range(3))
    return GeomCache(sphi_c=sphi_c, sv_c=sv_c, w_faces=tuple(compute_solid_frac_3d(sphi_c)))


def _check_supported(cfg: SimConfig):
    sol = cfg.solver
    if sol.viscosity_mode != "apic":
        raise NotImplementedError(f"the frozen reference runs viscosity_mode='apic' only, got {sol.viscosity_mode!r}")
    if cfg.moving_solid:
        raise NotImplementedError("the frozen reference runs static solids only")
    if sol.precond not in ("jacobi", "mg"):
        raise NotImplementedError(f"cell-Poisson precond={sol.precond!r} is not ported")
    if sol.viscosity_precond not in ("jacobi", "mg", "auto"):
        raise NotImplementedError(f"viscosity_precond={sol.viscosity_precond!r} is not ported")


def _held(t: torch.Tensor, low) -> torch.Tensor:
    """`t` rounded to the precision ``low`` and back (unchanged for None)."""
    return t if low is None else t.to(low).to(t.dtype)


def step_3d(state: SimState, cfg: SimConfig, geom: GeomCache | None = None, low=None,
            probe=None) -> Tuple[SimState, Dict[str, torch.Tensor]]:
    """One step on the device of the state's tensors.

    ``geom``: the static geometry (`build_geom_cache`), built here when
    None.  ``low``: the precision the control holds the state and the
    grid velocities in (see the module's docstring).  ``probe``: a dict
    that receives the step's systems' sizes (``probe["density_live"]``,
    ``probe["pressure_live"]``: the live cells of the two cell systems,
    as the Poisson PCG's init lists them)."""
    g, ph, sol = cfg.grid, cfg.physics, cfg.solver
    p = state.particles
    p = Particles(x=_held(p.x, low), v=_held(p.v, low), c=_held(p.c, low), m=p.m)
    dev = p.x.device
    _check_supported(cfg)
    f32 = torch.float32

    # -- dt selection (cell 13 :4572-4576)
    if cfg.dt_mode == "cfl":
        vmax = torch.amax(rounded_sqrt(torch.sum(p.v**2, dim=-1)))
        # a true division, as JAX's dx / max(vmax, 1e-10)
        cfl_dt = torch.div(g.dx, torch.clamp(vmax, min=1e-10))
        dt = torch.clamp(torch.minimum(cfl_dt, torch.clamp(cfg.duration - state.t, min=1e-6)), max=ph.dt)
    else:
        dt = const(ph.dt, f32, dev)

    solid = state.solid
    if geom is None:
        geom = build_geom_cache(solid)

    # -- advect + project out of solids (:4582-4584)
    px = sdf3d.project(solid.rb, p.x + p.v * dt)

    # -- density/position projection (:4587-4590): one bias-0 cell sort
    #    serves the level set, the mass/volume scatter and the
    #    displacement broadcast
    sort1 = make_sort_info(px, p.m, g.res, g.bound_min, g.cell_size)
    lphi = compute_fluid_levelset(px, g.res, g.bound_min, g.cell_size, g.dx, pm=p.m, sort_info=sort1)
    dres = density_solve_3d(
        ph.rho, dt, px, p.m, cfg.particle_dx**3, geom.sphi_c, lphi, geom.w_faces,
        g.bound_min, g.cell_size, tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter,
        wz_bug=sol.density_wz_bug, sort_info=sort1, precond=sol.precond, mg_opts=sol.mg_opts,
        jacobi_precond=sol.jacobi_precond, probe=None if probe is None else (probe, "density_live"),
    )
    px = _held(dres.px, low)

    # -- level-set rebuild (:4593) + merged P2G and fluid-volume classes
    #    (:4597-4604) over one shared sort, reused by G2P
    fshapes = [tuple(n + (1 if i == a else 0) for i, n in enumerate(g.res)) for a in range(3)]
    # faces carrying < 1e-7 of one particle mass are numerically empty
    mass_floor = 1e-7 * ph.rho * cfg.particle_dx**3
    shared_sort = make_sort_info(px, p.m, g.res, g.bound_min, g.cell_size)
    lphi = compute_fluid_levelset(px, g.res, g.bound_min, g.cell_size, g.dx, pm=p.m, sort_info=shared_sort)
    gm, gv, lvol, sort_info = p2g_all(
        px, p.m, p.v, p.c, g.res, fshapes, _FACE_BIAS, g.bound_min, g.cell_size,
        volume=(cfg.particle_dx**3, g.dual_cell_size), with_sort_info=True,
        sort_info=shared_sort, mass_floor=mass_floor,
    )
    gv = [_held(v, low) for v in gv]

    # -- gravity (:4608)
    gv[1] = gv[1] + ph.gravity * dt

    # -- viscosity (:4611-4642); 'auto' takes MG while the hysteresis flag
    #    carried from the previous step is set (read on the host, once)
    visc_mg = torch.as_tensor(state.visc_mg, dtype=torch.int32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    visc_iters, visc_resid = zero_i, torch.zeros((), dtype=f32, device=dev)
    visc_rel, visc_conv = visc_resid, torch.ones((), dtype=torch.bool, device=dev)
    if ph.mu > 0:
        vres = viscosity_solve_3d(
            dt, ph.mu, ph.rho, tuple(gv), geom.sphi_c, lvol, g.cell_vol,
            tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter, jacobi_precond=sol.jacobi_precond,
            precond_kind=sol.viscosity_precond, auto_use_mg=visc_mg > 0,
        )
        gv = [_held(v, low) for v in vres.v_faces]
        visc_iters = vres.stats.iters
        visc_resid = vres.stats.residual
        visc_rel = vres.stats.residual / torch.clamp(vres.stats.initial_residual, min=1e-30)
        visc_conv = vres.stats.converged

    # -- pressure projection (:4648)
    pres = pressure_solve_3d(
        tuple(gv), geom.sv_c, lphi, geom.w_faces, g.cell_size,
        tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter, precond=sol.precond, mg_opts=sol.mg_opts,
        jacobi_precond=sol.jacobi_precond, dt_scale=dt if sol.pressure_dt_scaled else None,
        probe=None if probe is None else (probe, "pressure_live"),
    )
    gv = [_held(v, low) for v in pres.v_faces]

    # -- extrapolate 2 iterations, valid = mass > 0 (:4652)
    for a in range(3):
        gv[a], _ = extrapolate(gv[a], gm[a] > 0, 2)

    # -- boundary conditions (:4655)
    gv = apply_boundary_condition(gv, gm, geom.sphi_c, geom.sv_c, g.dx, mass_floor=mass_floor)

    # -- G2P (:4660) over P2G's cell sort (positions unchanged since)
    pv, pc = g2p_all(gv, g.res, _FACE_BIAS, g.bound_min, g.cell_size, sort_info)
    pv, pc = _held(pv, low), _held(pc, low)

    # -- viscosity-preconditioner hysteresis (0 Jacobi, 1 MG entered on
    #    cost, 2 MG entered on non-convergence, sticky)
    fallback = max(16, sol.viscosity_auto_iters // 12)
    new_visc_mg = torch.where(
        visc_mg > 0,
        torch.where((visc_mg == 1) & (visc_iters < fallback), 0, visc_mg),
        torch.where(~visc_conv, 2, torch.where(visc_iters >= sol.viscosity_auto_iters, 1, 0)),
    ).to(torch.int32)

    new_state = SimState(
        particles=Particles(x=px, v=pv, c=pc, m=p.m),
        solid=solid,
        t=state.t + dt,
        step_idx=state.step_idx + 1,
        visc_mg=new_visc_mg,
    )

    def _rel(stats):
        return stats.residual / torch.clamp(stats.initial_residual, min=1e-30)

    metrics = {
        "dt": dt,
        "max_speed": torch.amax(rounded_sqrt(torch.sum(pv**2, dim=-1))),
        "density_iters": dres.stats.iters,
        "density_residual": dres.stats.residual,
        "density_rel_residual": _rel(dres.stats),
        "density_converged": dres.stats.converged,
        "viscosity_iters": visc_iters,
        "viscosity_residual": visc_resid,
        "viscosity_rel_residual": visc_rel,
        "viscosity_converged": visc_conv,
        "pressure_iters": pres.stats.iters,
        "pressure_residual": pres.stats.residual,
        "pressure_rel_residual": _rel(pres.stats),
        "pressure_converged": pres.stats.converged,
    }
    return new_state, metrics
