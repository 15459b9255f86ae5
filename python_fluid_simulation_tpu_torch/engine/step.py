"""The time step: ``step_3d(state, cfg) -> (state, metrics)``.

Counterpart of ``python_fluid_simulation_tpu.engine.step`` for the
single-device step with static solids (the reference's notebook cell 13,
:4552-4693), in the viscosity modes 'apic' (the implicit solve), 'unet'
(the learned operator's Δv in place of the solve) and 'unet_warm' (the
solve started from the network's guess).  Step order follows cell 13:
  dt (CFL, :4572-4576) -> advect + SDF project (:4582-4584)
  -> sort + level set -> density solve (:4587-4590) -> sort + level set
  again (:4593-4594) -> merged P2G + fluid-volume classes (:4597)
  -> gravity (:4608) -> viscosity (:4623) -> pressure (:4648)
  -> extrapolate 2 iters (:4652) -> boundary condition (:4655)
  -> G2P (:4660) -> viscosity-preconditioner hysteresis flag.

The three solves run as CUDA kernels when the state lives on the GPU
(``ops/cuda_stencils.py``: the Jacobi cell solves take the live-cell
Poisson PCG kernel, on its fused route above
``solvers/pressure.py::FUSED_POISSON_CELLS`` cells;
``ops/cuda_cg.py``; with ``precond='mg'`` the
cell solves are CG over ``stencil_matvec`` with the multigrid V-cycle of
``solvers/multigrid.py`` and ``ops/cuda_mg.py``; with
``viscosity_precond='mg'``, or 'auto' while the carried flag is set, the
viscosity solve is CG over ``coupled_matvec_geom`` with the batched
block V-cycle, or above 4M face cells the lean two-grid cycle), and so
do the segment reduces (the scan route of ``ops/cuda_binned.py`` and
``ops/cuda_scan.py`` for every reduce of up to 256 channels) and
broadcasts and the folds of the transfers (``ops/cuda_fold.py``).
With ``jacobi_precond=False`` (the reference's unpreconditioned CG) the
non-MG solves are the generic CG over ``stencil_matvec`` and
``coupled_stencil_matvec``; ``pressure_dt_scaled`` solves the pressure
system scaled by dt.  The Jacobi solves make no host sync; the generic
CG loops test their exit on the host once per iteration, and 'auto'
reads its flag once a step.  The UNet (``models/unet3d.py``) runs on the
device of the state, through cuDNN.

With a ``mesh`` (``parallel/mesh.py``; the JAX package's
``step_3d(mesh=)``) the three solves run distributed over the mesh's
slot blocks (``parallel/halo.py``: the cell solves'
``distributed_cell_poisson`` and the viscosity solve's
``distributed_coupled_cg``, whatever preconditioner is configured, with
the halo push kernel for every width-1 axis-0 exchange of CUDA blocks).
Everything else runs globally on slot 0's device with the kernels above:
the particles and the non-solve grid fields are not split yet (the JAX
package's sharding constraints change no number), the UNet of 'unet' and
'unet_warm' on the whole grid; 'unet_warm' starts the distributed
viscosity solve from the line search over the materialised operator.
With ``bucketed=True`` (the JAX package's bucketed step) the particles
reside in the slot that owns their x-slab (``parallel/particles.py``),
or on an (x, z) mesh their x-by-z block (``parallel/particles2d.py``):
they are rebucketed after the advection and after the density
projection, and the level sets, the density scatter and displacement,
P2G and G2P run shard-local, slot by slot, on the same kernels;
``metrics["bucket_lost"]`` counts the particles an overflow dropped.

With ``cfg.moving_solid`` each step advances the rigid bodies by dt,
re-evaluates the solid level set and velocity on the dual lattice and
rebuilds the geometry (JAX ``engine/step.py:156-183``).

``make_step`` is the counterpart of the JAX package's jitted step, and
``simulate`` of its ``lax.scan``: on CUDA the step is captured once into
a CUDA graph and replayed (the generic CG loops, and with a mesh the
distributed solves, as WHILE nodes with a device-side exit test,
``solvers/cg.py``, ``parallel/halo.py``); on the CPU they run the eager
``step_3d``.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Tuple

import torch

from python_fluid_simulation_tpu_torch.config import SimConfig
from python_fluid_simulation_tpu_torch.models.features import unet_delta_v
from python_fluid_simulation_tpu_torch.models.train import capture_viscosity_pair
from python_fluid_simulation_tpu_torch.ops import sdf as sdf3d
from python_fluid_simulation_tpu_torch.ops.boundary import apply_boundary_condition
from python_fluid_simulation_tpu_torch.ops.cuda_graph import captured_while, graph_capture
from python_fluid_simulation_tpu_torch.ops.extrapolate import extrapolate
from python_fluid_simulation_tpu_torch.ops.fractions import compute_solid_frac_3d
from python_fluid_simulation_tpu_torch.ops.indexing import const, grid_positions, merge_parity, rounded_sqrt, split_parity
from python_fluid_simulation_tpu_torch.ops.levelset import compute_fluid_levelset
from python_fluid_simulation_tpu_torch.ops.transfers import g2p_all, make_sort_info, p2g_all
from python_fluid_simulation_tpu_torch.solvers.density import density_solve_3d
from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_solve_3d
from python_fluid_simulation_tpu_torch.solvers.viscosity import viscosity_solve_3d
from python_fluid_simulation_tpu_torch.state import Particles, SimState, SolidState

_FACE_BIAS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))


@dataclasses.dataclass
class GeomCache:
    """Static solid geometry derived from the solid level set: the 2^3
    parity classes of sphi and sv and the cut-cell face weights.  Build
    it once while the rigid bodies do not move."""

    sphi_c: dict
    sv_c: Tuple[dict, ...]
    w_faces: Tuple[torch.Tensor, ...]


def build_geom_cache(solid, mesh=None) -> GeomCache:
    """The geometry of `solid`, on its device; with a ``mesh`` that must
    be slot 0's, where the sharded step keeps every non-solve field."""
    if mesh is not None and solid.phi.device != mesh.devices[0]:
        raise ValueError(f"the solid is on {solid.phi.device}, the mesh's slot 0 on {mesh.devices[0]}")
    sphi_c = split_parity(solid.phi, 3)
    sv_c = tuple(split_parity(solid.v[..., c], 3) for c in range(3))
    return GeomCache(sphi_c=sphi_c, sv_c=sv_c, w_faces=tuple(compute_solid_frac_3d(sphi_c)))


def _check_supported(cfg: SimConfig, unet=None, capture_ml=False, mesh=None, bucketed=False):
    sol = cfg.solver
    if bucketed and mesh is None:
        raise ValueError("bucketed mode needs a mesh")
    if sol.viscosity_mode not in ("apic", "unet", "unet_warm"):
        raise ValueError(f"unknown viscosity_mode {sol.viscosity_mode!r}")
    if sol.viscosity_mode == "unet" and unet is None:
        raise ValueError("viscosity_mode='unet' needs a model: step_3d(..., unet=UNet3D(...))")
    if capture_ml and (sol.viscosity_mode == "unet" or cfg.physics.mu <= 0):
        raise ValueError("capture_ml captures the pair around the viscosity solve: 'apic' or 'unet_warm' with mu > 0")
    if sol.precond not in ("jacobi", "mg"):
        raise NotImplementedError(f"cell-Poisson precond={sol.precond!r} is not ported")
    if sol.viscosity_precond not in ("jacobi", "mg", "auto"):
        raise NotImplementedError(f"viscosity_precond={sol.viscosity_precond!r} is not ported")


def step_3d(
    state: SimState, cfg: SimConfig, geom: GeomCache | None = None, unet=None, capture_ml=False,
    mesh=None, bucketed: bool = False, auto_mg: bool | None = None,
) -> Tuple[SimState, Dict[str, torch.Tensor]]:
    """One step on the device of the state's tensors.

    ``unet``: the learned operator (``models/unet3d.py::UNet3D``, on the
    state's device), needed by 'unet'; in 'unet_warm' without one the
    solve starts cold.  ``capture_ml`` ('apic' and 'unet_warm' only):
    "raw" puts the velocities around the viscosity solve and the merged
    fluid volume in ``metrics["ml_pair"]``, ``True`` the built
    ``models/train.py::ViscosityExample``.

    ``mesh``: run the three solves distributed over its slots (the state
    on slot 0's device, its particles padded by
    ``parallel/mesh.py::shard_state``).  ``bucketed``: the particles are
    in the slot-major layout of ``parallel/particles.py::
    bucket_particles`` (a 1D mesh) or ``parallel/particles2d.py::
    bucket_particles_2d`` (an (x, z) mesh) and the transfers run
    shard-local; ``metrics["bucket_lost"]`` is added.

    ``geom``: the static geometry (`build_geom_cache`), built here when
    None; with ``cfg.moving_solid`` it is rebuilt here every step.
    ``auto_mg``: the 'auto' viscosity branch (MG when True) where the
    caller has read the carried flag itself, as `make_step` does before
    each replay; None reads ``state.visc_mg`` here."""
    g, ph, sol = cfg.grid, cfg.physics, cfg.solver
    p = state.particles
    dev = p.x.device
    _check_supported(cfg, unet, capture_ml, mesh, bucketed)
    if mesh is not None and dev != mesh.devices[0]:
        raise ValueError(f"the state is on {dev}, the mesh's slot 0 on {mesh.devices[0]}")
    if unet is not None and next(unet.parameters()).device != dev:
        raise ValueError(f"the UNet's parameters are on {next(unet.parameters()).device}, the state on {dev}")
    f32 = torch.float32

    # -- dt selection (cell 13 :4572-4576)
    if cfg.dt_mode == "cfl":
        vmax = torch.amax(rounded_sqrt(torch.sum(p.v**2, dim=-1)))
        # a true division, as JAX's dx / max(vmax, 1e-10): PyTorch evaluates
        # `float / tensor` as tensor.reciprocal() * float, two roundings
        cfl_dt = torch.div(g.dx, torch.clamp(vmax, min=1e-10))
        dt = torch.clamp(torch.minimum(cfl_dt, torch.clamp(cfg.duration - state.t, min=1e-6)), max=ph.dt)
    else:
        dt = const(ph.dt, f32, dev)

    # -- moving bodies: advance each body's translation by its velocity
    #    row and re-evaluate the solid level set and the geometry for this
    #    step (the reference's transform_rb / set_vel_rb, sdf3D.py:329-336)
    solid = state.solid
    if cfg.moving_solid:
        rb = sdf3d.advance_rigid_bodies(solid.rb, dt)
        dual_pos = grid_positions(g.dual_res, g.bound_min, g.dual_cell_size, (0.0,) * 3, device=dev)
        s_phi, s_vel = sdf3d.evaluate(rb, dual_pos)
        solid = SolidState(phi=s_phi, v=s_vel, rb=rb)
        geom = None
    if geom is None:
        geom = build_geom_cache(solid, mesh)

    # -- advect + project out of solids (:4582-4584)
    px = sdf3d.project(solid.rb, p.x + p.v * dt)

    # -- bucketed residency: after every particle move a bounded one-slab
    #    exchange restores the slot-major layout (JAX engine/step.py:192-240)
    bspec = None
    if bucketed:
        if len(mesh.axis_names) == 2:  # (x, z) slot-by-slot residency
            from python_fluid_simulation_tpu_torch.parallel.particles2d import (
                rebucket_2d as rebucket,
                sharded_fluid_levelset_2d as sharded_fluid_levelset,
                sharded_g2p_all_2d as sharded_g2p_all,
                sharded_p2g_all_2d as sharded_p2g_all,
                spec_from_state_2d,
            )

            bspec = spec_from_state_2d(p.x.shape[0], mesh, g.res[0], g.res[2])
        else:
            from python_fluid_simulation_tpu_torch.parallel.particles import (
                rebucket,
                sharded_fluid_levelset,
                sharded_g2p_all,
                sharded_p2g_all,
                spec_from_state,
            )

            bspec = spec_from_state(p.x.shape[0], mesh.size, g.res[0])
        p, lost = rebucket(Particles(x=px, v=p.v, c=p.c, m=p.m), mesh, bspec, g.bound_min, g.cell_size)
        px = p.x

    # -- density/position projection (:4587-4590): one bias-0 cell sort
    #    serves the level set, the mass/volume scatter and the
    #    displacement broadcast (bucketed: the shard-local level set, and
    #    the density solve's own per-slot sort)
    sort1 = None
    if bspec is None:
        sort1 = make_sort_info(px, p.m, g.res, g.bound_min, g.cell_size)
        lphi = compute_fluid_levelset(px, g.res, g.bound_min, g.cell_size, g.dx, pm=p.m, sort_info=sort1)
    else:
        lphi = sharded_fluid_levelset(px, p.m, mesh, bspec, g.res, g.bound_min, g.cell_size, g.dx)
    dres = density_solve_3d(
        ph.rho, dt, px, p.m, cfg.particle_dx**3, geom.sphi_c, lphi, geom.w_faces,
        g.bound_min, g.cell_size, tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter,
        wz_bug=sol.density_wz_bug, sort_info=sort1, precond=sol.precond, mg_opts=sol.mg_opts,
        jacobi_precond=sol.jacobi_precond, mesh=mesh, bucket=(mesh, bspec) if bspec is not None else None,
    )
    px = dres.px
    if bspec is not None:
        p, lost2 = rebucket(Particles(x=px, v=p.v, c=p.c, m=p.m), mesh, bspec, g.bound_min, g.cell_size)
        px = p.x
        lost = lost + lost2

    # -- level-set rebuild (:4593) + merged P2G and fluid-volume classes
    #    (:4597-4604) over one shared sort, reused by G2P
    fshapes = [tuple(n + (1 if i == a else 0) for i, n in enumerate(g.res)) for a in range(3)]
    # faces carrying < 1e-7 of one particle mass are numerically empty
    mass_floor = 1e-7 * ph.rho * cfg.particle_dx**3
    if bspec is None:
        shared_sort = make_sort_info(px, p.m, g.res, g.bound_min, g.cell_size)
        lphi = compute_fluid_levelset(px, g.res, g.bound_min, g.cell_size, g.dx, pm=p.m, sort_info=shared_sort)
        gm, gv, lvol, sort_info = p2g_all(
            px, p.m, p.v, p.c, g.res, fshapes, _FACE_BIAS, g.bound_min, g.cell_size,
            volume=(cfg.particle_dx**3, g.dual_cell_size), with_sort_info=True,
            sort_info=shared_sort, mass_floor=mass_floor,
        )
    else:
        lphi = sharded_fluid_levelset(px, p.m, mesh, bspec, g.res, g.bound_min, g.cell_size, g.dx)
        gm, gv, lvol, sort_info = sharded_p2g_all(
            p, mesh, bspec, g.res, fshapes, _FACE_BIAS, g.bound_min, g.cell_size,
            volume=(cfg.particle_dx**3, g.dual_cell_size), mass_floor=mass_floor,
        )
    gv = list(gv)

    # -- gravity (:4608)
    gv[1] = gv[1] + ph.gravity * dt

    # -- viscosity (:4611-4642); 'auto' takes MG while the hysteresis flag
    #    carried from the previous step is set (read on the host, once)
    visc_mg = torch.as_tensor(state.visc_mg, dtype=torch.int32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    visc_iters, visc_resid = zero_i, torch.zeros((), dtype=f32, device=dev)
    visc_rel, visc_conv = visc_resid, torch.ones((), dtype=torch.bool, device=dev)
    sphi = solid.phi
    if ph.mu > 0 and sol.viscosity_mode == "unet":
        # g.v += Δv, zero where the face has no mass (cell 13 :4635-4640);
        # the viscosity stats stay at 0 iterations, converged
        dv = unet_delta_v(unet, gv, sphi, lvol, cfg)
        gv = [torch.where(gm[a] > 0, gv[a] + dv[a], 0.0) for a in range(3)]
    elif ph.mu > 0:
        warm = None
        if sol.viscosity_mode == "unet_warm" and unet is not None:
            # the network's guess seeds the solve only; the system is still
            # built from gv
            dv = unet_delta_v(unet, gv, sphi, lvol, cfg)
            warm = tuple(torch.where(gm[a] > 0, gv[a] + dv[a], gv[a]) for a in range(3))
        vres = viscosity_solve_3d(
            dt, ph.mu, ph.rho, tuple(gv), geom.sphi_c, lvol, g.cell_vol,
            tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter, jacobi_precond=sol.jacobi_precond,
            precond_kind=sol.viscosity_precond, auto_use_mg=visc_mg > 0 if auto_mg is None else auto_mg,
            warm_start=warm, mesh=mesh,
        )
        if capture_ml == "raw":
            ml_pair = {"gv_before": tuple(gv), "gv_after": vres.v_faces, "lvol": merge_parity(lvol, tuple(sphi.shape))}
        elif capture_ml:
            ml_pair = capture_viscosity_pair(tuple(gv), vres.v_faces, sphi, lvol, cfg)
        gv = list(vres.v_faces)
        visc_iters = vres.stats.iters
        visc_resid = vres.stats.residual
        visc_rel = vres.stats.residual / torch.clamp(vres.stats.initial_residual, min=1e-30)
        visc_conv = vres.stats.converged

    # -- pressure projection (:4648)
    pres = pressure_solve_3d(
        tuple(gv), geom.sv_c, lphi, geom.w_faces, g.cell_size,
        tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter, precond=sol.precond, mg_opts=sol.mg_opts,
        jacobi_precond=sol.jacobi_precond, dt_scale=dt if sol.pressure_dt_scaled else None, mesh=mesh,
    )
    gv = list(pres.v_faces)

    # -- extrapolate 2 iterations, valid = mass > 0 (:4652)
    for a in range(3):
        gv[a], _ = extrapolate(gv[a], gm[a] > 0, 2)

    # -- boundary conditions (:4655)
    gv = apply_boundary_condition(gv, gm, geom.sphi_c, geom.sv_c, g.dx, mass_floor=mass_floor)

    # -- G2P (:4660) over P2G's cell sort (positions unchanged since)
    if bspec is None:
        pv, pc = g2p_all(gv, g.res, _FACE_BIAS, g.bound_min, g.cell_size, sort_info)
    else:
        pv, pc = sharded_g2p_all(gv, mesh, bspec, g.res, _FACE_BIAS, g.bound_min, g.cell_size, sort_info)

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
    if bucketed:
        metrics["bucket_lost"] = lost
    if capture_ml:
        metrics["ml_pair"] = ml_pair
    return new_state, metrics


def _state_tensors(state: SimState) -> list:
    """The tensors of a state in a fixed order (`_state_of` inverts it)."""
    p, sol = state.particles, state.solid
    return [p.x, p.v, p.c, p.m, sol.phi, sol.v, sol.rb, state.t, state.step_idx, state.visc_mg]


def _state_of(ts) -> SimState:
    x, v, c, m, phi, sv, rb, t, k, visc_mg = ts
    return SimState(Particles(x, v, c, m), SolidState(phi, sv, rb), t, k, visc_mg)


def _branch(cfg: SimConfig, visc_mg) -> bool | None:
    """The 'auto' branch of a step from its carried flag: one host read,
    only where the step has the branch (None elsewhere)."""
    sol = cfg.solver
    if sol.viscosity_precond == "auto" and cfg.physics.mu > 0 and sol.viscosity_mode != "unet":
        return int(visc_mg) > 0
    return None


def pool_bytes(*pools) -> int:
    """Bytes of device memory the caching allocator holds in the given
    private pools (ids, as ``CUDAGraph.pool()`` and ``MemPool.id`` give
    them)."""
    ids = {tuple(p) for p in pools}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in ids)


@dataclasses.dataclass
class CapturedStep:
    """One captured step: its graph and the private pools it keeps using
    (its loop bodies' on the state's device, and one a further card of a
    mesh over several; held as long as the graph), the output tensors it
    writes on every replay (state in `_state_tensors` order, and metrics),
    the seconds the warm-up and the capture took, every pool's bytes after
    capture, the graph's top-level nodes on every card (a WHILE node once)
    and each WHILE body's nodes, in the order the step records them (one
    a card for each distributed solve of a mesh over several)."""

    graph: "torch.cuda.CUDAGraph"
    pools: list
    outputs: list
    metrics: Dict[str, torch.Tensor]
    seconds: float
    pool_bytes: int
    nodes: int
    loop_nodes: Tuple[int, ...]


class StepReplayer:
    """The step on one state's shapes, captured into CUDA graphs over
    static input buffers: one graph a value of the 'auto' branch (one
    graph with a ``mesh``, whose viscosity solve reads no flag).

    A capture first runs one eager step from the inputs on a side stream
    (it builds the kernel library, the cached constants, the cuDNN plans
    and the cooperative-launch capacities), then records `step_3d` under
    ``torch.cuda.graph``.  Each graph has its own memory pool.  ``geom``
    (static solids) is read in place by every replay; None rebuilds the
    geometry inside the graph.  The UNet's parameters are read in place
    too: updating them in place is seen by the next replay, replacing a
    parameter tensor needs a new replayer.  ``mesh`` and ``bucketed``
    capture the sharded step (`step_3d`'s); where the mesh's slots span
    several cards the graph is one program over all of them
    (``ops/cuda_graph.py::graph_capture``), launched on the state's card
    (slot 0's), each distributed solve one WHILE node a card."""

    needs_geom = True  # the step reads a static geometry (`SimulateCapture` builds one where none is given)

    def __init__(self, cfg: SimConfig, like: SimState, geom: GeomCache | None = None, unet=None, mesh=None,
                 bucketed: bool = False):
        self.cfg, self.geom, self.unet, self.mesh, self.bucketed = cfg, geom, unet, mesh, bucketed
        # visc_mg int32, whatever it came as (a scene's is a Python 0)
        self.inputs = [torch.empty_like(t) for t in _state_tensors(like)[:-1]]
        self.inputs.append(torch.zeros((), dtype=torch.int32, device=like.particles.x.device))
        self.captured: Dict[bool | None, CapturedStep] = {}
        self.replays = 0  # graph launches, every branch

    def load(self, state: SimState):
        """Copy a state into the input buffers (on the device, no sync)."""
        for dst, src in zip(self.inputs, _state_tensors(state)):
            if isinstance(src, torch.Tensor):
                dst.copy_(src)
            else:
                dst.fill_(src)

    def graph(self, branch: bool | None) -> CapturedStep:
        """The step's graph for an 'auto' branch, captured at first use
        from what the input buffers hold then."""
        if branch not in self.captured:
            self.captured[branch] = self._capture(branch)
        return self.captured[branch]

    def run(self, state: SimState, branch):
        """The step this replayer captures, run once on `state`."""
        return step_3d(state, self.cfg, geom=self.geom, unet=self.unet, mesh=self.mesh, bucketed=self.bucketed,
                       auto_mg=branch)

    def branch(self, visc_mg) -> bool | None:
        """The graph to replay for a state's 'auto' flag (`_branch`); with
        a mesh the one graph, read from nothing."""
        return None if self.mesh is not None else _branch(self.cfg, visc_mg)

    def _capture(self, branch) -> CapturedStep:
        dev = self.inputs[0].device
        state = _state_of(self.inputs)
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.run(state, branch)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        loops = len(captured_while.body_nodes)
        devices = self.mesh.devices if self.mesh is not None else ()
        with graph_capture(graph, dev, devices, capture_error_mode="thread_local") as pools:
            out, metrics = self.run(state, branch)
        torch.cuda.synchronize(dev)
        return CapturedStep(graph, pools, _state_tensors(out), metrics, time.perf_counter() - t0,
                            pool_bytes(graph.pool(), *(p.id for p in pools)), graph_capture.nodes,
                            tuple(captured_while.body_nodes[loops:]))

    def replay(self, branch: bool | None) -> CapturedStep:
        cap = self.graph(branch)
        with torch.cuda.device(self.inputs[0].device):
            cap.graph.replay()
        self.replays += 1
        return cap

    def advance(self, cap: CapturedStep):
        """Copy a replay's state into the input buffers, on the device."""
        for dst, src in zip(self.inputs, cap.outputs):
            if src is not dst:
                dst.copy_(src)

    def result(self, cap: CapturedStep, caller: SimState) -> SimState:
        """The replay's state as tensors no later replay writes: clones,
        and the caller's own tensors where the step passed an input
        through (the masses, a static solid)."""
        passed = {id(i): t for i, t in zip(self.inputs, _state_tensors(caller))}
        return _state_of([passed[id(o)] if id(o) in passed else o.clone() for o in cap.outputs])


def replaying_step(cfg: SimConfig, geom: GeomCache | None = None, unet=None, replayer=StepReplayer):
    """``step(state) -> (state, metrics)`` on CUDA states by CUDA graph
    replay: the first call on a state's shapes captures `step_3d` with
    ``geom`` (None: the geometry built inside the graph) into a
    `StepReplayer` (or a subclass of it, ``replayer``, that captures
    another step), and every call copies the state into its inputs,
    reads the 'auto' flag on the host where the configuration has one,
    replays that branch's graph and returns clones that no later replay
    writes.  ``step.replayers`` holds the captures."""
    replayers: Dict[tuple, StepReplayer] = {}

    def step(state: SimState):
        ts = _state_tensors(state)
        key = tuple((tuple(t.shape), t.dtype, t.device) for t in ts[:-1])
        if key not in replayers:
            replayers[key] = replayer(cfg, state, geom=geom, unet=unet)
        rep = replayers[key]
        rep.load(state)
        cap = rep.replay(rep.branch(state.visc_mg))
        return rep.result(cap, state), {k: v.clone() for k, v in cap.metrics.items()}

    step.replayers = replayers
    return step


def make_step(cfg: SimConfig, unet=None, mesh=None, bucketed: bool = False):
    """The step with a static config, ``step(state) -> (state, metrics)``
    (JAX ``make_step``).

    On CUDA the step is `replaying_step`'s: the first call on a state's
    shapes captures `step_3d` (the geometry built inside, as the JAX
    package's jitted step builds it) into a CUDA graph and every call
    replays it, the returned state and metrics clones that no later
    replay writes.  With ``viscosity_precond='auto'`` each call reads the
    state's flag on the host once and replays that branch's graph.  A
    capture that fails raises; there is no eager route on CUDA.  On the
    CPU ``step`` is the eager `step_3d`.

    ``unet``'s parameters are read in place by the replays: update them in
    place (as an optimiser does), or make a new step after replacing a
    parameter tensor.  With a ``mesh`` (and ``bucketed``, which needs one)
    the step is `step_3d`'s sharded step, captured the same way: its
    distributed solves are WHILE nodes, and it reads no 'auto' flag (the
    mesh's viscosity solve is the distributed Jacobi-PCG).  A mesh whose
    slots span several cards (``make_mesh(n, devices=cuda_devices(n))``)
    is captured as one graph over them, replayed from slot 0's card, each
    distributed solve one WHILE node a card, every replay bitwise the
    eager ``step_3d(mesh=)``."""
    _check_supported(cfg, unet, mesh=mesh, bucketed=bucketed)
    replayed = replaying_step(cfg, unet=unet, replayer=functools.partial(StepReplayer, mesh=mesh, bucketed=bucketed))

    def step(state: SimState):
        if state.particles.x.device.type != "cuda":
            return step_3d(state, cfg, unet=unet, mesh=mesh, bucketed=bucketed)
        return replayed(state)

    step.replayers = replayed.replayers  # the captures, for inspection
    return step


class SimulateCapture:
    """The captured step `simulate` keeps across its calls, as the JAX
    package's module-level jit of ``_simulate_jit`` keeps its compiled
    program: one replayer of class ``replayer`` (`StepReplayer`, or a
    subclass that captures another step), reused by a call with an equal
    config and ``bucketed``, the same ``geom``, ``unet`` and ``mesh``
    objects (or, where ``geom`` is None and the step reads one, the same
    solid tensors the geometry was built from) and the same state shapes,
    dtypes and devices, and replaced otherwise.  One, not a cache of many: its graph pools hold
    0.57 GB on the flagship and 15 GB at 256.  ``captures`` counts the
    graphs captured by `run` so far (one a replayer and 'auto' branch),
    ``replayers`` the replayers it made; `clear` frees the held one."""

    def __init__(self, replayer=StepReplayer):
        self.kind = replayer
        self.replayer: StepReplayer | None = None
        self._key = None
        self.captures = 0
        self.replayers = 0

    def _builds_geom(self, cfg, geom) -> bool:
        return geom is None and self.kind.needs_geom and not cfg.moving_solid

    def _key_of(self, cfg, state, geom, unet, mesh, bucketed):
        """(values compared by equality, objects compared by identity)."""
        shapes = tuple((tuple(t.shape), t.dtype, t.device) for t in _state_tensors(state)[:-1])
        objects = (geom, unet, mesh)
        if self._builds_geom(cfg, geom):  # the geometry is built from these
            objects += (state.solid.phi, state.solid.v, state.solid.rb)
        return (cfg, shapes, bucketed), objects

    @staticmethod
    def _same(a, b) -> bool:
        return a[0] == b[0] and len(a[1]) == len(b[1]) and all(x is y for x, y in zip(a[1], b[1]))

    def replayer_for(self, cfg: SimConfig, state: SimState, geom: GeomCache | None = None, unet=None, mesh=None,
                     bucketed: bool = False) -> StepReplayer:
        """The held replayer if it was made for this call's arguments,
        else a new one (the geometry built here where ``geom`` is None
        and the step reads static solids)."""
        key = self._key_of(cfg, state, geom, unet, mesh, bucketed)
        if self.replayer is None or not self._same(self._key, key):
            self.clear()
            if self._builds_geom(cfg, geom):
                geom = build_geom_cache(state.solid, mesh)
            self.replayer = self.kind(cfg, state, geom=geom, unet=unet, mesh=mesh, bucketed=bucketed)
            self._key = key
            self.replayers += 1
        return self.replayer

    def run(self, state: SimState, cfg: SimConfig, num_steps: int, geom: GeomCache | None = None, unet=None,
            mesh=None, bucketed: bool = False):
        """``num_steps`` replays from ``state`` (at least one), each
        replay's state copied into the next's inputs on the device: (the
        last state, as tensors no later replay writes; each step's metrics,
        cloned)."""
        rep = self.replayer_for(cfg, state, geom, unet, mesh, bucketed)
        before = len(rep.captured)
        rep.load(state)
        history = []
        for i in range(num_steps):
            if i:
                rep.advance(cap)
            cap = rep.replay(rep.branch(rep.inputs[-1]))
            history.append({k: v.clone() for k, v in cap.metrics.items()})
        self.captures += len(rep.captured) - before
        return rep.result(cap, state), history

    def clear(self):
        self.replayer, self._key = None, None


def stack_metrics(history: list) -> Dict[str, torch.Tensor]:
    """Each metric stacked over the steps, as ``lax.scan`` stacks them."""
    return {k: torch.stack([m[k] for m in history]) for k in history[0]} if history else {}


def simulate(state: SimState, cfg: SimConfig, num_steps: int, geom: GeomCache | None = None, unet=None,
             mesh=None, bucketed: bool = False):
    """Run `num_steps` steps (JAX ``simulate``); the static geometry is
    built once, outside the steps (none with ``cfg.moving_solid``).
    Returns (final_state, metrics) with each metric stacked over steps.

    On CUDA the step is captured once and replayed ``num_steps`` times,
    each replay's state copied into the inputs of the next on the device;
    'auto' reads the carried flag once a step.  The capture outlives the
    call (``simulate.capture``, a `SimulateCapture`): a later call with
    the same config, ``geom``, ``unet`` and state shapes replays the same
    graphs from the state it is given, as repeated calls of the JAX
    package's jitted ``simulate`` reuse its program; 'auto' captures
    each branch once.  The returned state and metrics are tensors no
    later replay writes.  A ``mesh`` (``bucketed`` with it, the particles
    bucketed as `step_3d` takes them) is captured the same way, one graph
    (`make_step`'s).  On the CPU the steps run eagerly."""
    if bucketed and mesh is None:
        raise ValueError("bucketed mode needs a mesh")
    history = []
    if num_steps > 0 and state.particles.x.device.type == "cuda":
        state, history = simulate.capture.run(state, cfg, num_steps, geom, unet, mesh, bucketed)
    else:
        if geom is None and not cfg.moving_solid:
            geom = build_geom_cache(state.solid, mesh)
        for _ in range(num_steps):
            state, m = step_3d(state, cfg, geom=geom, unet=unet, mesh=mesh, bucketed=bucketed)
            history.append(m)
    return state, stack_metrics(history)


simulate.capture = SimulateCapture()
