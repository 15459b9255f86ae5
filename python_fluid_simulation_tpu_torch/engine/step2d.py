"""The 2D engine: ``step_2d(state, cfg) -> (state, metrics)``.

Counterpart of ``python_fluid_simulation_tpu.engine.step2d``.  The
reference ships 2D solvers (PressureCGSolver2D, ViscosityCGSolver2D,
DensityCGSolver2D, SolidFraction2D, sdf2D) but no 2D step loop; the JAX
package's orchestration mirrors the 3D loop with the 2D components and
their sign conventions, and this module follows it operation for
operation:

  dt (CFL) -> advect + SDF project -> solid face weights -> level set +
  dual-lattice fluid volume -> density projection -> level set + volume
  again -> P2G per axis -> gravity -> viscosity (solid = sphi <= 0, no
  pre-extrapolation) -> pressure -> extrapolate 2 iterations ->
  boundary condition -> G2P per axis.

On CUDA the particle <-> grid reduces and folds run on the scatter
kernels (``ops/cuda_scan.py``, ``ops/cuda_binned.py``: the segmented scan
and the live placement; ``ops/cuda_fold.py``: the fold, a 2D fold as a 3D
one with a unit axis); the three solves are the generic CG over the plain
5-point and coupled matvecs (``solvers/cg.py``), as the JAX package runs
its 2D solves in XLA (its Pallas routes are for ``d == 3``), and G2P and
the displacement gather are plain gathers, as in the JAX package.

``make_step_2d`` and ``simulate_2d`` are the counterparts of the JAX
package's jitted step and its ``lax.scan``: on CUDA the step is captured
into a CUDA graph once (the CG loops as WHILE nodes,
``ops/cuda_graph.py::captured_while``) and replayed; ``simulate_2d``
keeps its capture across calls (``simulate_2d.capture``).  On the CPU
both run the eager ``step_2d``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.config import GridConfig2D, PhysicsConfig, SolverConfig
from python_fluid_simulation_tpu_torch.engine.step import SimulateCapture, StepReplayer, replaying_step, stack_metrics
from python_fluid_simulation_tpu_torch.ops import sdf2d
from python_fluid_simulation_tpu_torch.ops.boundary import apply_boundary_condition
from python_fluid_simulation_tpu_torch.ops.extrapolate import extrapolate
from python_fluid_simulation_tpu_torch.ops.fractions import compute_solid_frac_2d
from python_fluid_simulation_tpu_torch.ops.indexing import const, grid_positions, rounded_sqrt
from python_fluid_simulation_tpu_torch.ops.levelset import compute_fluid_levelset, compute_fluid_volume
from python_fluid_simulation_tpu_torch.ops.transfers import g2p_axis, p2g_axis
from python_fluid_simulation_tpu_torch.solvers.density import density_solve_2d
from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_solve_2d
from python_fluid_simulation_tpu_torch.solvers.viscosity import viscosity_solve_2d
from python_fluid_simulation_tpu_torch.state import Particles, SimState, SolidState


@dataclasses.dataclass(frozen=True)
class SimConfig2D:
    """The 2D scene configuration (JAX ``SimConfig2D``, field for field;
    the CLI's 2D scenes run its defaults: 64x64 cells, particle_dx 1/128)."""

    grid: GridConfig2D = GridConfig2D()
    physics: PhysicsConfig = PhysicsConfig()
    solver: SolverConfig = SolverConfig()
    particle_dx: float = 1.0 / 128.0
    dt_mode: str = "cfl"
    duration: float = 2.0


_FACE_BIAS = ((0.0, 0.5), (0.5, 0.0))


def make_solid_state_2d(cfg: SimConfig2D, rbs: sdf2d.RigidBodySet2D, device="cuda") -> SolidState:
    """The rigid bodies' SDF and velocity on the (2N+1)^2 dual lattice."""
    g = cfg.grid
    pos = grid_positions(g.dual_res, g.bound_min, g.dual_cell_size, (0.0, 0.0), device=device)
    rb = rbs.table(device=device)
    phi, vel = sdf2d.evaluate_2d(rb, pos)
    return SolidState(phi=phi, v=vel, rb=rb)


def _container(cfg: SimConfig2D, device) -> SolidState:
    g = cfg.grid
    rbs = sdf2d.RigidBodySet2D()
    c = [m + 0.5 * s for m, s in zip(g.bound_min, g.bound_size)]
    inner = [s - 4 * g.dx for s in g.bound_size]
    rbs.add("container", "box", inner, flip=True, center=c)
    return make_solid_state_2d(cfg, rbs, device)


def _scene(cfg: SimConfig2D, solid: SolidState, pos: np.ndarray, jitter, pdx: float, device):
    """Drop the seeds inside solids, add ``jitter(shape)`` and make the
    state at rest."""
    sd, _ = sdf2d.evaluate_2d(solid.rb.cpu(), torch.from_numpy(pos))
    pos = pos[sd.numpy() >= 0]
    pos = pos + jitter(pos.shape)
    n = pos.shape[0]
    f32 = torch.float32
    particles = Particles(
        x=torch.as_tensor(pos, dtype=f32, device=device),
        v=torch.zeros((n, 2), dtype=f32, device=device),
        c=torch.zeros((n, 2, 2), dtype=f32, device=device),
        m=torch.full((n,), cfg.physics.rho * pdx**2, dtype=f32, device=device),
    )
    return SimState(particles=particles, solid=solid, t=torch.zeros((), dtype=f32, device=device),
                    step_idx=torch.zeros((), dtype=torch.int32, device=device))


def dam_break_scene_2d(cfg: SimConfig2D | None = None, seed: int = 0, device="cuda"):
    """A block of fluid in the lower-left corner of a box container;
    returns (cfg, state), as the JAX scene does."""
    cfg = cfg or SimConfig2D()
    g = cfg.grid
    solid = _container(cfg, device)
    rng = np.random.default_rng(seed)
    lo = [m + 2.5 * g.dx for m in g.bound_min]
    size = [0.35 * g.bound_size[0], 0.6 * g.bound_size[1]]
    nx, ny = (int(s / cfg.particle_dx) for s in size)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    pos = np.stack([lo[0] + (ii.ravel() + 0.5) * cfg.particle_dx, lo[1] + (jj.ravel() + 0.5) * cfg.particle_dx],
                   axis=-1).astype(np.float32)
    pdx = cfg.particle_dx
    return cfg, _scene(cfg, solid, pos, lambda shape: rng.standard_normal(shape).astype(np.float32) * (pdx * 0.3),
                       pdx, device)


def droplet_scene_2d(cfg: SimConfig2D | None = None, seed: int = 0, device="cuda"):
    """A disc of fluid falling into a shallow pool; returns (cfg, state)."""
    cfg = cfg or SimConfig2D()
    g = cfg.grid
    solid = _container(cfg, device)
    rng = np.random.default_rng(seed)
    pdx = cfg.particle_dx
    # shallow pool across the floor
    lo = [m + 2.5 * g.dx for m in g.bound_min]
    nx, ny = int((g.bound_size[0] - 5 * g.dx) / pdx), int(0.15 * g.bound_size[1] / pdx)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    pool = np.stack([lo[0] + (ii.ravel() + 0.5) * pdx, lo[1] + (jj.ravel() + 0.5) * pdx], axis=-1)
    # droplet disc
    cx = g.bound_min[0] + 0.5 * g.bound_size[0]
    cy = g.bound_min[1] + 0.7 * g.bound_size[1]
    r = 0.12 * min(g.bound_size)
    nd = int(2 * r / pdx) + 1
    di, dj = np.meshgrid(np.arange(nd), np.arange(nd), indexing="ij")
    drop = np.stack([cx - r + (di.ravel() + 0.5) * pdx, cy - r + (dj.ravel() + 0.5) * pdx], axis=-1)
    drop = drop[np.linalg.norm(drop - [cx, cy], axis=1) <= r]
    pos = np.concatenate([pool, drop]).astype(np.float32)
    # the jitter rounds as (r * pdx) * 0.3 here, r * (pdx * 0.3) in the dam break (as in the JAX scenes)
    return cfg, _scene(cfg, solid, pos, lambda shape: rng.standard_normal(shape).astype(np.float32) * pdx * 0.3,
                       pdx, device)


def _levelsets_2d(px, cfg: SimConfig2D):
    g = cfg.grid
    lphi = compute_fluid_levelset(px, g.res, g.bound_min, g.cell_size, g.dx)
    lvol = compute_fluid_volume(px, cfg.particle_dx**2, g.dual_res, g.bound_min, g.dual_cell_size)
    return lphi, lvol


def step_2d(state: SimState, cfg: SimConfig2D) -> Tuple[SimState, Dict[str, torch.Tensor]]:
    """One 2D step on the device of the state's tensors (JAX ``step_2d``)."""
    g, ph, sol = cfg.grid, cfg.physics, cfg.solver
    p = state.particles
    dev = p.x.device
    sphi, sv = state.solid.phi, state.solid.v

    if cfg.dt_mode == "cfl":
        vmax = torch.amax(rounded_sqrt(torch.sum(p.v**2, dim=-1)))
        dt = torch.minimum(const(ph.dt, torch.float32, dev), torch.div(g.dx, torch.clamp(vmax, min=1e-10)))
    else:
        dt = const(ph.dt, torch.float32, dev)

    px = sdf2d.project_2d(state.solid.rb, p.x + p.v * dt)
    w_faces = compute_solid_frac_2d(sphi)

    lphi, lvol = _levelsets_2d(px, cfg)
    dres = density_solve_2d(
        ph.rho, dt, px, p.m, cfg.particle_dx**2, sphi, lphi, lvol, w_faces, g.bound_min, g.cell_size,
        tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter, jacobi_precond=sol.jacobi_precond,
    )
    px = dres.px
    lphi, lvol = _levelsets_2d(px, cfg)

    gm, gv = [], []
    for a in range(2):
        fshape = tuple(n + (1 if i == a else 0) for i, n in enumerate(g.res))
        m_a, v_a = p2g_axis(px, p.m, p.v, p.c[:, a, :], a, g.res, fshape, _FACE_BIAS[a], g.bound_min, g.cell_size)
        gm.append(m_a)
        gv.append(v_a)
    gv[1] = gv[1] + ph.gravity * dt

    visc_iters = torch.zeros((), dtype=torch.int32, device=dev)
    if ph.mu > 0:
        vres = viscosity_solve_2d(
            dt, ph.mu, ph.rho, tuple(gv), sphi, lvol, g.cell_vol,
            tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter, jacobi_precond=sol.jacobi_precond,
        )
        gv = list(vres.v_faces)
        visc_iters = vres.stats.iters

    pres = pressure_solve_2d(
        tuple(gv), sv, lphi, w_faces, g.cell_size,
        tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter, jacobi_precond=sol.jacobi_precond,
    )
    gv = list(pres.v_faces)
    for a in range(2):
        gv[a], _ = extrapolate(gv[a], gm[a] > 0, 2)
    gv = list(apply_boundary_condition(gv, gm, sphi, sv, g.dx))

    pv_cols, pc_rows = [], []
    for a in range(2):
        pv_a, pc_a = g2p_axis(px, gv[a], a, g.res, _FACE_BIAS[a], g.bound_min, g.cell_size)
        pv_cols.append(pv_a)
        pc_rows.append(pc_a)
    new_state = SimState(
        particles=Particles(x=px, v=torch.stack(pv_cols, dim=-1), c=torch.stack(pc_rows, dim=1), m=p.m),
        solid=state.solid,
        t=state.t + dt,
        step_idx=state.step_idx + 1,
        visc_mg=torch.zeros((), dtype=torch.int32, device=dev),  # the JAX 2D state keeps the default 0
    )
    metrics = {
        "dt": dt,
        "density_iters": dres.stats.iters,
        "viscosity_iters": visc_iters,
        "pressure_iters": pres.stats.iters,
    }
    return new_state, metrics


class StepReplayer2D(StepReplayer):
    """`engine/step.py::StepReplayer` over `step_2d`: one CUDA graph a
    state's shapes, the generic CG loops as WHILE nodes.  The 2D step
    reads no geometry cache and has no 'auto' branch."""

    needs_geom = False

    def run(self, state: SimState, branch):
        return step_2d(state, self.cfg)

    def branch(self, visc_mg) -> None:
        return None


def make_step_2d(cfg: SimConfig2D):
    """The 2D step with a static config (JAX ``make_step_2d``): on CUDA
    the first call on a state's shapes captures `step_2d` into a CUDA
    graph and every call replays it (the returned state and metrics are
    clones no later replay writes; ``step.replayers`` holds the captures);
    on the CPU the eager `step_2d`."""
    replayed = replaying_step(cfg, replayer=StepReplayer2D)

    def step(state: SimState):
        if state.particles.x.device.type != "cuda":
            return step_2d(state, cfg)
        return replayed(state)

    step.replayers = replayed.replayers
    return step


def simulate_2d(state: SimState, cfg: SimConfig2D, num_steps: int):
    """Run `num_steps` 2D steps (JAX ``simulate_2d``): (final state,
    metrics stacked over the steps).  On CUDA the step is captured once
    and replayed, each replay's state copied into the next's inputs on the
    device; the capture outlives the call (``simulate_2d.capture``, a
    `SimulateCapture` of `StepReplayer2D`).  On the CPU the steps run
    eagerly."""
    history = []
    if num_steps > 0 and state.particles.x.device.type == "cuda":
        state, history = simulate_2d.capture.run(state, cfg, num_steps)
    else:
        for _ in range(num_steps):
            state, m = step_2d(state, cfg)
            history.append(m)
    return state, stack_metrics(history)


simulate_2d.capture = SimulateCapture(StepReplayer2D)
