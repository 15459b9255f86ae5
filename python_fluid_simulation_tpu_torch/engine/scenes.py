"""Scene presets.

Counterpart of ``python_fluid_simulation_tpu.engine.scenes``.  The
reference (notebook cell 10, :650-812) builds one scene — the 3D
viscous-buckling funnel; the coiling column is the JAX package's
high-viscosity scene (BASELINE config 5); the dam break is a small scene
for the golden regression; the moving box drives a moving solid
(``SimConfig.moving_solid``).  Scenes map a SimConfig to a SimState on
``device``.
"""

from __future__ import annotations

import dataclasses

import torch

from python_fluid_simulation_tpu_torch.config import (
    GridConfig3D,
    PhysicsConfig,
    SimConfig,
    SolverConfig,
)
from python_fluid_simulation_tpu_torch.ops.sdf import RigidBodySet
from python_fluid_simulation_tpu_torch.state import (
    SimState,
    make_particles,
    make_solid_state,
    seed_particle_box,
)


def buckling_rigid_bodies() -> RigidBodySet:
    """Flipped box container + 4 tilted boxes forming a funnel hole.

    Reference: cell 10 :682-689 (obs_height = 0.7).
    """
    rbs = RigidBodySet()
    rbs.add("cube", "box", [0.5, 0.8, 0.5], flip=True, center=[0, 0.5, 0], axis=[0, 1, 0], angle=0)
    h = 0.7
    rbs.add("cube1", "box", [0.67, 0.1, 1.0], center=[-0.34, h, 0], axis=[0, 0, 1], angle=-45)
    rbs.add("cube2", "box", [0.67, 0.1, 1.0], center=[0.34, h, 0], axis=[0, 0, 1], angle=45)
    rbs.add("cube3", "box", [1.0, 0.1, 0.7], center=[0, h, -0.3], axis=[1, 0, 0], angle=45)
    rbs.add("cube4", "box", [1.0, 0.1, 0.7], center=[0, h, 0.3], axis=[1, 0, 0], angle=-45)
    return rbs


def buckling_config(dx: float = 0.0125, mu: float = 1.0, viscosity_mode: str = "apic", dt_mode: str = "cfl") -> SimConfig:
    """The reference scene: domain 0.6x1.0x0.6, GRES 48x80x48 at default dx."""
    return SimConfig(
        grid=GridConfig3D(bound_min=(-0.3, 0.0, -0.3), bound_size=(0.6, 1.0, 0.6), dx=dx),
        physics=PhysicsConfig(rho=1000.0, mu=mu, dt=1.0 / 300.0),
        solver=SolverConfig(viscosity_mode=viscosity_mode),
        particle_dx=dx / 2.0,
        dt_mode=dt_mode,
        duration=3.0,
    )


def scaled_buckling_config(res: int = 128, **kw) -> SimConfig:
    """The buckling scene scaled to res^3-class grids (dx chosen so the
    tallest axis has `res` cells; BASELINE configs 3/5).  From 96^3 up the
    CG cap is 600 and the cell-Poisson solves take `_poisson_precond`."""
    base = buckling_config(dx=1.0 / res, **kw)
    solver = base.solver
    if res >= 96:
        solver = dataclasses.replace(solver, max_iter=600, precond=_poisson_precond(base.grid.res))
    return dataclasses.replace(base, particle_dx=0.5 / res, solver=solver)


def _poisson_precond(grid_res) -> str:
    """Cell-Poisson preconditioner for a 96^3-class-or-larger grid:
    multigrid up to 4M cells, Jacobi above (the configuration's meaning
    in the JAX package: two MG hierarchies a step outgrow device memory
    there, and big grids start pressure-easy)."""
    cells = 1
    for n in grid_res:
        cells *= int(n)
    return "mg" if cells <= 4_000_000 else "jacobi"


def coiling_config(res: int = 256, mu: float = 5.0) -> SimConfig:
    """BASELINE config 5: high-viscosity coiling — a tall thin column of
    very viscous fluid falling onto the container floor (rope coiling).
    Domain 0.3 x 1.2 x 0.3 so `res` is the vertical cell count (64x256x64
    at the default).  From 96 up the CG cap is 600, the viscosity solve
    takes the 'auto' preconditioner (Jacobi-PCG while it converges
    cheaply; the batched block MG once the pooled fluid makes Jacobi
    slow or fail, by the hysteresis on SimState.visc_mg) and the
    cell-Poisson solves take `_poisson_precond`."""
    base = SimConfig(
        grid=GridConfig3D(bound_min=(-0.15, 0.0, -0.15), bound_size=(0.3, 1.2, 0.3), dx=1.2 / res),
        physics=PhysicsConfig(rho=1000.0, mu=mu, dt=1.0 / 300.0),
        solver=SolverConfig(),
        particle_dx=0.6 / res,
        dt_mode="cfl",
        duration=3.0,
    )
    solver = base.solver
    if res >= 96:
        solver = dataclasses.replace(
            solver, max_iter=600, viscosity_precond="auto", precond=_poisson_precond(base.grid.res),
        )
    return dataclasses.replace(base, solver=solver)


def coiling_scene(cfg: SimConfig | None = None, seed: int = 0, device="cuda") -> SimState:
    """Container + a thin tall fluid column centred in the domain."""
    cfg = cfg or coiling_config()
    g = cfg.grid
    rbs = RigidBodySet()
    c = [m + 0.5 * s for m, s in zip(g.bound_min, g.bound_size)]
    rbs.add("container", "box", [s - 4 * g.dx for s in g.bound_size], flip=True, center=c)
    column_w = 0.12 * g.bound_size[0] + 4 * cfg.particle_dx
    return _state(
        cfg, rbs, [0.0, g.bound_min[1] + 0.75 * g.bound_size[1], 0.0],
        [column_w, 0.4 * g.bound_size[1], column_w], seed, device,
    )


def _state(cfg, rbs, center, size, seed, device):
    solid = make_solid_state(cfg, rbs, device=device)
    pos = seed_particle_box(center=center, size=size, dx=cfg.particle_dx, rb_table=solid.rb, seed=seed)
    return SimState(
        particles=make_particles(pos, cfg.physics.rho, cfg.particle_dx, device=device),
        solid=solid,
        t=torch.zeros((), dtype=torch.float32, device=device),
        step_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def buckling_scene(cfg: SimConfig | None = None, seed: int = 0, device="cuda") -> SimState:
    """Reference scene state: fluid = jittered 0.3^3 box at (0, 0.65, 0)."""
    cfg = cfg or buckling_config()
    return _state(cfg, buckling_rigid_bodies(), [0.0, 0.65, 0.0], [0.3, 0.3, 0.3], seed, device)


def dam_break_scene(cfg: SimConfig | None = None, seed: int = 0, device="cuda") -> SimState:
    """A simple 3D dam break in a flipped-box container."""
    cfg = cfg or SimConfig(
        grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1 / 48),
        physics=PhysicsConfig(mu=0.0),
        particle_dx=1 / 96,
        duration=2.0,
    )
    g = cfg.grid
    rbs = RigidBodySet()
    c = [m + 0.5 * s for m, s in zip(g.bound_min, g.bound_size)]
    rbs.add("container", "box", [s - 4 * g.dx for s in g.bound_size], flip=True, center=c)
    lo = [m + 2.5 * g.dx for m in g.bound_min]
    size = [0.35 * s for s in g.bound_size]
    return _state(cfg, rbs, [lo[i] + 0.5 * size[i] for i in range(3)], size, seed, device)


def moving_box_config(dx: float = 1.0 / 16, mu: float = 0.2) -> SimConfig:
    """A descending box obstacle over a pool: the moving-solid path
    (``SimConfig.moving_solid``; the reference's transform_rb / set_vel_rb
    API, sdf3D.py:329-336, driven inside the step)."""
    return SimConfig(
        grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=dx),
        physics=PhysicsConfig(rho=1000.0, mu=mu, dt=1.0 / 120.0),
        solver=SolverConfig(max_iter=300),
        particle_dx=dx / 2,
        dt_mode="cfl",
        duration=1.0,
        moving_solid=True,
    )


def moving_box_scene(cfg: SimConfig | None = None, seed: int = 0, device="cuda") -> SimState:
    """Container + bottom pool + a box sinking toward the surface at
    0.5 m/s (its velocity row drives both the per-step translation and the
    solid velocity in the solves)."""
    cfg = cfg or moving_box_config()
    g = cfg.grid
    rbs = RigidBodySet()
    c = [m + 0.5 * s for m, s in zip(g.bound_min, g.bound_size)]
    rbs.add("container", "box", [s - 4 * g.dx for s in g.bound_size], flip=True, center=c)
    rbs.add("sinker", "box", [0.3, 0.2, 0.3], center=[c[0], g.bound_min[1] + 0.72 * g.bound_size[1], c[2]],
            velocity=[0.0, -0.5, 0.0])
    return _state(
        cfg, rbs, [c[0], g.bound_min[1] + 0.25 * g.bound_size[1], c[2]],
        [g.bound_size[0] - 5 * g.dx, 0.35 * g.bound_size[1], g.bound_size[2] - 5 * g.dx], seed, device,
    )
