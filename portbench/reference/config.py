"""[Frozen copy of ``python_fluid_simulation_tpu_torch/config.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Static configuration for scenes and solvers.

A field-for-field copy of ``python_fluid_simulation_tpu.config``, so one
JSON/YAML config file drives both packages.  The reference keeps
configuration as module-level notebook constants
(``3D_viscous_fluid_sim.ipynb`` cell 10 :651-660: BOUND_MIN/SIZE, GDX, PDX,
RHO, MU, DT) plus a ``solver`` string flag (cell 1 :83).

``SolverConfig.pallas`` is kept for file compatibility only: in this
package the device of the tensors alone picks the kernel or its plain
version, so the field routes nothing.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


def _round_res(size, dx) -> Tuple[int, ...]:
    # Reference: GRES = (BOUND_SIZE / GDX).astype(int64) (cell 10 :656) —
    # with f32 device math 0.6/0.0125 lands exactly on 48; Python f64
    # gives 47.99999... so round to the nearest integer.
    return tuple(int(round(s / dx)) for s in size)


@dataclasses.dataclass(frozen=True)
class GridConfig3D:
    """MAC-grid geometry. Reference: cell 10 state containers (:717-743)."""

    bound_min: Tuple[float, float, float] = (-0.3, 0.0, -0.3)
    bound_size: Tuple[float, float, float] = (0.6, 1.0, 0.6)
    dx: float = 0.0125

    @property
    def res(self) -> Tuple[int, int, int]:
        return _round_res(self.bound_size, self.dx)

    @property
    def cell_size(self) -> Tuple[float, float, float]:
        r = self.res
        return tuple(s / n for s, n in zip(self.bound_size, r))

    @property
    def cell_vol(self) -> float:
        cs = self.cell_size
        return cs[0] * cs[1] * cs[2]

    @property
    def dual_res(self) -> Tuple[int, int, int]:
        """The (2N+1)^3 dual ("fine") lattice holding sphi / sv / lvol.

        Reference: cell 10 ``SOL_ARRES = 2*GRES + 1`` (:747) — cell centers
        live at odd/odd/odd parities, x-faces at even/odd/odd, etc.
        """
        return tuple(2 * n + 1 for n in self.res)

    @property
    def dual_cell_size(self) -> Tuple[float, float, float]:
        return tuple(c * 0.5 for c in self.cell_size)

    def face_res(self, axis: int) -> Tuple[int, int, int]:
        r = list(self.res)
        r[axis] += 1
        return tuple(r)


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Reference: cell 10 :658-660 (RHO=1000, MU=1.0, DT=1/300, g=-10)."""

    rho: float = 1000.0
    mu: float = 1.0
    dt: float = 1.0 / 300.0
    gravity: float = -10.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Linear-solver knobs.

    ``tol`` follows the reference's *absolute* tolerance on ||r||^2
    (break when ||r||^2 < tol^2; PressureCGSolver3D.py:192,218).  The
    solves run in fp32, so an additional *relative* floor ``rel_tol``
    guards against fp32 stagnation: the loop exits when
        ||r||^2 < max(tol^2, rel_tol^2 * ||r0||^2).
    ``max_iter`` caps the loop; non-convergence is *reported* in
    SolveStats instead of raising.
    """

    tol: float = 1e-3
    rel_tol: float = 1e-3
    max_iter: int = 600
    jacobi_precond: bool = True
    # 'apic' = classic CG viscosity; 'unet' = learned operator;
    # 'unet_warm' = UNet prediction warm-starts the CG solve (paper mode).
    viscosity_mode: str = "apic"
    # dt-scaled variational pressure assembly (same system scaled by dt).
    pressure_dt_scaled: bool = False
    # kernel route of the JAX package ('auto' / 'on' / 'off'); kept so one
    # config file drives both packages, read by nothing here
    pallas: str = "auto"
    # preconditioner for the cell-centred Poisson solves: 'jacobi' or 'mg'
    precond: str = "jacobi"
    # preconditioner for the coupled viscosity solve: 'jacobi', 'mg' or
    # 'auto' (hysteresis on SimState.visc_mg)
    viscosity_precond: str = "jacobi"
    # 'auto' switchover threshold on the previous step's iteration count
    viscosity_auto_iters: int = 800
    # cell-Poisson MG cycle shape override: (n_smooth, min_dim,
    # coarse_iters), None = solver defaults
    mg_opts: tuple | None = None
    # Reference-bug compatibility switches (SURVEY §7 tracked list). False =
    # fixed behaviour (documented divergence), True = mimic the reference.
    density_wz_bug: bool = False


@dataclasses.dataclass(frozen=True)
class SimConfig:
    grid: GridConfig3D = GridConfig3D()
    physics: PhysicsConfig = PhysicsConfig()
    solver: SolverConfig = SolverConfig()
    # particle seeding spacing (reference PDX = GDX/2 => 8 particles/cell)
    particle_dx: float = 0.00625
    # 'fixed' (unet mode) or 'cfl' (apic mode) dt selection, cell 13 :4572-76
    dt_mode: str = "cfl"
    duration: float = 3.0
    # animate rigid bodies inside the step (reference API: sdf3D.py:329-336)
    moving_solid: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(dataclasses.asdict(self), sort_keys=False)

    @staticmethod
    def from_yaml(s: str) -> "SimConfig":
        import yaml

        return SimConfig.from_json(json.dumps(yaml.safe_load(s)))

    @staticmethod
    def load(path: str) -> "SimConfig":
        """Load a config from a .json or .yaml file (SURVEY §5: the
        reference has no config system — notebook constants only)."""
        with open(path) as f:
            text = f.read()
        if path.endswith((".yaml", ".yml")):
            return SimConfig.from_yaml(text)
        return SimConfig.from_json(text)

    @staticmethod
    def from_json(s: str) -> "SimConfig":
        d = json.loads(s)

        def _tup(x):
            return tuple(x) if isinstance(x, list) else x

        g = d.get("grid", {})
        for k in ("bound_min", "bound_size"):
            if k in g:
                g[k] = _tup(g[k])
        return SimConfig(
            grid=GridConfig3D(**g),
            physics=PhysicsConfig(**d.get("physics", {})),
            solver=SolverConfig(**d.get("solver", {})),
            **{
                k: d[k]
                for k in ("particle_dx", "dt_mode", "duration", "moving_solid")
                if k in d
            },
        )
