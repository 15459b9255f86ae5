"""[Frozen copy of ``python_fluid_simulation_tpu_torch/state.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Simulation state: particles, solid level set, step counters.

Counterpart of ``python_fluid_simulation_tpu.state``.  Grid fields are
transient (rebuilt from particles by P2G every step), so only particle
state, the solid level set and the rigid-body table persist.  fp32
throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from portbench.reference.config import SimConfig
from portbench.reference.ops import sdf as sdf3d
from portbench.reference.ops.indexing import grid_positions


@dataclasses.dataclass
class Particles:
    """APIC particle set (reference cell 10 :705-714).

    c[:, a, :] is the affine row for velocity component a.
    """

    x: torch.Tensor  # (N, d) positions
    v: torch.Tensor  # (N, d) velocities
    c: torch.Tensor  # (N, d, d) APIC affine rows
    m: torch.Tensor  # (N,) masses


@dataclasses.dataclass
class SolidState:
    """Solid level set on the dual lattice + rigid-body table
    (reference cell 10 :747-756)."""

    phi: torch.Tensor  # (2N+1)^d
    v: torch.Tensor  # (2N+1)^d + (d,)
    rb: torch.Tensor  # (B, 10, 4)


@dataclasses.dataclass
class SimState:
    particles: Particles
    solid: SolidState
    t: torch.Tensor  # 0-dim f32 simulated time
    step_idx: torch.Tensor  # 0-dim i32
    # viscosity preconditioner hysteresis flag (0 = Jacobi, 1/2 = MG),
    # carried for SolverConfig.viscosity_precond='auto'
    visc_mg: torch.Tensor | int = 0


def make_solid_state(cfg: SimConfig, rbs: "sdf3d.RigidBodySet", device="cuda") -> SolidState:
    """Evaluate the rigid-body SDF onto the dual lattice (cell 10 :791)."""
    g = cfg.grid
    pos = grid_positions(
        g.dual_res, g.bound_min, g.dual_cell_size, (0.0,) * len(g.dual_res),
        device=device,
    )
    rb = rbs.table(device=device)
    phi, vel = sdf3d.evaluate(rb, pos)
    return SolidState(phi=phi, v=vel, rb=rb)


def seed_particle_box(center, size, dx: float, rb_table=None, jitter: float = 0.3, seed: int = 0) -> np.ndarray:
    """Jittered particle block, filtered to outside solids.

    Reference: add_box + oob_filter (cell 10 :662-699): grid of spacing dx,
    solid filter BEFORE jitter, then gaussian jitter of dx*jitter from a
    numpy generator (so both packages seed the same positions).
    """
    center = np.asarray(center, dtype=np.float32)
    size = np.asarray(size, dtype=np.float32)
    dim = center.shape[0]
    box_min = center - 0.5 * size
    grid_dim = (size / dx).astype(np.int64)
    axes = [np.arange(n) for n in grid_dim]
    idx = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).astype(np.float32)
    pos = box_min + size * ((idx + 0.5) / grid_dim)
    pos = pos.reshape(-1, dim)
    if rb_table is not None and rb_table.shape[0] > 0:
        sd, _ = sdf3d.evaluate(torch.as_tensor(rb_table).cpu(), torch.from_numpy(pos))
        pos = pos[sd.numpy() >= 0]
    rng = np.random.default_rng(seed)
    return pos + rng.standard_normal(pos.shape).astype(np.float32) * dx * jitter


def make_particles(positions: np.ndarray, rho: float, pdx: float, device="cuda") -> Particles:
    n, d = positions.shape
    return Particles(
        x=torch.as_tensor(positions, dtype=torch.float32, device=device),
        v=torch.zeros((n, d), dtype=torch.float32, device=device),
        c=torch.zeros((n, d, d), dtype=torch.float32, device=device),
        m=torch.full((n,), rho * pdx**d, dtype=torch.float32, device=device),
    )


def face_shapes(gres) -> Tuple[Tuple[int, ...], ...]:
    d = len(gres)
    return tuple(
        tuple(n + (1 if i == a else 0) for i, n in enumerate(gres)) for a in range(d)
    )
