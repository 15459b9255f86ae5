"""The whole step's floor: the bytes and operations the algorithm of one
step has to move and compute, with the step's own solver iterations.

Each array of the algorithm is counted read once where a stage reads it
and written once where a stage writes it, at the algorithm's own widths
(4-byte floats and indices; K particles, C cells, F faces, D entries of
the (2n+1)^3 dual lattice).  What the program moves beyond that (more
passes, wider rows, caches that miss) is its own cost and is not
counted, so the floor bounds the program's exact byte count
(``python_fluid_simulation_tpu_torch/utils/step_bytes.py``) from below.

Stages, in step order (floats read + written):
- dt from |v|: 3K.  Advection and the solids' projection: x, v -> x: 9K.
- Two cell sorts (one before the density solve, one before P2G): x read,
  a cell id and a permutation written: 5K each.
- Two fluid level sets: x read, the C-cell level set written: 3K + C each.
- Density projection: the mass and volume scatter (x, m -> 2 C), the
  right-hand side (mass, volume, level set and F face weights -> C), the
  7-point system and its Jacobi diagonal (F weights and the level set ->
  8 C), the solve (`counts.pcg.poisson_pcg` on the live cells where the
  solve is Jacobi, the same 21 floats an iteration over every cell where
  it is multigrid, whose cycle does at least that), the displacement (C
  solution and level set -> F) and its gather (3K positions and F -> 3K).
- P2G: x, m, v and the 9 affine entries read (16K), mass and velocity
  on the faces (2F) and the fluid volume on the dual lattice (D) written.
- Viscosity: the right-hand side (F velocities, D volume, D solid level
  set -> F), the Jacobi diagonal (D -> F), the solve (`counts.pcg.
  coupled_pcg`), the update (2F -> F).
- Pressure: the right-hand side (F velocities, F solid velocities, F
  weights, C level set -> C), the system (F weights, C level set -> 8 C),
  the solve, the update (C solution, 2F, C -> F).
- Two extrapolation passes (velocity and mass -> velocity: 3F each) and
  the boundary condition (velocity, mass, solid level set and velocity on
  the faces -> velocity: 5F).
- G2P: x and F face velocities read, v and the affine rows written: 3K +
  F + 12K.

Operations are counted for the solves alone (`counts.pcg`'s per
iteration counts, and 27 a cell an iteration of a multigrid cell solve);
they are a floor, and bytes bound every step measured here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from portbench.counts.pcg import coupled_pcg, face_count, poisson_pcg

FLOAT = 4


def step_floor(res: Sequence[int], particles: int, iters: dict, cell_precond: str,
               live: Optional[dict] = None) -> dict:
    """{'bytes', 'flops'} of one step.  ``iters``: the step's (or a
    window's mean) ``density_iters``, ``viscosity_iters`` and
    ``pressure_iters``; ``cell_precond``: 'jacobi' or 'mg';
    ``live``: the two cell systems' live cells (``density_live``,
    ``pressure_live``), needed where the cell solves are Jacobi."""
    k = int(particles)
    c = math.prod(int(n) for n in res)
    f = face_count(res)
    d = math.prod(2 * int(n) + 1 for n in res)

    def cell_solve(name):
        it = float(iters[f"{name}_iters"])
        if cell_precond == "jacobi":
            if live is None:
                raise ValueError("a Jacobi cell solve's floor needs its live cells")
            return poisson_pcg(res, float(live[f"{name}_live"]), it)
        return poisson_pcg(res, float(c), it)

    floats = 0
    floats += 3 * k + 9 * k  # dt, advection and projection
    floats += 2 * 5 * k  # two sorts
    floats += 2 * (3 * k + c)  # two level sets
    floats += (4 * k + 2 * c) + (3 * c + f + c) + (f + c + 8 * c) + (2 * c + f) + (3 * k + f + 3 * k)  # density
    floats += 16 * k + 2 * f + d  # P2G
    floats += (f + 2 * d + f) + (d + f) + 3 * f  # viscosity around its solve
    floats += (3 * f + c + c) + (f + c + 8 * c) + (2 * c + 2 * f + f)  # pressure around its solve
    floats += 2 * 3 * f + 5 * f  # extrapolation, boundary condition
    floats += 3 * k + f + 12 * k  # G2P
    nbytes = FLOAT * floats
    flops = 0.0
    for name in ("density", "pressure"):
        b, o = cell_solve(name)
        nbytes += b
        flops += o
    if float(iters["viscosity_iters"]) > 0:
        b, o = coupled_pcg(res, float(iters["viscosity_iters"]))
        nbytes += b
        flops += o
    return {"bytes": float(nbytes), "flops": float(flops)}
