"""What the whole-solve PCG kernels' inputs need: bytes and operations
of one solve, frozen from the port's wrappers' formulas
(``ops/cuda_stencils.py::poisson_pcg_bytes``,
``ops/cuda_cg.py::coupled_visc_pcg_bytes``) and ``chip_smoke.py``'s
operation counts.  Each input is counted read once and each output
written once; an iteration counts what these inputs need, not the most
the loop could run.

- The 7-point cell Jacobi-PCG (density and pressure, ``poisson_pcg.cu``):
  b, diag, 6 coefficients and pd read and x written once over the grid's
  N cells (10 floats a cell), then 21 floats and 27 operations a live
  cell an iteration (the matvec over diag, 6 coefficients and d, the
  updates of x, r, d and q, the preconditioner and two dots).  A live
  cell has a nonzero row or right-hand side (outside the fluid a row and
  b are 0 and nothing moves).
- The coupled viscosity Jacobi-PCG (``coupled_visc_pcg.cu``): b, x0 and
  pd read and x written over the F faces, the G geometry entries (7
  volume and 3 level-set parity classes of the dual lattice) read once;
  an iteration streams the geometry once and 12 passes over the faces
  ((G + 12 F) floats) for 85 operations a face.
"""

from __future__ import annotations

import math
from typing import Sequence

VOL_CLASSES = ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
SPHI_CLASSES = ((0, 1, 1), (1, 0, 1), (1, 1, 0))
POISSON_IO_FLOATS = 10
POISSON_LIVE_FLOATS = 21
POISSON_LIVE_OPS = 27
COUPLED_PASSES = 12
COUPLED_FACE_OPS = 85


def face_count(res: Sequence[int]) -> int:
    """Faces of the MAC grid: one more plane along each face's axis."""
    return sum(math.prod(n + (1 if i == a else 0) for i, n in enumerate(res)) for a in range(3))


def geometry_entries(res: Sequence[int]) -> int:
    """Entries of the 10 dual-lattice parity classes the coupled solve reads."""
    return sum(math.prod(n + 1 - p for n, p in zip(res, cls)) for cls in VOL_CLASSES + SPHI_CLASSES)


def poisson_pcg(res: Sequence[int], live: float, iters: float) -> tuple:
    """(bytes, operations) of one cell Jacobi-PCG solve on ``res`` cells
    with ``live`` live cells and ``iters`` iterations."""
    cells = math.prod(res)
    return (4 * (POISSON_IO_FLOATS * cells + iters * POISSON_LIVE_FLOATS * live),
            iters * POISSON_LIVE_OPS * live)


def coupled_pcg(res: Sequence[int], iters: float) -> tuple:
    """(bytes, operations) of one coupled viscosity Jacobi-PCG solve."""
    faces, geom = face_count(res), geometry_entries(res)
    return (4 * ((4 * faces + geom) + iters * (geom + COUPLED_PASSES * faces)),
            iters * COUPLED_FACE_OPS * faces)
