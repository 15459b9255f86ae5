"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/cuda_stencils.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

The 7-point cell systems: Jacobi-PCG and the matvec, CUDA kernels +
plain versions.

`cell_poisson_pcg` replaces ``python_fluid_simulation_tpu/ops/
pallas_stencils.py::make_stencil_cg`` (the whole Jacobi-PCG for the
ghost-fluid cell system, pressure and density, from x0 = 0, every CG
vector in VMEM) and `fused_poisson_pcg` replaces ``pallas_cg.py::
make_fused_coupled_cg`` with F = 1 (through ``make_fused_poisson_cg``:
the same Jacobi-PCG from an initial guess x0, streamed through VMEM).
Both launch one kernel, ``csrc/poisson_pcg.cu`` (a null x0 for x0 = 0,
which reads no x0 field): one cooperative persistent launch a solve
whose init builds, on the device, the ascending list of the system's
live cells (a nonzero row, or a nonzero initial residual) and whose
iterations walk only that list, two grid barriers an iteration (the direction update folded into
the matvec phase).  Outside the fluid a row and b are zero, so on those
cells r and d stay 0 and x stays x0 (`poisson_live_cells_plain` builds
the same list in PyTorch).  What bounds it on the H100: the init's one
pass over every cell (~13 floats a cell), then 21 floats a live cell an
iteration, or, where few cells are live, the two grid barriers.
`fused_poisson_pcg`'s thresholds round as the TPU solve loop's
(``cuda_cg.squared_tols``), `cell_poisson_pcg`'s as ``make_stencil_cg``'s
(`squared_tols`).

`stencil_matvec` replaces ``pallas_stencils.py::
make_blocked_stencil_matvec`` and ``::make_stencil_matvec`` (the same
function on whole arrays) (``csrc/stencil_matvec.cu``): one application
q = A p, the operator of the MG-preconditioned and the unpreconditioned
CG, the level-0 smoother of the V-cycle, and the prepared pressure and
density matvecs.  It is bound by bytes (8 fields read, 1 written).

`coupled_stencil_matvec` replaces ``pallas_stencils.py::
make_blocked_coupled_matvec`` and ``::make_coupled_stencil_matvec``
(``csrc/coupled_stencil_matvec.cu``): the coupled viscosity operator
from its 3 diagonals and 42 materialised coefficient fields
(``solvers/viscosity.py::viscosity_term_fields``), one launch for the
three face arrays, bitwise its plain version.  It is bound by bytes (17
floats a face).

Routing: a CUDA tensor launches the kernel; a CPU tensor runs the plain
version (`cell_poisson_pcg_plain`, `fused_poisson_pcg_plain`,
`stencil_matvec_plain`, `coupled_stencil_matvec_plain`: the same
arithmetic in PyTorch), which also serves as the kernel's reference on
the card.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ops import cuda_cg
from portbench.reference.ops.indexing import sample, shift
from portbench.reference.solvers.cg import cg

def squared_tols(tol: float, rel_tol: float):
    """fp32 tol^2 and rel_tol^2 as the TPU kernel rounds them
    (``jnp.float32(tol) ** 2``)."""
    return float(np.float32(tol) ** 2), float(np.float32(rel_tol) ** 2)


def stencil_matvec_plain(diag, coefs, p):
    """A p = diag*p + sum_k coef_k * shift(p, off_k) (0 outside).  p may
    carry a leading batch dim (a stack of independent systems): the
    shifts stay within each system."""
    out = diag * p
    for off, c in coefs:
        out = out + c * shift(p, (0,) * (p.ndim - len(off)) + tuple(off), 0.0)
    return out


def cell_poisson_pcg_plain(b, diag, coefs, pd, *, tol, rel_tol, max_iter):
    """Plain PyTorch version: returns (x, iters, res, res0, thresh)."""
    tol2, rel2 = squared_tols(tol, rel_tol)
    (x,), stats, thresh, _ = cg(
        lambda v: (stencil_matvec_plain(diag, coefs, v[0]),),
        (b,), (torch.zeros_like(b),),
        tol2=tol2, rel2=rel2, max_iter=max_iter,
        precond=lambda r: (r[0] / pd,),
    )
    return x, stats.iters, stats.residual, stats.initial_residual, thresh


def fused_poisson_pcg_plain(b, x0, diag, coefs, pd, *, tol, rel_tol, max_iter):
    """Plain PyTorch version of `fused_poisson_pcg` (x0 None: zeros):
    returns (x, iters, res, res0, thresh)."""
    tol2, rel2 = cuda_cg.squared_tols(tol, rel_tol)
    (x,), stats, thresh, _ = cg(
        lambda v: (stencil_matvec_plain(diag, coefs, v[0]),),
        (b,), (torch.zeros_like(b) if x0 is None else x0,),
        tol2=tol2, rel2=rel2, max_iter=max_iter,
        precond=lambda r: (r[0] / pd,),
    )
    return x, stats.iters, stats.residual, stats.initial_residual, thresh


def poisson_live_cells_plain(b, x0, diag, coefs):
    """The live cells of a 7-point system as ``csrc/poisson_pcg.cu``'s
    init flags them: a nonzero row (diag or a coefficient) or a nonzero
    r0 = b - A x0 (x0 None: x0 = 0, r0 = b).  Returns their flat indices,
    ascending (int64)."""
    r0 = b if x0 is None else b - stencil_matvec_plain(diag, coefs, x0)
    live = (r0 != 0) | (diag != 0)
    for _, c in coefs:
        live = live | (c != 0)
    return torch.nonzero(live.reshape(-1)).reshape(-1)


def batched(shape):
    """(B, X, Y, Z) of a single grid (B = 1) or of a stack."""
    return tuple(shape) if len(shape) == 4 else (1, *shape)


def stencil_matvec(diag, coefs, p):
    """q = A p for the 7-point system (the plain version)."""
    return stencil_matvec_plain(diag, coefs, p)


def cell_poisson_pcg(b, diag, coefs, pd, *, tol, rel_tol, max_iter):
    """Jacobi-PCG of the 7-point system from x0 = 0 (the plain version)."""
    return cell_poisson_pcg_plain(b, diag, coefs, pd, tol=tol, rel_tol=rel_tol, max_iter=max_iter)


def fused_poisson_pcg(b, x0, diag, coefs, pd, *, tol, rel_tol, max_iter):
    """Jacobi-PCG of the 7-point system from x0 (the plain version)."""
    return fused_poisson_pcg_plain(b, x0, diag, coefs, pd, tol=tol, rel_tol=rel_tol, max_iter=max_iter)


def coupled_stencil_matvec_plain(diags, per_axis, vs):
    """A v for the coupled viscosity operator from its materialised
    fields: per axis a, diag_a * v_a, then each (field, voff, coef) of
    per_axis[a] adds coef * v_field sampled at voff (0 outside v_field)."""
    out = []
    for a in range(len(vs)):
        acc = diags[a] * vs[a]
        for field, voff, coef in per_axis[a]:
            acc = acc + coef * sample(vs[field], voff, vs[a].shape, 0.0)
        out.append(acc)
    return tuple(out)


def coupled_stencil_matvec(diags, per_axis, vs, *, packed=None):
    """q = A v for the coupled viscosity operator (the plain version)."""
    return coupled_stencil_matvec_plain(diags, per_axis, vs)

