"""Preconditioned conjugate gradients over tuples of tensors.

Counterpart of ``python_fluid_simulation_tpu.solvers.cg``: the same update
order and exit rule as the reference (break when ||r||^2 < tol^2;
PressureCGSolver3D.py:206-221), with the relative floor
rel_tol^2 * ||r0||^2 against fp32 stagnation:

    loop while  res >= max(tol^2, rel_tol^2 * res0)  and  k < max_iter
                and  delta != 0

This loop tests its scalars on the host every iteration, so it is the
plain version of the solver kernels (``ops/cuda_stencils.py``,
``ops/cuda_cg.py``), which run the whole loop on the device.
Non-convergence is reported in `SolveStats`, not raised.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SolveStats(NamedTuple):
    iters: torch.Tensor  # int32
    residual: torch.Tensor  # final ||r||^2 (f32)
    initial_residual: torch.Tensor  # ||r0||^2
    converged: torch.Tensor  # bool


def tree_dot(a, b) -> torch.Tensor:
    """Sum of the fp32 dot products of matching tensors of two tuples."""
    out = None
    for x, y in zip(a, b):
        v = torch.sum(x * y)
        out = v if out is None else out + v
    return out


def threshold(tol2, rel2, res0) -> torch.Tensor:
    """max(tol^2, rel_tol^2 * res0) in fp32, from fp32 tol2 and rel2."""
    return torch.clamp(rel2 * res0, min=tol2)


def cg(
    matvec: Callable,
    b,
    x0,
    *,
    tol2: float,
    rel2: float,
    max_iter: int,
    precond: Callable | None = None,
):
    """Solve A x = b for tuples of tensors.

    ``tol2`` and ``rel2`` are the squared tolerances as fp32 values (their
    rounding follows the JAX function each caller stands in for).
    Returns (x, SolveStats, threshold, r) with r the final residual.
    """
    q0 = matvec(x0)
    r = tuple(bb - q for bb, q in zip(b, q0))
    z = precond(r) if precond is not None else r
    delta = tree_dot(r, z)
    res0 = tree_dot(r, r) if precond is not None else delta
    thresh = threshold(tol2, rel2, res0)
    x, d, res, k = tuple(x0), z, res0, 0
    while bool(res >= thresh) and k < max_iter and bool(delta != 0):
        q = matvec(d)
        dq = tree_dot(d, q)
        alpha = torch.where(dq != 0, delta / dq, torch.zeros_like(dq))
        x = tuple(alpha * dd + xx for dd, xx in zip(d, x))
        r = tuple(-alpha * qq + rr for qq, rr in zip(q, r))
        z = precond(r) if precond is not None else r
        new_delta = tree_dot(r, z)
        res = tree_dot(r, r) if precond is not None else new_delta
        beta = torch.where(delta != 0, new_delta / delta, torch.zeros_like(delta))
        d = tuple(beta * dd + zz for dd, zz in zip(d, z))
        delta = new_delta
        k += 1
    stats = SolveStats(
        iters=torch.tensor(k, dtype=torch.int32, device=res0.device),
        residual=res,
        initial_residual=res0,
        converged=res < thresh,
    )
    return x, stats, thresh, r
