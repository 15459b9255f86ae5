"""[Frozen copy of ``python_fluid_simulation_tpu_torch/solvers/cg.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Preconditioned conjugate gradients over tuples of tensors.

Counterpart of ``python_fluid_simulation_tpu.solvers.cg``: the same update
order and exit rule as the reference (break when ||r||^2 < tol^2;
PressureCGSolver3D.py:206-221), with the relative floor
rel_tol^2 * ||r0||^2 against fp32 stagnation:

    loop while  res >= max(tol^2, rel_tol^2 * res0)  and  k < max_iter
                and  delta != 0

The loop body is one function over the carried tensors
(`cg_iteration`).  Eagerly the loop tests its scalars on the host every
iteration (one read), so it is the plain version of the solver kernels
(``ops/cuda_stencils.py``, ``ops/cuda_cg.py``), which run the whole loop
on the device.  While the current stream is being captured into a CUDA
graph (``engine/step.py::make_step``) the same body is recorded once as
the body of a WHILE node whose test runs on the device
(``ops/cuda_graph.py::captured_while``), as the JAX package's
``lax.while_loop`` keeps it there.  Both count the iterations in a device
int32 ``k``.  Non-convergence is reported in `SolveStats`, not raised.
`loop` runs any such body either way; the distributed solves
(``parallel/halo.py``) loop their own bodies through it, their delta,
res, k and threshold tuples of replicas, one a device: the host loop
tests the first, and under capture each device gets a WHILE node of its
own that tests its replicas.
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


class CGCarry(NamedTuple):
    """What one CG iteration carries to the next."""

    x: tuple
    r: tuple
    d: tuple  # search direction
    delta: torch.Tensor  # <r, z>
    res: torch.Tensor  # ||r||^2 (f32)
    k: torch.Tensor  # iterations done (int32)


def cg_init(matvec: Callable, b, x0, *, tol2: float, rel2: float, precond: Callable | None = None):
    """The carry before the first iteration from x0, with ||r0||^2 and the
    exit threshold: (CGCarry, res0, thresh)."""
    q0 = matvec(x0)
    r = tuple(bb - q for bb, q in zip(b, q0))
    z = precond(r) if precond is not None else r
    delta = tree_dot(r, z)
    res0 = tree_dot(r, r) if precond is not None else delta
    thresh = threshold(tol2, rel2, res0)
    k = torch.zeros((), dtype=torch.int32, device=res0.device)
    return CGCarry(tuple(x0), r, z, delta, res0, k), res0, thresh


def cg_iteration(carry: CGCarry, matvec: Callable, precond: Callable | None = None) -> CGCarry:
    """One CG iteration, the loop body; ``k`` is passed through (the loop
    counts it)."""
    x, r, d, delta, _, k = carry
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
    return CGCarry(x, r, d, new_delta, res, k)


def loop(carry: CGCarry, thresh, max_iter: int, iteration: Callable) -> CGCarry:
    """``while res >= thresh and k < max_iter and delta != 0: carry =
    iteration(carry); k += 1``, tested on the host every iteration."""
    n = 0
    while n < max_iter and bool((carry.res >= thresh) & (carry.delta != 0)):
        carry = iteration(carry)
        carry = carry._replace(k=carry.k + 1)
        n += 1
    return carry


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
    carry, res0, thresh = cg_init(matvec, b, x0, tol2=tol2, rel2=rel2, precond=precond)
    carry = loop(carry, thresh, max_iter, lambda c: cg_iteration(c, matvec, precond))
    stats = SolveStats(
        iters=carry.k,
        residual=carry.res,
        initial_residual=res0,
        converged=carry.res < thresh,
    )
    return carry.x, stats, thresh, carry.r
