"""Preconditioned conjugate gradients over tuples of tensors.

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

from python_fluid_simulation_tpu_torch.ops.cuda_graph import captured_while


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


def capturing(device: torch.device) -> bool:
    """Whether the current stream of a CUDA ``device`` is being captured
    into a CUDA graph (never on the CPU)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _clone(t):
    return t.clone() if isinstance(t, torch.Tensor) else tuple(_clone(u) for u in t)


def _leaves(t) -> list:
    return [t] if isinstance(t, torch.Tensor) else [leaf for u in t for leaf in _leaves(u)]


def captured_loop(carry: CGCarry, thresh, max_iter: int, iteration: Callable) -> CGCarry:
    """The loop of ``iteration`` (carry -> carry, ``k`` passed through) as
    a WHILE node of the graph being captured (one a device where delta,
    res, k and thresh are tuples of replicas): the carry goes to buffers of
    its own (x0 is the caller's, and without a preconditioner d is r and
    res is delta), which each recorded iteration overwrites in place.  x,
    r and d may nest (a slot's blocks, a field's slots)."""
    buf = CGCarry(*(_clone(f) for f in carry))

    def body():
        new = iteration(buf)
        for dst, src in zip(_leaves(buf[:5]), _leaves(new[:5])):
            dst.copy_(src)

    captured_while(body, buf.k, buf.res, thresh, buf.delta, max_iter)
    return buf


def _captured_loop(carry: CGCarry, thresh, max_iter: int, matvec, precond) -> CGCarry:
    """`captured_loop` of `cg_iteration`."""
    return captured_loop(carry, thresh, max_iter, lambda c: cg_iteration(c, matvec, precond))


def _first(t):
    return t[0] if isinstance(t, tuple) else t


def loop(carry: CGCarry, thresh, max_iter: int, iteration: Callable) -> CGCarry:
    """``while res >= thresh and k < max_iter and delta != 0: carry =
    iteration(carry); k += 1``: on the host eagerly (from the first
    replica where the scalars are replicated), as WHILE nodes
    (`captured_loop`) while the current stream is being captured."""
    if capturing(_first(thresh).device):
        return captured_loop(carry, thresh, max_iter, iteration)
    n = 0
    while n < max_iter and bool((_first(carry.res) >= _first(thresh)) & (_first(carry.delta) != 0)):
        carry = iteration(carry)
        k = carry.k
        carry = carry._replace(k=tuple(kk + 1 for kk in k) if isinstance(k, tuple) else k + 1)
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
