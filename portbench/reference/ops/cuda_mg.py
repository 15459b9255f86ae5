"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/cuda_mg.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

The multigrid V-cycle below level 0 in one launch (the tail): CUDA
kernel + plain version, and the grid transfers of the V-cycle.

Replaces ``python_fluid_simulation_tpu/ops/pallas_mg.py::
make_level_kernels`` (``_chain``), one TPU kernel a smoothing chain with
the transfers left to XLA.  The V-cycle (``solvers/multigrid.py``) smooths
level 0 itself; everything between its residual r = b - A x and its
post-smoothing is the tail:

  out = x + P e1,  e1 = the V-cycle of levels 1..L on R r,

every level k >= 1 presmoothing from zero (n_smooth relaxations) with
its residual, the coarsest solving by coarse_iters relaxations from zero,
and every level post-smoothing from x_k + P e_{k+1}.  On the card the
tail is one cooperative launch of ``csrc/mg_vcycle.cu``: the levels above
`BLOCK_CELLS` cells across the grid, the smaller ones inside one block
(their right-hand sides and iterates in its shared memory), the
restriction fused with the next level's first relaxation and the
prolongation with the first post-relaxation.  Its level descriptors and
workspace (b and two ping-pong iterates a level) are made once per
preconditioner by `make_vcycle_tail`; an application allocates only its
output.

The relaxation follows the TPU chain's arithmetic,
``x + (b - A x) * inv`` with ``inv = omega / where(diag > 0, diag, 1)``;
the JAX package's XLA V-cycle (run where its Pallas chains are not
available, e.g. on CPU) computes ``x + omega * r / safe_diag`` instead,
so the two differ in the last bits (tests/test_torch_multigrid.py states
the tolerance).  Kernel and plain version round every operation alike
and agree bitwise.

A level may also be a stack (B, X, Y, Z) of independent systems: the
batched viscosity V-cycle (``solvers/multigrid.py::
make_batched_mg_preconditioner``) stacks its three axis blocks, padded
to one shape; the kernel gives the batch an index of its own (no read
crosses from one system into the next) and its plain version shifts
within each system with zero fill, as the JAX package's batched XLA
cycle does (``_bshift(p, off, 0.0)``).

Routing: a CUDA tensor launches the kernel; a CPU tensor runs
`vcycle_tail_plain`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from portbench.reference.ops.cuda_stencils import stencil_matvec_plain

MAX_LEVELS = 12  # the kernel's kMaxLevels: levels below level 0


def halve(a, axis: int, parity):
    """Halve one axis (zero-padded to even): parity None sums each child
    pair, 0 / 1 takes the even / odd child."""
    if a.shape[axis] % 2:
        pad = list(a.shape)
        pad[axis] = 1
        a = torch.cat([a, a.new_zeros(pad)], dim=axis)
    shp = a.shape[:axis] + (a.shape[axis] // 2, 2) + a.shape[axis + 1 :]
    r = a.reshape(shp)
    if parity is None:
        return r.select(axis + 1, 0) + r.select(axis + 1, 1)
    return r.select(axis + 1, parity)


def restrict(r, coarse_shape):
    """P^T r: 2^d-child sum onto the coarse grid over the trailing
    len(coarse_shape) dims (x, then z, then y, the JAX package's order);
    leading dims are a batch and ride along."""
    lead = r.ndim - len(coarse_shape)
    assert all(c == (s + 1) // 2 for s, c in zip(r.shape[lead:], coarse_shape)), (r.shape, coarse_shape)
    d = len(coarse_shape)
    for axis in tuple(range(d - 2)) + (d - 1, d - 2):
        r = halve(r, lead + axis, None)
    return r


def prolong(e, fine_shape):
    """P e: inject the parent value into all children (over the trailing
    len(fine_shape) dims; leading dims are a batch)."""
    lead = e.ndim - len(fine_shape)
    for k, n in enumerate(fine_shape):
        axis = lead + k
        shp = list(e.shape)
        e = e.unsqueeze(axis + 1).expand(*shp[: axis + 1], 2, *shp[axis + 1 :])
        e = e.reshape(*shp[:axis], 2 * shp[axis], *shp[axis + 1 :]).narrow(axis, 0, n)
    return e.contiguous()


def level_chain_plain(diag, coefs, b, x0, *, iters: int, omega: float, emit_resid: bool):
    """`iters` relaxations from x0 (None: from zero); returns x, or
    (x, b - A x) with `emit_resid`."""
    inv = torch.full_like(diag, np.float32(omega)) / torch.where(diag > 0, diag, 1.0)
    x = x0
    for _ in range(iters):
        if x is None:
            x = b * inv  # A 0 = 0: the first relaxation from zero
            continue
        x = x + (b - stencil_matvec_plain(diag, coefs, x)) * inv
    if emit_resid:
        return x, b - stencil_matvec_plain(diag, coefs, x)
    return x


class VcycleTail(NamedTuple):
    """The tail of one preconditioner's V-cycle, made once."""

    levels: Tuple  # hierarchy levels 1..L (each with .diag, .coefs in the 7-point order: +x, -x, +y, -y, +z, -z)
    fine_shape: Tuple[int, ...]  # level 0's field shape, (X, Y, Z) or (B, X, Y, Z)
    omega: float
    n_smooth: int
    coarse_iters: int


def spatial(shape):
    return tuple(shape[-3:])


def make_vcycle_tail(levels, *, omega: float, n_smooth: int, coarse_iters: int) -> VcycleTail:
    """The tail of a V-cycle over `levels` (a hierarchy of at least two
    levels, as ``solvers/multigrid.py::build_hierarchy`` or the batched
    stack makes it)."""
    if len(levels) < 2 or len(levels) - 1 > MAX_LEVELS:
        raise ValueError(f"vcycle tail: 1..{MAX_LEVELS} levels below level 0, got {len(levels) - 1}")
    if n_smooth < 1 or coarse_iters < 1:
        raise ValueError("vcycle tail: at least one relaxation a chain")
    return VcycleTail(
        levels=tuple(levels[1:]), fine_shape=tuple(levels[0].diag.shape), omega=float(np.float32(omega)),
        n_smooth=int(n_smooth), coarse_iters=int(coarse_iters),
    )


def vcycle_tail_plain(tail: VcycleTail, x, r):
    """x + P e1 by today's composition: `level_chain_plain` a chain,
    `restrict`, `prolong` and the add, level by level."""
    lv = tail.levels
    kw = dict(omega=tail.omega)

    def cycle(k, b):  # k indexes tail.levels (0: hierarchy level 1)
        d, c = lv[k].diag, lv[k].coefs
        if k == len(lv) - 1:
            return level_chain_plain(d, c, b, None, iters=tail.coarse_iters, emit_resid=False, **kw)
        xk, rk = level_chain_plain(d, c, b, None, iters=tail.n_smooth, emit_resid=True, **kw)
        ec = cycle(k + 1, restrict(rk, spatial(lv[k + 1].diag.shape)))
        xk = xk + prolong(ec, spatial(d.shape))
        return level_chain_plain(d, c, b, xk, iters=tail.n_smooth, emit_resid=False, **kw)

    return x + prolong(cycle(0, restrict(r, spatial(lv[0].diag.shape))), spatial(tail.fine_shape))


def vcycle_tail(tail: VcycleTail, x, r):
    """x + P e1 for the level-0 iterate x and residual r (the plain
    version)."""
    return vcycle_tail_plain(tail, x, r)

