"""Damped-Jacobi smoothing chains of one multigrid level: CUDA kernel +
plain version.

Replaces ``python_fluid_simulation_tpu/ops/pallas_mg.py::
make_level_kernels`` (``_chain``): for every level k >= 1 of the
cell-Poisson V-cycle (``solvers/multigrid.py``), each of

  - pre-smooth from zero (n_smooth relaxations) + residual,
  - post-smooth (n_smooth relaxations from the corrected iterate),
  - coarse solve (coarse_iters relaxations from zero)

is one launch of ``csrc/mg_level_chain.cu``: a cooperative persistent
kernel with a grid barrier between relaxations and two ping-pong
buffers for the iterate (Jacobi reads the old iterate at the
neighbours).  It is bound by launch and barrier latency, not by bytes:
the levels are small (39x64x39 down to 3x4x3 at 128^3) and L2-resident,
and a chain takes about 25 us on an H100 whatever the level's size.

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
`level_chain_plain`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb
from python_fluid_simulation_tpu_torch.ops.cuda_stencils import batched, check_field, check_stencil, stencil_matvec_plain


class LevelKernels(NamedTuple):
    presmooth_resid: Callable  # b -> (x, r)
    postsmooth: Callable  # (x, b) -> x
    coarse_solve: Callable  # b -> x


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


def level_chain(diag, coefs, b, x0, *, iters: int, omega: float, emit_resid: bool):
    """One smoothing chain of a level (see `level_chain_plain`): fields
    (X, Y, Z), or (B, X, Y, Z) for a stack of B independent systems
    (each relaxed with its own x bounds)."""
    if iters < 1:
        raise ValueError("level_chain: at least one relaxation")
    if b.device.type == "cpu":
        return level_chain_plain(diag, coefs, b, x0, iters=iters, omega=omega, emit_resid=emit_resid)
    if b.device.type != "cuda":
        raise ValueError(f"level_chain: unsupported device {b.device}")
    shape = tuple(b.shape)
    check_stencil("level_chain", shape, b.device, diag, coefs)
    check_field("b", b, shape, b.device)
    if x0 is not None:
        check_field("x0", x0, shape, b.device)
    x = torch.empty_like(b)
    tmp = torch.empty_like(b) if iters > 1 else x
    r = torch.empty_like(b) if emit_resid else None
    err = cb.LIB.get().pfs_mg_level_chain(
        diag.data_ptr(), *[c.data_ptr() for _, c in coefs], b.data_ptr(),
        None if x0 is None else x0.data_ptr(), x.data_ptr(), tmp.data_ptr(),
        None if r is None else r.data_ptr(), *batched(shape), int(iters), float(np.float32(omega)),
        cb.stream_of(b),
    )
    cb.check(err, "mg_level_chain launch")
    level_chain.launches += 1
    if len(shape) == 4:
        level_chain.batched_launches += 1  # of which on a stack of systems
    return (x, r) if emit_resid else x


level_chain.launches = 0
level_chain.batched_launches = 0


def level_kernels(diag, coefs, *, omega: float, n_smooth: int, coarse_iters: int) -> LevelKernels:
    """The three chains of one level with (diag, coefs) in
    ``cuda_stencils.OFFSETS`` order."""

    def presmooth_resid(b):
        return level_chain(diag, coefs, b, None, iters=n_smooth, omega=omega, emit_resid=True)

    def postsmooth(x, b):
        return level_chain(diag, coefs, b, x, iters=n_smooth, omega=omega, emit_resid=False)

    def coarse_solve(b):
        return level_chain(diag, coefs, b, None, iters=coarse_iters, omega=omega, emit_resid=False)

    return LevelKernels(presmooth_resid, postsmooth, coarse_solve)
