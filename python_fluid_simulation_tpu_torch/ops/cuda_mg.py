"""The multigrid V-cycle below level 0 in one launch (the tail): CUDA
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

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb
from python_fluid_simulation_tpu_torch.ops.cuda_stencils import batched, check_field, check_stencil, stencil_matvec_plain
from python_fluid_simulation_tpu_torch.utils.step_bytes import counted_bytes

# Levels of at most this many cells (B x X x Y x Z) run inside one block
# of the tail kernel, the larger ones across the grid.  Measured on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's tail rows,
# `split_device_ms`: the tail's device time at every split of the 128^3,
# coiling and lean 504 hierarchies): a level of 1,600 or 2,048 cells runs
# no slower inside the block (128^3 0.0486 ms a cycle against 0.0501 in the
# grid, coiling 0.0455 against 0.0457), one of 6,144 or 8,019 slower (lean
# 504 0.0986 against 0.0772, coiling batched 0.134 against 0.098); the
# coarse solve gains most (128^3 all in the grid: 0.0882).
BLOCK_CELLS = 2048
MAX_LEVELS = 12  # the kernel's kMaxLevels: levels below level 0
TAIL_WORDS = 14  # int64 words of a packed level descriptor
TAIL_SMEM_BYTES = 220 * 1024  # the kernel's kSmemBytes: b and two iterates of the block's levels


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

    levels: Tuple  # hierarchy levels 1..L (each with .diag, .coefs in OFFSETS order)
    fine_shape: Tuple[int, ...]  # level 0's field shape, (X, Y, Z) or (B, X, Y, Z)
    omega: float
    n_smooth: int
    coarse_iters: int
    block_level: int  # first level (1..L) run inside one block; L + 1: none
    work: Tuple  # per level 1..L: (b, x, its ping-pong partner)
    desc: np.ndarray  # (L, TAIL_WORDS) int64: the packed level descriptors


def spatial(shape):
    return tuple(shape[-3:])


def smem_bytes(tail_levels, block_level: int) -> int:
    """Shared memory of the tail's levels (hierarchy levels 1..L) from
    `block_level` on: b and two iterates each."""
    return 12 * sum(lv.diag.numel() for lv in tail_levels[block_level - 1 :])


def split_level(tail_levels) -> int:
    """The first of hierarchy levels 1..L with at most `BLOCK_CELLS` cells
    whose levels fit the block's shared memory (the levels shrink), or
    L + 1."""
    return next((k for k, lv in enumerate(tail_levels, 1)
                 if lv.diag.numel() <= BLOCK_CELLS and smem_bytes(tail_levels, k) <= TAIL_SMEM_BYTES),
                len(tail_levels) + 1)


def pack_levels(levels, work) -> np.ndarray:
    """One row a level 1..L: diag, the six coefficients, b, x, partner
    (data pointers), then B, X, Y, Z."""
    rows = []
    for lv, (b, x, t) in zip(levels, work):
        shape = batched(tuple(lv.diag.shape))
        rows.append([lv.diag.data_ptr(), *[c.data_ptr() for _, c in lv.coefs], b.data_ptr(), x.data_ptr(),
                     t.data_ptr(), *shape])
    return np.ascontiguousarray(np.array(rows, dtype=np.int64).reshape(len(rows), TAIL_WORDS))


def make_vcycle_tail(levels, *, omega: float, n_smooth: int, coarse_iters: int) -> VcycleTail:
    """The tail of a V-cycle over `levels` (a hierarchy of at least two
    levels, as ``solvers/multigrid.py::build_hierarchy`` or the batched
    stack makes it): its workspace and packed descriptors."""
    if len(levels) < 2 or len(levels) - 1 > MAX_LEVELS:
        raise ValueError(f"vcycle tail: 1..{MAX_LEVELS} levels below level 0, got {len(levels) - 1}")
    if n_smooth < 1 or coarse_iters < 1:
        raise ValueError("vcycle tail: at least one relaxation a chain")
    tail_levels = tuple(levels[1:])
    dev = tail_levels[0].diag.device
    if dev.type == "cuda":
        for lv in tail_levels:
            check_stencil("vcycle_tail", tuple(lv.diag.shape), dev, lv.diag, lv.coefs)
    work = tuple(tuple(torch.empty_like(lv.diag) for _ in range(3)) for lv in tail_levels)
    return VcycleTail(
        levels=tail_levels, fine_shape=tuple(levels[0].diag.shape), omega=float(np.float32(omega)),
        n_smooth=int(n_smooth), coarse_iters=int(coarse_iters), block_level=split_level(tail_levels),
        work=work, desc=pack_levels(tail_levels, work),
    )


def tail_barriers(tail: VcycleTail) -> Tuple[int, int]:
    """(grid barriers, block barriers) of one launch: a phase a relaxation
    (the restriction rides on the first of a level's way down, the
    prolongation on the first of its way up), one grid barrier after each
    grid phase, one after the grid's restriction into the block's first
    level and one where the grid waits for the block's levels; the block
    stages that level in place of its restriction."""
    big_l, s, n = len(tail.levels), tail.block_level, tail.n_smooth

    def phases(k):  # level k's phases, down and up
        return (tail.coarse_iters if k == big_l else n) + (n if k < big_l else 0)

    grid = sum(phases(k) for k in range(1, min(s - 1, big_l) + 1)) + (2 if s <= big_l else 0)
    block = sum(phases(k) for k in range(s, big_l + 1))
    return grid, block


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


def launch_tail(tail: VcycleTail, x, r, block_level: int):
    """One launch of the tail kernel with levels from `block_level` on
    inside one block (the wrapper passes `tail.block_level`)."""
    check_field("x", x, tail.fine_shape, x.device)
    check_field("r", r, tail.fine_shape, x.device)
    if tail.levels[0].diag.device != x.device:
        raise ValueError(f"vcycle_tail: the hierarchy is on {tail.levels[0].diag.device}, x on {x.device}")
    out = torch.empty_like(x)
    with cb.launching("mg_vcycle_tail", x, r, tail.levels[0].diag) as stream:
        err = cb.LIB.get().pfs_mg_vcycle_tail(
            tail.desc.ctypes.data, len(tail.levels), int(block_level), x.data_ptr(), r.data_ptr(), out.data_ptr(),
            *batched(tail.fine_shape), tail.n_smooth, tail.coarse_iters, tail.omega, stream,
        )
    cb.check(err, "mg_vcycle_tail launch")
    return out


def tail_bytes(tail: VcycleTail) -> int:
    """One tail call's traffic (row 9, a cycle): x and r read and the
    output written at level 0, each level's 7 stencil fields read once
    (the workspace is the function's own)."""
    return 4 * (3 * int(np.prod(tail.fine_shape)) + 7 * sum(lv.diag.numel() for lv in tail.levels))


@counted_bytes(lambda out, tail, **_: tail_bytes(tail))
def vcycle_tail(tail: VcycleTail, x, r):
    """x + P e1 (see `vcycle_tail_plain`) for the level-0 iterate x and
    residual r, fields (X, Y, Z) or a stack (B, X, Y, Z)."""
    if x.device.type == "cpu":
        return vcycle_tail_plain(tail, x, r)
    if x.device.type != "cuda":
        raise ValueError(f"vcycle_tail: unsupported device {x.device}")
    out = launch_tail(tail, x, r, tail.block_level)
    vcycle_tail.launches += 1
    if len(tail.fine_shape) == 4:
        vcycle_tail.batched_launches += 1  # of which on a stack of systems
    return out


vcycle_tail.launches = 0
vcycle_tail.batched_launches = 0
