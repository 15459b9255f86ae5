"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/cuda_cg.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Coupled viscosity Jacobi-PCG: CUDA kernel + plain version.

Replaces ``python_fluid_simulation_tpu/ops/pallas_cg.py::
make_fused_coupled_cg_geom`` (``_make_geom_matvec`` + ``_make_bc_passes``
+ ``_make_driver``): the coupled 3-field (vx, vy, vz) viscosity solve,
with the 42 couplings and 3 diagonals recomputed in the matvec from the
10 parity-class geometry fields (7 vol classes, 3 sphi classes) instead
of 45 materialised coefficient fields.

On Hopper the whole solve is one cooperative persistent kernel
(``csrc/coupled_visc_pcg.cu``): the loop runs on the device with grid
barriers between the matvec (A), update (B) and direction (C) phases,
and the scalars never reach the host.  Its state lives in a workspace of
padded boxes (`pcg_box`, `pcg_boxes`): the init copies the geometry
classes, x0 and pd into them, the last phase copies x and r out, so the
caller's arrays are passed apart.  Phase A is the tiled operator of
``csrc/coupled_tile.cuh`` (the bricks of `matvec_tiling`); B and C are
float4 streams over the three fields.  What bounds it on the H100:
device-memory bytes.  From 128^3 up the geometry (G entries) and the CG
vectors (N faces each) do not stay in the 50 MB L2, so an iteration
streams the geometry once and makes 12 vector passes: (G + 12 N) * 4
bytes, 0.335 ms at 154x256x154 cells and 0.442 ms at 126x504x126 at
3.35 TB/s.  At the flagship it stays in L2 and the grid barriers bound
an iteration.

The stencil plan — for each axis, which geometry class and offset feeds
the active test, the 7 diagonal volumes and the 14 couplings — is built
here once per grid from ``solvers.viscosity._terms_for_axis``; the
kernel receives it by value in its ``__grid_constant__`` parameter and
`coupled_matvec_plain` walks the same plan, so both follow
``viscosity_term_fields``' fp32 product order.

`coupled_matvec_geom` replaces ``pallas_cg.py::
make_blocked_coupled_matvec_geom``: one application of the same operator
(``csrc/coupled_matvec.cu``), the outer operator of the viscosity MG-PCG
route and of the 'unet_warm' line search; ``same_axis_only`` gives the
block-diagonal sub-operator (the diagonal and the 6 same-field couplings
an axis).  It is the tiled form of the operator
(``csrc/coupled_tile.cuh``): the term table compiled in, and each block
staging a brick of the 13 arrays (`matvec_tiling` plans the bricks) into
shared memory once for all three fields.  It rounds every operation on
its own and is bitwise `coupled_matvec_plain`.

Routing: CUDA tensors launch the kernels; CPU tensors run
`coupled_visc_pcg_plain` / `coupled_matvec_plain`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference.ops.indexing import face_parity, sample
from portbench.reference.solvers.cg import cg

VOL_CLASSES = ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
SPHI_CLASSES = ((0, 1, 1), (1, 0, 1), (1, 1, 0))
SAME_TERMS = 6  # same-field couplings an axis (they lead the term table)


def _dual(parity, off):
    q = [p + o for p, o in zip(parity, off)]
    return tuple(c % 2 for c in q), tuple((c - c % 2) // 2 for c in q)


@functools.cache
def stencil_plan():
    """Per axis: {'active': sphi class, 'diag': [(vol class, k, factor)],
    'terms': [(field, voff, sphi class, ck, vol class, vk, sign*factor)]}
    with classes as parity tuples and k the shift within the class."""
    from portbench.reference.solvers.viscosity import _terms_for_axis

    plan = []
    for a in range(3):
        pa = face_parity(a, 3)
        diag = [(*_dual(pa, (0, 0, 0)), None)]
        for ax in range(3):
            for sgn in (+1, -1):
                off = [0, 0, 0]
                off[ax] = sgn
                diag.append((*_dual(pa, tuple(off)), 2.0 if ax == a else 1.0))
        terms = []
        for cond, field, voff, voloff, factor, sign in _terms_for_axis(a, 3):
            ccls, ck = _dual(pa, cond)
            vcls, vk = _dual(pa, voloff)
            terms.append((field, tuple(voff), ccls, ck, vcls, vk, sign * factor))
        # the kernels' same-axis form takes the first SAME_TERMS terms
        assert all((t[0] == a) == (i < SAME_TERMS) for i, t in enumerate(terms))
        plan.append({"active": _dual(pa, (0, 0, 0))[0], "diag": diag, "terms": terms})
    return tuple(plan)


# The bricks of the tiled operator (csrc/coupled_tile.cuh): TILE_Y x TILE_Z
# (y, z) columns of the union face box, one a thread, walking `chunk` x
# planes; TILE_BLOCKS_PER_SM bricks are resident on a SM at once (the
# kernel's launch bounds and its 127.3 KB of shared memory).
TILE_Y, TILE_Z = 16, 32
TILE_BLOCKS_PER_SM = 1


def coupled_matvec_plain(sphi_c, vol_c, s_mu, vs, same_axis_only: bool = False):
    """A v with coefficients rebuilt from the geometry classes by the
    stencil plan; vs = (vx, vy, vz) face arrays.  ``same_axis_only``:
    the block-diagonal part (the diagonal and the 6 same-field couplings
    an axis)."""
    out = []
    for a, ax in enumerate(stencil_plan()):
        terms = ax["terms"][:SAME_TERMS] if same_axis_only else ax["terms"]
        shape = tuple(vs[a].shape)
        interior = torch.ones(shape, dtype=torch.bool, device=vs[a].device)
        for i, s in enumerate(shape):
            idx = torch.arange(s, device=vs[a].device)
            bshape = [1, 1, 1]
            bshape[i] = s
            interior = interior & ((idx >= 1) & (idx <= s - 2)).reshape(bshape)
        active = interior & (sample(sphi_c[ax["active"]], (0, 0, 0), shape, -1.0) >= 0)
        (ccls, ck, _), rest = ax["diag"][0], ax["diag"][1:]
        center = sample(vol_c[ccls], ck, shape, 0.0)
        extra = torch.zeros_like(center)
        for vcls, vk, factor in rest:
            extra = extra + factor * sample(vol_c[vcls], vk, shape, 0.0)
        diag_raw = center + s_mu * extra
        acc = torch.where(active, diag_raw, 0.0) * vs[a]
        for field, voff, ccls, ck, vcls, vk, sf in terms:
            w = sf * s_mu
            fluid = sample(sphi_c[ccls], ck, shape, -1.0) >= 0
            coef = torch.where(active & fluid, w * sample(vol_c[vcls], vk, shape, 0.0), 0.0)
            acc = acc + coef * sample(vs[field], voff, shape, 0.0)
        out.append(acc)
    return tuple(out)


def squared_tols(tol: float, rel_tol: float):
    """fp32 tol^2 and rel_tol^2 as the TPU driver rounds them
    (``jnp.asarray(tol, f32) ** 2`` and ``f32(rel_tol ** 2)``)."""
    return float(np.float32(tol) ** 2), float(np.float32(rel_tol**2))


def coupled_visc_pcg_plain(b, x0, pd, sphi_c, vol_c, s_mu, *, tol, rel_tol, max_iter):
    """Plain PyTorch version: returns (x, iters, res, res0, thresh, r)
    with x and r tuples of the three face arrays (r the final residual)."""
    tol2, rel2 = squared_tols(tol, rel_tol)
    x, stats, thresh, r = cg(
        lambda v: coupled_matvec_plain(sphi_c, vol_c, s_mu, v),
        tuple(b), tuple(x0), tol2=tol2, rel2=rel2, max_iter=max_iter,
        precond=lambda rr: tuple(ri / p for ri, p in zip(rr, pd)),
    )
    return x, stats.iters, stats.residual, stats.initial_residual, thresh, r


def _flat(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def flat_geometry(sphi_c, vol_c):
    """The 10 geometry classes concatenated in the kernels' order (7 vol,
    then 3 sphi); build it once per solve and pass it to
    `coupled_matvec_geom`."""
    return _flat([vol_c[c] for c in VOL_CLASSES] + [sphi_c[c] for c in SPHI_CLASSES])


def coupled_matvec_geom(sphi_c, vol_c, s_mu, vs, *, same_axis_only: bool = False, geom=None):
    """q = A v for the coupled viscosity operator (or its block-diagonal
    part), coefficients rebuilt from the geometry classes (the plain
    version)."""
    return coupled_matvec_plain(sphi_c, vol_c, s_mu, vs, same_axis_only)


def coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, *, tol, rel_tol, max_iter):
    """Coupled viscosity Jacobi-PCG from x0 (the plain version)."""
    return coupled_visc_pcg_plain(b, x0, pd, sphi_c, vol_c, s_mu, tol=tol, rel_tol=rel_tol, max_iter=max_iter)

