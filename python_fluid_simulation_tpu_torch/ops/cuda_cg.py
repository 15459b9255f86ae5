"""Coupled viscosity Jacobi-PCG: CUDA kernel + plain version.

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

import ctypes
import functools
import math

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb
from python_fluid_simulation_tpu_torch.ops.indexing import face_parity, sample
from python_fluid_simulation_tpu_torch.solvers.cg import cg
from python_fluid_simulation_tpu_torch.utils.step_bytes import counted_bytes

VOL_CLASSES = ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
SPHI_CLASSES = ((0, 1, 1), (1, 0, 1), (1, 1, 0))
_PART_CAP = 3 * 8192
SAME_TERMS = 6  # same-field couplings an axis (they lead the term table)


def _dual(parity, off):
    q = [p + o for p, o in zip(parity, off)]
    return tuple(c % 2 for c in q), tuple((c - c % 2) // 2 for c in q)


@functools.cache
def stencil_plan():
    """Per axis: {'active': sphi class, 'diag': [(vol class, k, factor)],
    'terms': [(field, voff, sphi class, ck, vol class, vk, sign*factor)]}
    with classes as parity tuples and k the shift within the class."""
    from python_fluid_simulation_tpu_torch.solvers.viscosity import _terms_for_axis

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


def _class_ids():
    return {("vol", c): i for i, c in enumerate(VOL_CLASSES)} | {
        ("sphi", c): len(VOL_CLASSES) + i for i, c in enumerate(SPHI_CLASSES)
    }


def class_shape(cls, n):
    return tuple(int(k) + 1 - p for k, p in zip(n, cls))


@functools.cache
def plan_words(n: tuple) -> np.ndarray:
    """The stencil plan packed as the kernel's `Plan` struct (4-byte
    words; floats stored by bit pattern) for cell resolution n.  Cached
    per grid and read-only."""
    ids = _class_ids()
    words = []

    def f32(v):
        return int(np.array(v, np.float32).view(np.int32))

    for ax in stencil_plan():
        words.append(ids[("sphi", ax["active"])])
        words += [ids[("vol", c)] for c, _, _ in ax["diag"]]
        for _, k, _ in ax["diag"]:
            words += list(k)
        words += [f32(0.0 if f is None else f) for _, _, f in ax["diag"]]
        for field, voff, ccls, ck, vcls, vk, sf in ax["terms"]:
            words += [field, *voff, ids[("sphi", ccls)], *ck, ids[("vol", vcls)], *vk, f32(sf)]
    classes = list(VOL_CLASSES) + list(SPHI_CLASSES)
    dims = [class_shape(c, n) for c in classes]
    for dm in dims:
        words += list(dm)
    off = 0
    for dm in dims:
        words.append(off)
        off += int(np.prod(dm))
    words += [0] * len(VOL_CLASSES) + [1] * len(SPHI_CLASSES)
    words += [int(k) for k in n]
    sizes = [int(np.prod(s)) for s in _face_shapes(n)]
    words += [0, sizes[0], sizes[0] + sizes[1], sum(sizes)]
    if off >= 2**31 or sum(sizes) >= 2**31:  # the plan's offsets are int32 words
        raise ValueError(f"coupled kernels: grid {tuple(n)} has more than 2^31 geometry or face entries")
    out = np.asarray(words, dtype=np.int32)
    out.flags.writeable = False
    return out


# The bricks of the tiled operator (csrc/coupled_tile.cuh): TILE_Y x TILE_Z
# (y, z) columns of the union face box, one a thread, walking `chunk` x
# planes; TILE_BLOCKS_PER_SM bricks are resident on a SM at once (the
# kernel's launch bounds and its 127.3 KB of shared memory).
TILE_Y, TILE_Z = 16, 32
TILE_BLOCKS_PER_SM = 1
TILE_MIN_CHUNK = 4  # a brick stages chunk + 2 planes


@functools.cache
def matvec_tiling(n: tuple, sms: int):
    """The bricks of `coupled_matvec_geom` at cell resolution n on a card
    of `sms` SMs: (tiles_y, tiles_z, chunk, bricks).  The chunk is the one
    whose waves of resident bricks times the planes each stages (chunk + 2)
    is least, the longer on a tie."""
    u = [int(k) + 1 for k in n]
    tiles_y, tiles_z = -(-u[1] // TILE_Y), -(-u[2] // TILE_Z)
    resident = TILE_BLOCKS_PER_SM * sms

    def cost(chunk):
        return -(-tiles_y * tiles_z * -(-u[0] // chunk) // resident) * (chunk + 2), -chunk

    chunk = min(range(min(TILE_MIN_CHUNK, u[0]), u[0] + 1), key=cost)
    return tiles_y, tiles_z, chunk, tiles_y * tiles_z * -(-u[0] // chunk)


# The coupled PCG's workspace (csrc/coupled_visc_pcg.cu): boxes of
# `pcg_box(n)` floats, in this order, each holding its array at offset
# (1, 1, 1) and its fill everywhere else -- the 7 vol classes (0), the 3
# sphi classes (-1), then three fields each of x (x0, 0), pd (1: r / pd
# stays 0 in the pads), r, d and q (0).
PCG_VECTORS = (("x", 0.0), ("pd", 1.0), ("r", 0.0), ("d", 0.0), ("q", 0.0))


def pcg_box(n: tuple) -> tuple:
    """The padded box at cell resolution n: the union face box
    (n + 1 a side) with a one-cell border, z rows padded to a multiple of
    4 floats (16 bytes)."""
    return int(n[0]) + 3, int(n[1]) + 3, -(-(int(n[2]) + 3) // 4) * 4


@functools.cache
def pcg_boxes(n: tuple) -> tuple:
    """((name, array shape, fill), ...) of the workspace's boxes, in order."""
    out = [(f"vol{c}", class_shape(c, n), 0.0) for c in VOL_CLASSES]
    out += [(f"sphi{c}", class_shape(c, n), -1.0) for c in SPHI_CLASSES]
    for name, fill in PCG_VECTORS:
        out += [(f"{name}[{a}]", s, fill) for a, s in enumerate(_face_shapes(n))]
    return tuple(out)


def pcg_box_offset(n: tuple, j: int, g) -> int:
    """Workspace offset of element g = (gx, gy, gz) of box j's array
    (-1 and the array's extent reach into the border)."""
    X, Y, Z = pcg_box(n)
    return j * X * Y * Z + ((g[0] + 1) * Y + g[1] + 1) * Z + g[2] + 1


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _face_shapes(n):
    return [tuple(int(k) + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]


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


def _grid_of(vs):
    """Cell resolution n of the (vx, vy, vz) face arrays."""
    return (int(vs[1].shape[0]), int(vs[0].shape[1]), int(vs[0].shape[2]))


def _check(what, tensors, dev):
    for name, t, shape in tensors:
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{what}: {name} must be float32 {tuple(shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _geometry_tensors(sphi_c, vol_c, n):
    return [(f"vol{c}", vol_c[c], class_shape(c, n)) for c in VOL_CLASSES] + [
        (f"sphi{c}", sphi_c[c], class_shape(c, n)) for c in SPHI_CLASSES
    ]


@functools.cache
def _geometry_size(n: tuple) -> int:
    """Entries of `flat_geometry` at cell resolution n (cached: its numpy
    products cost the host more than the launch, on host-bound paths)."""
    return sum(int(np.prod(class_shape(c, n))) for c in VOL_CLASSES + SPHI_CLASSES)


def geometry_elements(sphi_c, vol_c) -> int:
    """Entries of the 10 geometry classes the coupled kernels read."""
    return sum(vol_c[c].numel() for c in VOL_CLASSES) + sum(sphi_c[c].numel() for c in SPHI_CLASSES)


def geom_matvec_bytes(n_geom: int, faces: int) -> int:
    """`coupled_matvec_geom`'s traffic (either form): the geometry and v
    read, q written."""
    return (n_geom + 2 * faces) * 4


def coupled_pcg_io_bytes(n_geom: int, faces: int) -> int:
    """The coupled PCG's inputs read once and output written once: b, x0,
    pd and the geometry read, x written."""
    return (4 * faces + n_geom) * 4


def coupled_pcg_iter_bytes(n_geom: int, faces: int) -> int:
    """The coupled PCG's streaming floor an iteration, as
    ``csrc/coupled_visc_pcg.cu`` streams it: the geometry read once and 12
    passes over the faces."""
    return (n_geom + 12 * faces) * 4


def coupled_visc_pcg_bytes(b, sphi_c, vol_c, iters) -> int:
    """A coupled PCG solve's traffic (row 2): `coupled_pcg_io_bytes`, then
    `coupled_pcg_iter_bytes` an iteration."""
    faces, n_geom = sum(t.numel() for t in b), geometry_elements(sphi_c, vol_c)
    return coupled_pcg_io_bytes(n_geom, faces) + int(iters) * coupled_pcg_iter_bytes(n_geom, faces)


def flat_geometry(sphi_c, vol_c):
    """The 10 geometry classes concatenated in the kernels' order (7 vol,
    then 3 sphi); build it once per solve and pass it to
    `coupled_matvec_geom`."""
    return _flat([vol_c[c] for c in VOL_CLASSES] + [sphi_c[c] for c in SPHI_CLASSES])


@counted_bytes(lambda q, vs, **_: geom_matvec_bytes(_geometry_size(_grid_of(vs)), sum(v.numel() for v in vs)))
def coupled_matvec_geom(sphi_c, vol_c, s_mu, vs, *, same_axis_only: bool = False, geom=None):
    """q = A v for the coupled viscosity operator (or, with
    ``same_axis_only``, its block-diagonal part), coefficients rebuilt
    from the geometry classes; vs = (vx, vy, vz).  On CUDA one launch of
    ``csrc/coupled_matvec.cu``, bitwise `coupled_matvec_plain`; ``geom``
    is `flat_geometry(sphi_c, vol_c)`, made here when not given."""
    dev = vs[0].device
    if dev.type == "cpu":
        return coupled_matvec_plain(sphi_c, vol_c, s_mu, vs, same_axis_only)
    if dev.type != "cuda":
        raise ValueError(f"coupled_matvec_geom: unsupported device {dev}")
    n = _grid_of(vs)
    shapes = _face_shapes(n)
    tensors = [(f"v[{a}]", vs[a], shapes[a]) for a in range(3)] + [("s_mu", s_mu, ())]
    if geom is None:
        tensors += _geometry_tensors(sphi_c, vol_c, n)
    _check("coupled_matvec_geom", tensors, dev)
    if geom is None:
        geom = flat_geometry(sphi_c, vol_c)
    n_geom = _geometry_size(n)
    if geom.device != dev or geom.dtype != torch.float32 or tuple(geom.shape) != (n_geom,) or not geom.is_contiguous():
        raise ValueError(f"coupled_matvec_geom: geom must be the flat float32 ({n_geom},) geometry on {dev}")
    plan = plan_words(n)
    tiles_y, tiles_z, chunk, _ = matvec_tiling(n, _sm_count(dev.index))
    vs = [v.contiguous() for v in vs]
    q = [torch.empty_like(v) for v in vs]
    s_mu = s_mu.contiguous()
    with cb.launching("coupled_matvec_geom", *vs, s_mu, geom) as stream:
        err = cb.LIB.get().pfs_coupled_matvec(
            plan.ctypes.data, plan.nbytes, tiles_y, tiles_z, chunk, geom.data_ptr(), *[v.data_ptr() for v in vs],
            s_mu.data_ptr(), *[t.data_ptr() for t in q], int(bool(same_axis_only)), stream,
        )
    cb.check(err, "coupled_matvec_geom launch")
    coupled_matvec_geom.launches += 1
    if same_axis_only:
        coupled_matvec_geom.same_axis_launches += 1
    return tuple(q)


coupled_matvec_geom.launches = 0
coupled_matvec_geom.same_axis_launches = 0  # of them, the block-diagonal form


@counted_bytes(lambda out, b, sphi_c, vol_c, **_: coupled_visc_pcg_bytes(b, sphi_c, vol_c, out[1]))
def coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, *, tol, rel_tol, max_iter):
    """Coupled viscosity Jacobi-PCG from x0 on the three face arrays.

    b, x0, pd: (vx, vy, vz)-shaped tuples; sphi_c / vol_c: parity-class
    dicts (vol already normalised); s_mu: 0-dim float32 tensor.
    Returns (x, iters, res, res0, thresh, r) on b's device; the CUDA
    route makes no host sync.
    """
    dev = b[0].device
    if dev.type == "cpu":
        return coupled_visc_pcg_plain(b, x0, pd, sphi_c, vol_c, s_mu, tol=tol, rel_tol=rel_tol, max_iter=max_iter)
    if dev.type != "cuda":
        raise ValueError(f"coupled_visc_pcg: unsupported device {dev}")
    n = _grid_of(b)
    shapes = _face_shapes(n)
    tensors = []
    for name, group in (("b", b), ("x0", x0), ("pd", pd)):
        for a in range(3):
            tensors.append((f"{name}[{a}]", group[a], shapes[a]))
    tensors += _geometry_tensors(sphi_c, vol_c, n) + [("s_mu", s_mu, ())]
    _check("coupled_visc_pcg", tensors, dev)
    lib = cb.LIB.get()
    plan = plan_words(n)
    tiles_y, tiles_z, chunk, _ = matvec_tiling(n, _sm_count(dev.index))
    box = pcg_box(n)
    work = torch.empty(len(pcg_boxes(n)) * math.prod(box), dtype=torch.float32, device=dev)
    classes = [vol_c[c].contiguous() for c in VOL_CLASSES] + [sphi_c[c].contiguous() for c in SPHI_CLASSES]
    fields = [t.contiguous() for group in (b, x0, pd) for t in group]
    x = tuple(torch.empty(s, dtype=torch.float32, device=dev) for s in shapes)
    r = tuple(torch.empty(s, dtype=torch.float32, device=dev) for s in shapes)
    part = torch.empty(_PART_CAP, dtype=torch.float32, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    res = torch.empty((), dtype=torch.float32, device=dev)
    res0 = torch.empty((), dtype=torch.float32, device=dev)
    thresh = torch.empty((), dtype=torch.float32, device=dev)
    s_mu = s_mu.contiguous()
    tol2, rel2 = squared_tols(tol, rel_tol)

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

    with cb.launching("coupled_visc_pcg", *fields, *classes, s_mu) as stream:
        err = lib.pfs_coupled_visc_pcg(
            plan.ctypes.data, plan.nbytes, tiles_y, tiles_z, chunk, *box, ptrs(classes), ptrs(fields),
            s_mu.data_ptr(), ptrs(x + r), work.data_ptr(), work.numel(), part.data_ptr(), _PART_CAP,
            iters.data_ptr(), res.data_ptr(), res0.data_ptr(), thresh.data_ptr(), tol2, rel2, int(max_iter),
            stream,
        )
    cb.check(err, "coupled_visc_pcg launch")
    coupled_visc_pcg.launches += 1
    return x, iters, res, res0, thresh, r


coupled_visc_pcg.launches = 0
