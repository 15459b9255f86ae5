"""Halo exchanges and the distributed solves of the sharded step.

Counterpart of ``python_fluid_simulation_tpu.parallel.halo``.  There,
inside a ``shard_map`` region, each device owns a contiguous block of the
grid, exchanges one-cell halos with its mesh neighbours (``ppermute``)
and reduces CG dots with ``psum``.  Here one process drives the slots of
a `parallel.mesh.Mesh`: a sharded field is the list of its slot blocks,
`halo_exchange` frames every block with its neighbours' edges, and
`psum_dots` sums the slots' fp32 partial dots in slot order, into one
replica a distinct device of the mesh (on slot 0's device where every
slot shares it; on a mesh over several cards every card gets the same
bits from ``parallel/halo_rdma.py::mesh_psum``, as ``psum`` leaves the
total on every JAX device).  Each slot's blocks live on its own device
(card i for slot i of a mesh over the cards).  Width-1 exchanges of CUDA
blocks along array axis 0 take the halo kernels (``parallel/
halo_rdma.py``: one pull launch a device, or the push over NVLink where a
ring spans devices), and so do width-1 exchanges along another axis whose
rings span devices (the push over that axis moved to the front); every
other exchange, and every exchange of CPU blocks, takes the plain route
(slices and ``torch.cat``), as every exchange but that one keeps
``ppermute`` in the JAX package.

The CG loops (`distributed_cell_poisson`, `distributed_coupled_cg`) are
the JAX package's: x0 = 0 for the cell solves, the fp32 threshold
max(f32(tol)^2, f32(rel_tol)^2 * res0), the exit res >= thresh,
k < max_iter, delta != 0, and the guarded alpha and beta, in the JAX
package's order of operations (not ``solvers/cg.py::cg_iteration``'s).
Each is an init (`cell_poisson_setup`, `coupled_cg_setup`) and one
iteration over a `solvers/cg.py::CGCarry` of per-slot (and per-field)
blocks and per-device replicas of delta, res and k, looped by
``solvers/cg.py::loop``: eagerly the exit is tested on the host once per
iteration, from the first replica; while the current stream is being
captured into a CUDA graph (``engine/step.py::make_step`` with a mesh)
the iteration is recorded once, as the bodies of one WHILE node a device
whose tests run on the device, each on that device's replicas (the same
bits on every card, so every loop exits on the same iteration, as each
JAX device's ``while_loop`` does), the carry in buffers of its own.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from python_fluid_simulation_tpu_torch.ops.cuda_stencils import squared_tols
from python_fluid_simulation_tpu_torch.ops.indexing import sample, shift
from python_fluid_simulation_tpu_torch.parallel import halo_rdma
from python_fluid_simulation_tpu_torch.parallel.mesh import Mesh, gather_blocks, spatial_axes, split_blocks
from python_fluid_simulation_tpu_torch.solvers import cg
from python_fluid_simulation_tpu_torch.solvers.cg import CGCarry, threshold, tree_dot


def halo_exchange(mesh: Mesh, blocks: Sequence[torch.Tensor], axis_name: str, width: int = 1,
                  array_axis: int = 0) -> List[torch.Tensor]:
    """Append `width` cells received from both neighbours along one mesh
    axis to every slot's block.

    Each output is extended by 2*width along ``array_axis``: the leading
    halo is the high edge of the low neighbour, the trailing halo the low
    edge of the high neighbour, zeros at the domain's ends.
    """
    if width == 1 and blocks[0].ndim >= 2 and blocks[0].device.type == "cuda":
        if array_axis == 0:
            return halo_rdma.halo_exchange_rdma(mesh, blocks, axis_name)
        if halo_rdma.halo_route(mesh, axis_name) == "push":  # rings across cards: no copy leaves a card's own stream
            moved = halo_rdma.halo_exchange_push(mesh, [b.movedim(array_axis, 0).contiguous() for b in blocks],
                                                 axis_name)
            return [o.movedim(0, array_axis).contiguous() for o in moved]
    out = [None] * len(blocks)
    for ring in mesh.rings(axis_name):
        for pos, s in enumerate(ring):
            x = blocks[s]
            size = x.shape[array_axis]
            if pos > 0:
                lo = blocks[ring[pos - 1]].narrow(array_axis, size - width, width).to(x.device)
            else:
                lo = torch.zeros_like(x.narrow(array_axis, 0, width))
            if pos < len(ring) - 1:
                hi = blocks[ring[pos + 1]].narrow(array_axis, 0, width).to(x.device)
            else:
                hi = torch.zeros_like(x.narrow(array_axis, 0, width))
            out[s] = torch.cat([lo, x, hi], dim=array_axis)
    return out


def _partial(x, y) -> torch.Tensor:
    """One slot's fp32 partial of <x, y>, each a block or a tuple of
    blocks."""
    xs = tuple(x) if isinstance(x, (tuple, list)) else (x,)
    ys = tuple(y) if isinstance(y, (tuple, list)) else (y,)
    return tree_dot(xs, ys)


def psum_dot(a: Sequence, b: Sequence) -> torch.Tensor:
    """Distributed <a, b>: a[s], b[s] are slot s's block (or tuple of
    blocks); the slots' fp32 partials are summed on slot 0's device in
    slot order."""
    total = None
    for x, y in zip(a, b):
        part = _partial(x, y)
        total = part if total is None else total + part.to(total.device)
    return total


def psum_dots(mesh: Mesh, *pairs) -> List[tuple]:
    """Each pair's distributed dot (`psum_dot`'s slot-order sum), as its
    replicas, one a distinct device of the mesh in the order of their
    first slots (``halo_rdma.replica_devices``): the sum on the one
    device where every slot shares it, else ``halo_rdma.mesh_psum`` (one
    launch a slot for up to three dots)."""
    parts = [tuple(_partial(a[s], b[s]) for a, b in pairs) for s in range(mesh.size)]
    if len(set(mesh.devices)) > 1:
        return halo_rdma.mesh_psum(mesh, parts)
    out = []
    for j in range(len(pairs)):
        total = parts[0][j]
        for p in parts[1:]:
            total = total + p[j]
        out.append((total,))
    return out


def _replica_index(mesh: Mesh) -> List[int]:
    """Each slot's replica: the index of its device in
    ``halo_rdma.replica_devices``."""
    devices = halo_rdma.replica_devices(mesh)
    return [devices.index(d) for d in mesh.devices]


def _guarded_div(num, den) -> tuple:
    """where(den != 0, num / den, 0) of each replica."""
    return tuple(torch.where(d != 0, a / d, torch.zeros_like(d)) for a, d in zip(num, den))


def sharded_pressure_matvec(mesh: Mesh, w_faces, lphi):
    """The 7-point ghost-fluid matvec over x-slabs of a 1D mesh.

    Each slot computes the stencil on its slab extended by 1-cell halos
    of (p, lphi) and the face weights; the x-face weights drop the
    global last face (identically zero, never written by
    ``compute_solid_frac``): the last slot's halo exchange
    re-materialises it as zero fill.  Returns p -> A p on global arrays
    (slot 0's device).  Requires nx % slots == 0."""
    from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_matvec_3d

    axis = mesh.axis_names[0]
    n = mesh.size
    if lphi.shape[0] % n:
        raise ValueError("grid x-extent must divide the mesh")
    wx, wy, wz = w_faces
    consts = [halo_exchange(mesh, split_blocks(mesh, f, (axis,)), axis) for f in (lphi, wx[:-1], wy, wz)]

    def matvec(p):
        p_h = halo_exchange(mesh, split_blocks(mesh, p, (axis,)), axis)
        out = []
        for s in range(n):
            lphi_h, wx_h, wy_h, wz_h = (c[s] for c in consts)
            o = pressure_matvec_3d(p_h[s], (wx_h, wy_h, wz_h), lphi_h)[1:-1]
            # the matvec's interior mask zeroed the halo rows; re-zero only
            # the true domain boundary planes
            if s == 0:
                o[0] = 0.0
            if s == n - 1:
                o[-1] = 0.0
            out.append(o)
        return gather_blocks(mesh, out, (axis,))

    return matvec


def sharded_pressure_matvec_interior_oracle(w_faces, lphi):
    """Single-device reference for tests."""
    from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_matvec_3d

    def matvec(p):
        return pressure_matvec_3d(p, w_faces, lphi)

    return matvec


def _pad_x(a, target: int, fill=0.0):
    """Pad an array along axis 0 to `target` planes with `fill`."""
    return _pad_axis(a, target, 0, fill)


def _pad_axis(a, target: int, axis: int, fill=0.0):
    if a.shape[axis] == target:
        return a
    shape = list(a.shape)
    shape[axis] = target
    out = torch.full(shape, fill, dtype=a.dtype, device=a.device)
    out.narrow(axis, 0, a.shape[axis]).copy_(a)
    return out


def _padded_extent(nx: int, n_devices: int) -> int:
    return -(-nx // n_devices) * n_devices


def _mesh_spatial(mesh: Mesh):
    """[(mesh_axis_name, array_axis, slots_along_it)] of the spatial
    decomposition: 1D meshes split array axis 0, 2D (x, z) meshes axes 0
    and 2."""
    return [(name, arr_axis, mesh.shape[name]) for name, arr_axis in spatial_axes(mesh)]


def _pad_to_mesh(a, pairs, fill=0.0):
    """Pad each split array axis to a multiple of its mesh extent."""
    for _, arr_axis, n in pairs:
        a = _pad_axis(a, _padded_extent(a.shape[arr_axis], n), arr_axis, fill)
    return a


def _block_spec(pairs, ndim):
    spec = [None] * ndim
    for name, arr_axis, _ in pairs:
        spec[arr_axis] = name
    return tuple(spec)


def _halo_all(mesh: Mesh, blocks, pairs, width: int = 1):
    """Halo-exchange along every split axis in turn.  The second exchange
    moves the already x-extended planes, so the corners the cross-axis
    couplings read arrive without an exchange of their own."""
    for name, arr_axis, _ in pairs:
        blocks = halo_exchange(mesh, blocks, name, width, arr_axis)
    return blocks


def _slice_offset(q, off, pairs, local_shape):
    """The ``off``-shifted block of a halo-extended block: split axes
    slice the halo, the others shift with zero fill."""
    split = {arr_axis for _, arr_axis, _ in pairs}
    for a in split:
        q = q.narrow(a, 1 + off[a], local_shape[a])
    rest = tuple(0 if a in split else off[a] for a in range(len(off)))
    if any(rest):
        q = shift(q, rest, 0.0)
    return q


def converged_threshold(tol: float, rel_tol: float, res0):
    """The distributed solves' exit threshold, max(f32(tol)^2,
    f32(rel_tol)^2 * res0) in fp32."""
    return threshold(*squared_tols(tol, rel_tol), res0)


def _unpad(x, shape):
    for a, want in enumerate(shape):
        if x.shape[a] != want:
            x = x.narrow(a, 0, want)
    return x.contiguous()


def cell_poisson_setup(mesh: Mesh, b, diag, coefs, precond_diag, *, tol: float = 1e-3, rel_tol: float = 1e-3):
    """The distributed Jacobi-PCG of `distributed_cell_poisson` before its
    loop: (carry, res0, thresh, iteration, finish).  The carry holds each
    slot's block of x (0), r and d, and delta, res (res0) and a device
    int32 k (0) as tuples of replicas, one a distinct device of the mesh
    (res0 and thresh too); ``iteration(carry)`` is one iteration (k
    passed through); ``finish(x blocks)`` is the global x."""
    pairs = _mesh_spatial(mesh)
    spec = _block_spec(pairs, b.ndim)
    orig_shape = tuple(b.shape)

    def split(a, fill=0.0):
        return split_blocks(mesh, _pad_to_mesh(a, pairs, fill), spec)

    b_l, diag_l, pd_l = split(b), split(diag), split(precond_diag, fill=1.0)
    offs = [tuple(off) for off, _ in coefs]
    coef_ls = [split(c) for _, c in coefs]
    lshape = tuple(b_l[0].shape)
    rep = _replica_index(mesh)
    n = mesh.size

    def matvec(p_l):
        p_h = _halo_all(mesh, p_l, pairs)
        out = []
        for s in range(n):
            o = diag_l[s] * p_l[s]
            for off, c_l in zip(offs, coef_ls):
                o = o + c_l[s] * _slice_offset(p_h[s], off, pairs, lshape)
            out.append(o)
        return out

    def iteration(c: CGCarry) -> CGCarry:
        x, r, d, delta, _, k = c
        q = matvec(d)
        (dq,) = psum_dots(mesh, (d, q))
        alpha = _guarded_div(delta, dq)
        x = [x[s] + alpha[rep[s]] * d[s] for s in range(n)]
        r = [r[s] - alpha[rep[s]] * q[s] for s in range(n)]
        z = [r[s] / pd_l[s] for s in range(n)]
        nd, res = psum_dots(mesh, (r, z), (r, r))
        beta = _guarded_div(nd, delta)
        d = [z[s] + beta[rep[s]] * d[s] for s in range(n)]
        return CGCarry(x, r, d, nd, res, k)

    def finish(x):
        return _unpad(gather_blocks(mesh, x, spec), orig_shape)

    r = list(b_l)
    z = [r[s] / pd_l[s] for s in range(n)]
    delta, res0 = psum_dots(mesh, (r, z), (r, r))
    return _carry(tol, rel_tol, [torch.zeros_like(t) for t in b_l], r, z, delta, res0) + (iteration, finish)


def _carry(tol, rel_tol, x, r, z, delta, res0):
    """(the carry before the first iteration, res0, thresh), each scalar
    a tuple of replicas."""
    thresh = tuple(converged_threshold(tol, rel_tol, t) for t in res0)
    k = tuple(torch.zeros((), dtype=torch.int32, device=t.device) for t in res0)
    return CGCarry(x, r, z, delta, res0, k), res0, thresh


def distributed_cell_poisson(mesh: Mesh, b, diag, coefs, precond_diag, *, tol: float = 1e-3,
                             rel_tol: float = 1e-3, max_iter: int = 600):
    """The distributed Jacobi-PCG of a cell-centred 7-point system from
    x0 = 0: an iteration is one halo exchange of the search direction
    along each split axis and the dots' slot sums.

    b / diag / precond_diag and each coefficient field are global cell
    arrays (``pressure_coefficients`` / ``density_coefficients``).  Any
    extent works: split axes are padded to a multiple of the mesh (pad
    rows carry diag = 0, coef = 0, precond = 1, an inert identity block
    that stays exactly zero).  Returns (x, iters, residual, res0), x on
    slot 0's device, iters a device int32.
    """
    carry, res0, thresh, iteration, finish = cell_poisson_setup(mesh, b, diag, coefs, precond_diag, tol=tol,
                                                                rel_tol=rel_tol)
    carry = cg.loop(carry, thresh, max_iter, iteration)
    return finish(carry.x), carry.k[0], carry.res[0], res0[0]


def sharded_cell_poisson_cg(mesh: Mesh, b, diag, coefs, precond_diag, *, tol: float = 1e-3,
                            rel_tol: float = 1e-3, max_iter: int = 600):
    """`distributed_cell_poisson` returning (x, iters, residual)."""
    x, k, res, _ = distributed_cell_poisson(mesh, b, diag, coefs, precond_diag, tol=tol, rel_tol=rel_tol,
                                            max_iter=max_iter)
    return x, k, res


def coupled_cg_setup(mesh: Mesh, b_faces, x0_faces, diags, per_axis_terms, precond_diags, *,
                     tol: float = 1e-3, rel_tol: float = 1e-3):
    """The distributed Jacobi-PCG of `distributed_coupled_cg` before its
    loop: (carry, res0, thresh, iteration, finish), as
    `cell_poisson_setup`'s, x, r and d per field and slot."""
    pairs = _mesh_spatial(mesh)
    split_axes = [arr_axis for _, arr_axis, _ in pairs]
    d = len(b_faces)
    shapes = [tuple(v.shape) for v in b_faces]
    common = {arr_axis: _padded_extent(max(s[arr_axis] for s in shapes), n_dev) for _, arr_axis, n_dev in pairs}
    spec = _block_spec(pairs, len(shapes[0]))
    n = mesh.size
    rep = _replica_index(mesh)

    def split(v, fill=0.0):
        for arr_axis, target in common.items():
            v = _pad_axis(v, target, arr_axis, fill)
        return split_blocks(mesh, v, spec)

    bs = [split(v) for v in b_faces]  # bs[field][slot]
    x0s = [split(v) for v in x0_faces]
    ds = [split(v) for v in diags]
    pds = [split(v, fill=1.0) for v in precond_diags]
    terms = []  # (a, field, voff, coef blocks)
    for a in range(d):
        for field, voff, coef in per_axis_terms[a]:
            terms.append((a, field, tuple(int(o) for o in voff), split(coef)))
    lshape = tuple(bs[0][0].shape)
    block_shapes = [tuple(bs[a][0].shape) for a in range(d)]

    def matvec(vs):
        vhs = [_halo_all(mesh, vs[f], pairs) for f in range(d)]
        outs = [[ds[a][s] * vs[a][s] for s in range(n)] for a in range(d)]
        for a, field, voff, c_l in terms:
            rest_off = tuple(0 if ax in split_axes else voff[ax] for ax in range(len(voff)))
            tgt = tuple(lshape[ax] if ax in split_axes else block_shapes[a][ax] for ax in range(len(voff)))
            for s in range(n):
                q = vhs[field][s]
                for ax in split_axes:
                    q = q.narrow(ax, 1 + voff[ax], lshape[ax])
                outs[a][s] = outs[a][s] + c_l[s] * sample(q, rest_off, tgt, 0.0)
        return outs

    def slots(us):  # per field and slot -> per slot, a tuple of fields
        return [tuple(u[s] for u in us) for s in range(n)]

    def axpy(alpha, xs, ys):  # per field and slot: ys + alpha * xs
        return [[ys[f][s] + alpha[rep[s]] * xs[f][s] for s in range(n)] for f in range(d)]

    def iteration(c: CGCarry) -> CGCarry:
        x, r, dd, delta, _, k = c
        q = matvec(dd)
        (dq,) = psum_dots(mesh, (slots(dd), slots(q)))
        alpha = _guarded_div(delta, dq)
        x = axpy(alpha, dd, x)
        r = axpy(tuple(-a for a in alpha), q, r)
        z = [[r[f][s] / pds[f][s] for s in range(n)] for f in range(d)]
        nd, res = psum_dots(mesh, (slots(r), slots(z)), (slots(r), slots(r)))
        beta = _guarded_div(nd, delta)
        dd = axpy(beta, dd, z)
        return CGCarry(x, r, dd, nd, res, k)

    def finish(x):
        return tuple(_unpad(gather_blocks(mesh, x[f], spec), shapes[f]) for f in range(d))

    q0 = matvec(x0s)
    r = [[bs[f][s] - q0[f][s] for s in range(n)] for f in range(d)]
    z = [[r[f][s] / pds[f][s] for s in range(n)] for f in range(d)]
    delta, res0 = psum_dots(mesh, (slots(r), slots(z)), (slots(r), slots(r)))
    return _carry(tol, rel_tol, x0s, r, z, delta, res0) + (iteration, finish)


def distributed_coupled_cg(mesh: Mesh, b_faces, x0_faces, diags, per_axis_terms, precond_diags, *,
                           tol: float = 1e-3, rel_tol: float = 1e-3, max_iter: int = 600):
    """Distributed Jacobi-PCG of the coupled 3-field viscosity system:
    every slot owns a block of all three face arrays; an iteration is one
    halo exchange of each of vx, vy, vz of the search direction along
    each split axis (every term offset has |dx| <= 1) and the dots' slot
    sums.

    Arguments are ``viscosity_term_fields``' materialised fields: diags
    and precond_diags per-axis face arrays, per_axis_terms[a] a list of
    (field, voff, coef) with coef shaped like face array a.  The face
    arrays' split axes are padded to one common multiple of the mesh so
    the blocks align.  Returns (x_faces, iters, residual, res0), iters a
    device int32.
    """
    carry, res0, thresh, iteration, finish = coupled_cg_setup(mesh, b_faces, x0_faces, diags, per_axis_terms,
                                                              precond_diags, tol=tol, rel_tol=rel_tol)
    carry = cg.loop(carry, thresh, max_iter, iteration)
    return finish(carry.x), carry.k[0], carry.res[0], res0[0]
