"""Spatially-bucketed particle residency on an (x, z) mesh, and the
shard-local transfers over it.

Counterpart of ``python_fluid_simulation_tpu.parallel.particles2d``, built
on the 1D module ``parallel/particles.py``.  Slot (ix, iz) of an
``make_mesh2d((n_x, n_z))`` mesh owns the particles whose bias-0 home cell
falls in x-planes [ix * Wx, (ix + 1) * Wx) and z-planes [iz * Wz,
(iz + 1) * Wz): rows [s * cap, (s + 1) * cap) of the flat particle arrays
with s = ix * n_z + iz (the JAX package's ``P(('x', 'z'))`` order, and
the port's slot order, ``parallel/mesh.py::_slot_coords``), padded with
inert zero-mass rows.

Residency: `rebucket_2d` runs the 1D module's bounded one-slab exchange
once a mesh axis, along the x rings and then along the z rings, so a
particle that crossed a corner reaches its diagonal neighbour through the
two phases.  Transfers: the 1D per-slot pipelines on each slot's (Wx + 2,
ny + 2, Wz + 2) extended block, whose folds and halo exchanges run
separably along array axis 0 over the x rings and along array axis 2 over
the z rings.  The (n + 1)-extent parity-class volumes keep their x tails,
z tails and corner lines apart and are assembled globally, as the JAX
package does outside its ``shard_map``.  The kernels are the 1D module's:
the scan route, the live placement, the fold (JAX's ``noclip_axes=(0,
2)``: the x and z shifts moved to start at 0 on the extended block) and
the segment broadcast, on every slot; the neighbour traffic is tensor
copies between slot blocks.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from python_fluid_simulation_tpu_torch.ops.indexing import const, rounded_sqrt
from python_fluid_simulation_tpu_torch.ops.scatter import segment_broadcast_sorted, segment_reduce_cf
from python_fluid_simulation_tpu_torch.ops.transfers import (
    SortInfo,
    _axis_offsets,
    _corner_setup,
    _corner_weight,
    _g2p_reduce,
    _p2g_channels,
    _vec,
    padding_dump_ids,
)
from python_fluid_simulation_tpu_torch.parallel.mesh import Mesh, _slot_coords, gather_blocks, split_blocks
from python_fluid_simulation_tpu_torch.parallel.particles import (
    _cat_sort,
    _exchange,
    _fold_extended,
    _home_x,
    _join_slots,
    _padded_edge,
    _place_by_slot,
    _rows,
    _slot_blocks,
    _slot_sort,
    _unsort_slots,
    _x_halo_exchange_clamped,
    _x_halo_fold,
)
from python_fluid_simulation_tpu_torch.state import Particles


class BucketSpec2D(NamedTuple):
    """Static description of the (x, z) bucketed layout."""

    n_x: int
    n_z: int
    cap: int  # particle rows a slot
    exchange_cap: int  # most crossers sent each way, each mesh axis, a rebucket
    slab_wx: int  # grid x-planes a slot
    slab_wz: int  # grid z-planes a slot


def make_bucket_spec_2d(mesh_shape, nx: int, nz: int, n_particles: int, slack: float = 1.6,
                        exchange_frac: float = 0.25, positions=None, bound_min=None, cell_size=None) -> BucketSpec2D:
    """Static bucket capacities (JAX ``make_bucket_spec_2d``): with
    ``positions`` the cap is sized from the fullest slot, else from the
    uniform average; ``slack`` above it, rounded up to 8."""
    n_x, n_z = mesh_shape
    if nx % n_x or nz % n_z:
        raise ValueError(f"bucketed-2d needs nx % n_x == 0 and nz % n_z == 0 (got {nx} % {n_x}, {nz} % {n_z})")
    wx, wz = nx // n_x, nz // n_z
    if wx < 2 or wz < 2:
        raise ValueError("bucketed-2d needs slab widths >= 2")
    if positions is not None:
        p = positions.detach().cpu().numpy() if isinstance(positions, torch.Tensor) else np.asarray(positions)
        gx = np.clip(np.floor((p[:, 0] - bound_min[0]) / cell_size[0]), 0, nx - 1).astype(np.int64)
        gz = np.clip(np.floor((p[:, 2] - bound_min[2]) / cell_size[2]), 0, nz - 1).astype(np.int64)
        per = int(np.bincount((gx // wx) * n_z + gz // wz, minlength=n_x * n_z).max())
    else:
        per = -(-n_particles // (n_x * n_z))
    cap = -(-int(per * slack) // 8) * 8
    ex = max(64, -(-int(cap * exchange_frac) // 8) * 8)
    return BucketSpec2D(n_x, n_z, cap, ex, wx, wz)


def _mesh_shape(mesh: Mesh):
    if len(mesh.axis_names) != 2:
        raise ValueError(f"the (x, z) bucketed layout needs a 2-axis mesh, got {mesh}")
    return mesh.shape[mesh.axis_names[0]], mesh.shape[mesh.axis_names[1]]


def spec_from_state_2d(n_rows: int, mesh: Mesh, nx: int, nz: int) -> BucketSpec2D:
    """The `BucketSpec2D` of an already bucketed particle array."""
    n_x, n_z = _mesh_shape(mesh)
    n_dev = n_x * n_z
    if n_rows % n_dev or nx % n_x or nz % n_z:
        raise ValueError(f"{n_rows} rows, {nx} x- and {nz} z-cells do not split over a ({n_x}, {n_z}) mesh")
    if nx // n_x < 2 or nz // n_z < 2:
        raise ValueError("bucketed-2d needs slab widths >= 2")
    cap = n_rows // n_dev
    return BucketSpec2D(n_x, n_z, cap, max(64, -(-cap // 4 // 8) * 8), nx // n_x, nz // n_z)


def _check_mesh(mesh: Mesh, spec: BucketSpec2D):
    if _mesh_shape(mesh) != (spec.n_x, spec.n_z):
        raise ValueError(f"the bucketed layout of ({spec.n_x}, {spec.n_z}) slots needs a mesh of that shape, "
                         f"got {mesh}")


def _slab(px_a, bound_min_a: float, h_a: float, n: int, w: int):
    return torch.div(_home_x(px_a, bound_min_a, h_a, n), w, rounding_mode="floor")


def bucket_particles_2d(particles: Particles, mesh: Mesh, spec: BucketSpec2D, bound_min, cell_size) -> Particles:
    """The first bucketing, over the whole set, into the (x, z)
    slot-major layout (on slot 0's device), slot ``ix * n_z + iz``."""
    _check_mesh(mesh, spec)
    n_dev = spec.n_x * spec.n_z
    p = Particles(*(t.to(mesh.devices[0]) for t in (particles.x, particles.v, particles.c, particles.m)))
    sx = _slab(p.x[:, 0], bound_min[0], cell_size[0], spec.slab_wx * spec.n_x, spec.slab_wx)
    sz = _slab(p.x[:, 2], bound_min[2], cell_size[2], spec.slab_wz * spec.n_z, spec.slab_wz)
    return _place_by_slot(p, torch.where(p.m > 0, sx * spec.n_z + sz, n_dev), n_dev, spec.cap)


def rebucket_2d(particles: Particles, mesh: Mesh, spec: BucketSpec2D, bound_min, cell_size):
    """The bounded one-slab exchange along the x rings, then along the z
    rings.  Returns (particles, lost): ``lost`` (int32, on slot 0's
    device) sums both phases' overflow drops."""
    _check_mesh(mesh, spec)
    ax_x, ax_z = mesh.axis_names
    nx, nz = spec.slab_wx * spec.n_x, spec.slab_wz * spec.n_z
    blocks = _slot_blocks(mesh, particles, spec.cap)
    blocks, of_x = _exchange(blocks, mesh.rings(ax_x),
                             lambda x: _slab(x[:, 0], bound_min[0], cell_size[0], nx, spec.slab_wx),
                             spec.cap, spec.exchange_cap)
    blocks, of_z = _exchange(blocks, mesh.rings(ax_z),
                             lambda x: _slab(x[:, 2], bound_min[2], cell_size[2], nz, spec.slab_wz),
                             spec.cap, spec.exchange_cap)
    return _join_slots(mesh, blocks, [a + b.to(a.device) for a, b in zip(of_x, of_z)])


# ---------------------------------------------------------------------------
# separable neighbour traffic: the 1D folds and exchanges along each ring,
# on array axis 0 (the x rings) or 2 (the z rings)
# ---------------------------------------------------------------------------

def _halo_fold_ax(mesh: Mesh, blocks, width: int, axis_name: str, dim: int, combine: str = "add", fill=0.0,
                  keep_high_tail: bool = False):
    """`_x_halo_fold` of each slot's block along array axis ``dim``, over
    the rings of mesh axis ``axis_name``.  Returns (the owned blocks, in
    slot order, contiguous; with ``keep_high_tail`` each ring's tail, ring
    by ring, else None)."""
    out, tails = list(blocks), []
    for ring in mesh.rings(axis_name):
        owned, tail = _x_halo_fold([blocks[s].movedim(dim, 0) for s in ring], width, combine, fill, keep_high_tail)
        for s, o in zip(ring, owned):
            out[s] = o.movedim(0, dim).contiguous()
        tails.append(None if tail is None else tail.contiguous())
    return out, (tails if keep_high_tail else None)


def _halo_exchange_clamped_ax(mesh: Mesh, blocks, width: int, axis_name: str, dim: int):
    """`_x_halo_exchange_clamped` of each slot's block along array axis
    ``dim``, over the rings of mesh axis ``axis_name`` (contiguous)."""
    out = list(blocks)
    for ring in mesh.rings(axis_name):
        ext = _x_halo_exchange_clamped([blocks[s].movedim(dim, 0) for s in ring], width)
        for s, e in zip(ring, ext):
            out[s] = e.movedim(0, dim).contiguous()
    return out


def _local_ext_ids_2d(gi, lo_x: int, wx: int, ny: int, lo_z: int, wz: int):
    """Ids on a slot's (wx + 2, ny + 2, wz + 2) extended block."""
    ext = (wx + 2, ny + 2, wz + 2)
    gx = torch.clamp(gi[:, 0].to(torch.int64) - lo_x + 1, 0, wx + 1)
    gy = torch.clamp(gi[:, 1].to(torch.int64) + 1, 0, ny + 1)
    gz = torch.clamp(gi[:, 2].to(torch.int64) - lo_z + 1, 0, wz + 1)
    return (gx * ext[1] + gy) * ext[2] + gz, ext


def _slots(mesh: Mesh, spec: BucketSpec2D):
    """(slot, device, lo_x, lo_z) of every slot."""
    ax_x, ax_z = mesh.axis_names
    for s, dev in enumerate(mesh.devices):
        c = _slot_coords(mesh, s)
        yield s, dev, c[ax_x] * spec.slab_wx, c[ax_z] * spec.slab_wz


def _fold_owned(mesh: Mesh, exts, width: int, combine: str = "add", fill=0.0):
    """Each slot's (W + 2 width)-extended block folded along x, then z,
    onto its owned block."""
    ax_x, ax_z = mesh.axis_names
    owned, _ = _halo_fold_ax(mesh, exts, width, ax_x, 0, combine, fill)
    return _halo_fold_ax(mesh, owned, width, ax_z, 2, combine, fill)[0]


def _ring_cat(tails, dim: int, device):
    """The tails of a ring's slots (each on its slot's device) joined on `device`."""
    return torch.cat([t.to(device) for t in tails], dim=dim)


def sharded_p2g_all_2d(particles: Particles, mesh: Mesh, spec: BucketSpec2D, gres, face_shapes, biases, bound_min,
                       cell_size, volume=None, mass_floor: float = 0.0):
    """(x, z)-mesh shard-local `transfers.p2g_all`: the 1D pipeline with
    width-1 folds along x and z.  The parity-class volumes' x tails (the
    last x slot's spill planes, one a z ring position), z tails and corner
    lines are assembled globally.  Returns (gm_list, gv_list[,
    vol_classes], sort_info) as `particles.sharded_p2g_all`."""
    _check_mesh(mesh, spec)
    ax_x, ax_z = mesh.axis_names
    d = len(gres)
    if d != 3:
        raise ValueError("the (x, z) bucketed layout is 3D")
    wx, wz, cap = spec.slab_wx, spec.slab_wz, spec.cap
    ny = int(gres[1])
    ext = (wx + 2, ny + 2, wz + 2)
    outs, vol_exts, sorts = None, {}, []
    for s, dev, lo_x, lo_z in _slots(mesh, spec):
        px, pm, pv, pc = (_rows(mesh, t, s) for t in (particles.x, particles.m, particles.v, particles.c))
        gi0, _, _ = _corner_setup(px, bound_min, cell_size, (0.0,) * d)
        ids, _ = _local_ext_ids_2d(gi0, lo_x, wx, ny, lo_z, wz)
        sorted_ids, order, px_s, pm_s, pv_s, pc_s = _slot_sort(padding_dump_ids(ids, pm, ext), px, pm, pv, pc)
        sorts.append((sorted_ids, order, px_s))
        blocks, specs, vol_rs = _p2g_channels(px_s, pm_s, pv_s, pc_s, biases, bound_min, cell_size, volume)
        seg_cf = segment_reduce_cf(torch.cat(blocks, dim=-1), sorted_ids, math.prod(ext), ext)
        slot_outs = []
        for a in range(d):
            idxs = [j for j, (aa, _) in enumerate(specs) if aa == a]
            axis_shifts = [tuple(c - 1 for c in ((-1, 0, 1) if biases[a][dd] != 0.0 else (0, 1))) for dd in range(d)]
            acc_x = (wx + 2) + (max(axis_shifts[0]) - min(axis_shifts[0]))
            acc_z = (wz + 2) + (max(axis_shifts[2]) - min(axis_shifts[2]))
            s0x, s0z = -1 - min(axis_shifts[0]), -1 - min(axis_shifts[2])
            for chsel in ([2 * j for j in idxs], [2 * j + 1 for j in idxs]):
                folded = _fold_extended(seg_cf[chsel], axis_shifts, (acc_x, ny, acc_z), noclip_axes=(0, 2))
                # plane j of a noclip axis is global row lo + j + min; the targets lie in [lo - 1, hi]
                slot_outs.append(folded[s0x:s0x + wx + 2, :, s0z:s0z + wz + 2])
        outs = [[o] for o in slot_outs] if outs is None else [acc + [o] for acc, o in zip(outs, slot_outs)]
        if volume is not None:
            n_p2g = 2 * len(specs)
            for p in itertools.product((0, 1), repeat=d):
                sel = [n_p2g + i for i, r in enumerate(vol_rs) if all(ra % 2 == pa for ra, pa in zip(r, p))]
                axis_shifts = [(-1, 0) if pp == 0 else (-1,) for pp in p]
                ny_c = ny + 1 if p[1] == 0 else ny
                acc = ((wx + 2) + (0 if p[0] else 1), ny_c, (wz + 2) + (0 if p[2] else 1))
                folded = _fold_extended(seg_cf[sel], axis_shifts, acc, noclip_axes=(0, 2))
                # plane t of a noclip axis is global class row lo + t - 1:
                # parity 0 owns [lo, hi] (w + 1 planes, the high one the
                # neighbour's lo, or the tail), parity 1 [lo, hi) (no spill)
                e = folded[1:(2 + wx if p[0] == 0 else 1 + wx), :, 1:(2 + wz if p[2] == 0 else 1 + wz)]
                vol_exts.setdefault(p, []).append(e)
    grids = [gather_blocks(mesh, _fold_owned(mesh, o, 1)) for o in outs]
    base_shape = tuple(int(n) for n in gres)
    gms, gvs = [], []
    for a in range(d):
        gm, gv_m = grids[2 * a], grids[2 * a + 1]
        den = torch.clamp(gm, min=mass_floor) if mass_floor else torch.where(gm > 0, gm, 1.0)
        gv = torch.where(gm > 0, gv_m / den, 0.0)
        # the trailing face plane never receives mass (reference cell 2 :128)
        pad = []
        for i in reversed(range(d)):
            pad += [0, int(face_shapes[a][i]) - base_shape[i]]
        gms.append(F.pad(gm, pad))
        gvs.append(F.pad(gv, pad))
    si = _cat_sort(mesh, sorts, ext)
    if volume is None:
        return gms, gvs, si
    fine_vol = math.prod(volume[1])
    classes = {p: _volume_class(mesh, p, e, fine_vol) for p, e in vol_exts.items()}
    return gms, gvs, classes, si


def _volume_class(mesh: Mesh, p, exts, fine_vol: float):
    """One parity class from the slots' extended blocks: the owned blocks
    gathered, then (parity 0 along z) the z tails as plane nz, and
    (parity 0 along x) the x tails, with the corner line, as plane nx."""
    ax_x, ax_z = mesh.axis_names
    xtails = ztails = None
    if p[0] == 0:
        exts, xtails = _halo_fold_ax(mesh, [torch.cat([torch.zeros_like(e[:1]), e]) for e in exts], 1, ax_x, 0,
                                     keep_high_tail=True)
    if p[2] == 0:
        exts, ztails = _halo_fold_ax(mesh, [torch.cat([torch.zeros_like(e[..., :1]), e], dim=2) for e in exts], 1,
                                     ax_z, 2, keep_high_tail=True)
    cls = gather_blocks(mesh, exts)
    if ztails is not None:  # one a z ring, that is an x slot: (wx, ny_c) each
        cls = torch.cat([cls, _ring_cat(ztails, 0, cls.device)[:, :, None]], dim=2)
    if xtails is not None:  # one an x ring, that is a z slot: (ny_c, wz [+ 1]) each
        if p[2] == 0:
            # the x tails are z-sharded: fold their z spill along the z ring,
            # the last slot's kept as the corner line
            xt, corner = _x_halo_fold([torch.cat([torch.zeros_like(t[:, :1]), t], dim=1).movedim(1, 0)
                                       for t in xtails], 1, keep_high_tail=True)
            xplane = _ring_cat([t.movedim(0, 1) for t in xt], 1, cls.device)
            plane = torch.cat([xplane, corner.to(cls.device)[:, None]], dim=1)
        else:
            plane = _ring_cat(xtails, 1, cls.device)
        cls = torch.cat([cls, plane[None]], dim=0)
    return torch.clamp(cls, max=fine_vol)


def sharded_fluid_levelset_2d(p_x, p_m, mesh: Mesh, spec: BucketSpec2D, gres, bound_min, cell_size, gdx: float):
    """(x, z)-mesh shard-local union-of-balls level set: each slot's 5^3
    scatter-min over its block, then width-2 min-folds along x and z.
    Returns the (nx, ny, nz) field on slot 0's device."""
    _check_mesh(mesh, spec)
    d = len(gres)
    wx, wz, cap = spec.slab_wx, spec.slab_wz, spec.cap
    ny = int(gres[1])
    background = 3.0 * gdx
    r = gdx * 0.5 * math.sqrt(float(d)) * 1.02
    offsets = list(itertools.product(range(-2, 3), repeat=d))
    exts = []
    for s, dev, lo_x, lo_z in _slots(mesh, spec):
        px, pm = _rows(mesh, p_x, s), _rows(mesh, p_m, s)
        hi_clip = const(tuple(int(n) - 1 for n in gres), torch.int32, dev)
        gi = torch.minimum(torch.clamp(torch.floor((px - _vec(bound_min, px)) / _vec(cell_size, px)).to(torch.int32),
                                       min=0), hi_clip)
        # the homes are resident: x in [lo_x, lo_x + wx), z in [lo_z, lo_z + wz)
        ids = ((torch.clamp(gi[:, 0].to(torch.int64) - lo_x, 0, wx - 1) * ny + gi[:, 1]) * wz
               + torch.clamp(gi[:, 2].to(torch.int64) - lo_z, 0, wz - 1))
        sorted_ids, _, px_s, gi_s, pm_s = _slot_sort(padding_dump_ids(ids, pm, (wx, ny, wz)), px, gi, pm)
        offs = const(tuple(offsets), torch.int32, dev)
        dist2 = None
        for ax in range(d):
            gii = torch.clamp(gi_s[:, ax][:, None] + offs[None, :, ax], 0, int(gres[ax]) - 1)
            cd = (gii.to(px.dtype) + 0.5) * cell_size[ax] + bound_min[ax] - px_s[:, ax][:, None]
            dist2 = cd * cd if dist2 is None else dist2 + cd * cd
        vals = torch.where(pm_s[:, None] > 0, rounded_sqrt(dist2) - r, background)
        seg = segment_reduce_cf(vals, sorted_ids, wx * ny * wz, (wx, ny, wz), "min", background)
        exts.append(_fold_extended(seg, [tuple(range(-2, 3))] * d, (wx + 4, ny, wz + 4), "min", background,
                                   noclip_axes=(0, 2)))
    return gather_blocks(mesh, _fold_owned(mesh, exts, 2, "min", background))


def _table(mesh: Mesh, spec: BucketSpec2D, chans_of, sort_info: SortInfo, reduce_slot):
    """Per slot: the corner table ``chans_of(s)`` broadcast over the slot's
    sorted rows, reduced by ``reduce_slot(vals, px_sorted)``; unsorted
    into the bucketed row order on slot 0's device."""
    cap = spec.cap
    res = []
    for s, dev in enumerate(mesh.devices):
        vals = segment_broadcast_sorted(torch.stack(chans_of(s), dim=-1),
                                        _rows(mesh, sort_info.sorted_ids, s))
        res.append(reduce_slot(vals, _rows(mesh, sort_info.px_sorted, s)))
    return _unsort_slots(mesh, spec, res, sort_info)


def sharded_g2p_all_2d(gvs, mesh: Mesh, spec: BucketSpec2D, gres, biases, bound_min, cell_size, sort_info: SortInfo):
    """(x, z)-mesh shard-local `transfers.g2p_all`: each slot's
    face-velocity block extended by the clamped width-1 halo along x,
    then z, then the corner table, the segment broadcast over
    `sharded_p2g_all_2d`'s per-slot sort and the weights.  Returns (pv, pc)
    in the bucketed row order."""
    _check_mesh(mesh, spec)
    ax_x, ax_z = mesh.axis_names
    d = len(gres)
    wx, wz = spec.slab_wx, spec.slab_wz
    offs_lists = [_axis_offsets(biases[a], d) for a in range(d)]
    base_shape = tuple(int(n) for n in gres)
    sizes = (wx + 2, base_shape[1] + 2, wz + 2)
    # the trailing face planes are never read (clamp to gres - 1)
    halos = []
    for g in gvs:
        blocks = split_blocks(mesh, g[tuple(slice(0, n) for n in base_shape)])
        blocks = _halo_exchange_clamped_ax(mesh, blocks, 1, ax_x, 0)
        halos.append(_halo_exchange_clamped_ax(mesh, blocks, 1, ax_z, 2))

    def chans_of(s):
        chans = []
        for a in range(d):
            # x and z: one more edge plane a side (the ext ids' margin rows); y: the global clamp's two
            padded = _padded_edge(halos[a][s], [(1, 1), (2, 2), (1, 1)])
            for o in offs_lists[a]:
                start = tuple(1 + oo for oo in o)
                chans.append(padded[tuple(slice(b, b + z) for b, z in zip(start, sizes))].reshape(-1))
        return chans

    res = _table(mesh, spec, chans_of, sort_info,
                 lambda vals, px_s: _g2p_reduce(vals, px_s, offs_lists, biases, bound_min, cell_size))
    pv = res[:, 0::(1 + d)]
    pc = torch.stack([res[:, a * (1 + d) + 1:(a + 1) * (1 + d)] for a in range(d)], dim=1)
    return pv, pc


def sharded_scatter_mass_volume_2d(p_x, p_m, mesh: Mesh, spec: BucketSpec2D, gres, pvol, bound_min, cell_size):
    """(x, z)-mesh shard-local `density.scatter_mass_volume` over a
    per-slot sort of the center-biased homes, kept for
    `sharded_apply_displacement_2d`.  Returns (gm, gvol, sort_info)."""
    _check_mesh(mesh, spec)
    d = len(gres)
    wx, wz, cap = spec.slab_wx, spec.slab_wz, spec.cap
    ny = int(gres[1])
    corners = list(itertools.product((0, 1), repeat=d))
    exts, sorts = ([], []), []
    for s, dev, lo_x, lo_z in _slots(mesh, spec):
        px, pm = _rows(mesh, p_x, s), _rows(mesh, p_m, s)
        gi, _, _ = _corner_setup(px, bound_min, cell_size, (0.5,) * d)
        ids, ext = _local_ext_ids_2d(gi, lo_x, wx, ny, lo_z, wz)
        sorted_ids, order, px_s, pm_s = _slot_sort(padding_dump_ids(ids, pm, ext), px, pm)
        sorts.append((sorted_ids, order, px_s))
        _, _, w = _corner_setup(px_s, bound_min, cell_size, (0.5,) * d)
        pv = pvol * (pm_s > 0)
        chans = []
        for offs in corners:
            weight = _corner_weight(w, offs)
            chans.append(weight * pm_s)
            chans.append(weight * pv)
        seg_cf = segment_reduce_cf(torch.stack(chans, dim=-1), sorted_ids, math.prod(ext), ext)
        for i, chsel in enumerate((list(range(0, 2 * len(corners), 2)), list(range(1, 2 * len(corners), 2)))):
            # corner shifts {-1, 0}: plane j of x and z is global row lo + j - 1, the targets [lo - 1, hi]
            acc = _fold_extended(seg_cf[chsel], [(-1, 0)] * d, (wx + 3, ny, wz + 3), noclip_axes=(0, 2))
            exts[i].append(acc[:wx + 2, :, :wz + 2])
    gm, gvol = (gather_blocks(mesh, _fold_owned(mesh, e, 1)) for e in exts)
    return gm, gvol, _cat_sort(mesh, sorts, (wx + 2, ny + 2, wz + 2))


def sharded_apply_displacement_2d(disp_faces, mesh: Mesh, spec: BucketSpec2D, gres, bound_min, cell_size,
                                  sort_info: SortInfo):
    """(x, z)-mesh shard-local `density.apply_displacement_all`: each
    slot's displacement face blocks extended by clamped width-2 halos
    along x and z (the own-axis offsets from the center home are {0, 1,
    2}), the corner table, the segment broadcast over
    `sharded_scatter_mass_volume_2d`'s per-slot sort and the weights.  The
    x-face array's trailing x-plane and the z-face array's trailing z-plane
    (gather targets) are the last slot's high halo along their own axis,
    set before the other axis' exchange so boundary slots hand their
    neighbours the true tail values.  Returns the (K, d) displacement in
    the bucketed row order."""
    _check_mesh(mesh, spec)
    ax_x, ax_z = mesh.axis_names
    d = len(gres)
    wx, wz = spec.slab_wx, spec.slab_wz
    nx, nz = int(gres[0]), int(gres[2])
    n_x, n_z = spec.n_x, spec.n_z
    offs_lists = [list(itertools.product(*[(0, 1, 2) if k == a else (0, 1) for k in range(d)])) for a in range(d)]
    # the sharded axes cut to their base extents (the trailing planes ride
    # the tails); the y face keeps its ny + 1 y-planes (unsharded)
    base = [split_blocks(mesh, f[:nx, :, :nz]) for f in disp_faces]
    tail_x = disp_faces[0][nx, :, :nz]  # (ny, nz): x-face plane nx
    tail_z = disp_faces[2][:nx, :, nz]  # (nx, ny): z-face plane nz
    coords = [_slot_coords(mesh, s) for s in range(mesh.size)]

    def set_tail(blocks, dim, last_of, tail_of):
        out = []
        for s, gh in enumerate(blocks):
            if last_of(coords[s]):  # gh is the exchange's own new tensor
                t = tail_of(coords[s]).to(gh.device)
                gh.narrow(dim, gh.shape[dim] - 2, 1).copy_(t.unsqueeze(dim))
                gh.narrow(dim, gh.shape[dim] - 1, 1).copy_(t.unsqueeze(dim))
            out.append(gh)
        return out

    halos = []
    for a in range(d):
        if a == 2:
            gh = _halo_exchange_clamped_ax(mesh, base[a], 2, ax_z, 2)
            gh = set_tail(gh, 2, lambda c: c[ax_z] == n_z - 1, lambda c: tail_z[c[ax_x] * wx:(c[ax_x] + 1) * wx])
            gh = _halo_exchange_clamped_ax(mesh, gh, 2, ax_x, 0)
        else:
            gh = _halo_exchange_clamped_ax(mesh, base[a], 2, ax_x, 0)
            if a == 0:
                gh = set_tail(gh, 0, lambda c: c[ax_x] == n_x - 1,
                              lambda c: tail_x[:, c[ax_z] * wz:(c[ax_z] + 1) * wz])
            gh = _halo_exchange_clamped_ax(mesh, gh, 2, ax_z, 2)
        halos.append(gh)
    sizes = (wx + 2, int(gres[1]) + 2, wz + 2)

    def chans_of(s):
        chans = []
        for a in range(d):
            padded = _padded_edge(halos[a][s], [(1, 1), (1, 2) if a == 1 else (2, 2), (1, 1)])
            for o in offs_lists[a]:
                start = (o[0] + 2, o[1] if a == 1 else 1 + o[1], o[2] + 2)
                chans.append(padded[tuple(slice(b, b + z) for b, z in zip(start, sizes))].reshape(-1))
        return chans

    def reduce_slot(vals, px_s):
        dev = vals.device
        gi_c, _, _ = _corner_setup(px_s, bound_min, cell_size, (0.5,) * d)
        outs, col = [], 0
        for a in range(d):
            gi_a, _, w_a = _corner_setup(px_s, bound_min, cell_size, tuple(0.0 if j == a else 0.5 for j in range(d)))
            o = const(tuple(offs_lists[a]), torch.int32, dev)[None, :, :] - (gi_a - gi_c)[:, None, :]
            zero = torch.zeros((), dtype=w_a.dtype, device=dev)
            wd = torch.where(o == 0, (1.0 - w_a)[:, None, :], torch.where(o == 1, w_a[:, None, :], zero))
            weight = wd[..., 0]
            for j in range(1, d):
                weight = weight * wd[..., j]
            n_o = len(offs_lists[a])
            outs.append(torch.sum(weight * vals[:, col:col + n_o], dim=-1))
            col += n_o
        return torch.stack(outs, dim=-1)

    return _table(mesh, spec, chans_of, sort_info, reduce_slot)
