"""Spatially-bucketed particle residency on a 1D slab mesh, and the
shard-local transfers over it.

Counterpart of ``python_fluid_simulation_tpu.parallel.particles``.  In the
index-sharded layout (``parallel/mesh.py::shard_state``) every transfer
reads the whole particle set; here each particle *resides* in the slot
that owns its x-slab of the grid, and each transfer is a per-slot pass
over that slot's particles and its own grid slab, with one or two
x-planes of each output (or input) crossing to the neighbouring slot.

Layout (the JAX package's): particle arrays are (n_dev * cap, ...),
slot-major -- rows [k * cap, (k + 1) * cap) are slot k's and hold the
particles whose bias-0 home cell x-index falls in slab k, padded with
inert zero-mass rows.  As everywhere in the port's single-controller
mesh, the arrays live on slot 0's device, and each slot's work runs on
its block (`particle_sharding`'s split) on its own device: one card for
every slot of ``make_mesh(n)``, card i for slot i of a mesh over the
cards, where the crossers and the spill planes move over NVLink.

Residency: `rebucket` runs after each particle move.  Under the CFL
limit a particle moves less than one cell a step, so crossers only reach
the adjacent slab: each slot sends at most ``exchange_cap`` particles to
each side and compacts its survivors and arrivals back into its ``cap``
rows.  An overflow of either bound drops the excess particles' mass to
0 (inert) and is counted in the returned ``lost``.  The sorts are
stable (JAX's ``argsort`` is), so the rows land in the same slots in
the same order as the JAX package's.

Neighbour traffic: JAX's ``ppermute`` exchanges (the crossers, the spill
planes of the scatters' folds, the gathers' clamped halos) are tensor
copies and adds between slot blocks along the mesh's x ring, clamped at
the domain's ends (not periodic).  The per-slot reduces, folds and
broadcasts are the port's kernels: on the card the segmented scan and
the live placement (``ops/cuda_scan.py``, ``ops/cuda_binned.py``), the
fold (``ops/cuda_fold.py``; JAX's ``noclip_axes=(0,)`` is the fold with
the x shifts moved to start at 0 onto the extended slab, where nothing
clips) and the segment broadcast, on every slot.
"""

from __future__ import annotations

import itertools
import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from python_fluid_simulation_tpu_torch.ops.indexing import const, rounded_sqrt
from python_fluid_simulation_tpu_torch.ops.scatter import (
    fold_scattered_sep,
    segment_broadcast_sorted,
    segment_reduce_cf,
    unsort_rows,
)
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
from python_fluid_simulation_tpu_torch.parallel.mesh import Mesh, particle_sharding, split_blocks
from python_fluid_simulation_tpu_torch.state import Particles


class BucketSpec(NamedTuple):
    """Static description of the bucketed layout."""

    n_dev: int
    cap: int  # particle rows a slot
    exchange_cap: int  # most crossers sent each way a rebucket
    slab_w: int  # grid x-planes a slot (nx // n_dev)


def make_bucket_spec(n_dev: int, nx: int, n_particles: int, slack: float = 1.6, exchange_frac: float = 0.25,
                     positions=None, bound_min=None, cell_size=None) -> BucketSpec:
    """Static bucket capacities.  With ``positions`` (an array or tensor,
    with bound_min / cell_size) the cap is sized from the fullest slab,
    else from the uniform average; ``slack`` above it, rounded up to 8."""
    if nx % n_dev:
        raise ValueError(f"bucketed mode needs nx % n_dev == 0 (got {nx} % {n_dev})")
    if nx // n_dev < 2:
        raise ValueError("bucketed mode needs slab_w >= 2 (width-2 level-set halos)")
    slab_w = nx // n_dev
    if positions is not None:
        pos = positions.detach().cpu().numpy() if isinstance(positions, torch.Tensor) else np.asarray(positions)
        gi = np.clip(np.floor((pos[:, 0] - bound_min[0]) / cell_size[0]).astype(np.int64), 0, nx - 1)
        per = int(np.bincount(gi // slab_w, minlength=n_dev).max())
    else:
        per = -(-n_particles // n_dev)
    cap = -(-int(per * slack) // 8) * 8
    ex = max(64, -(-int(cap * exchange_frac) // 8) * 8)
    return BucketSpec(n_dev, cap, ex, slab_w)


def spec_from_state(n_rows: int, n_dev: int, nx: int) -> BucketSpec:
    """The `BucketSpec` of an already bucketed particle array."""
    if n_rows % n_dev or nx % n_dev:
        raise ValueError(f"{n_rows} rows and {nx} x-cells do not split over {n_dev} slots")
    if nx // n_dev < 2:
        raise ValueError("bucketed mode needs slab_w >= 2")
    cap = n_rows // n_dev
    return BucketSpec(n_dev, cap, max(64, -(-cap // 4 // 8) * 8), nx // n_dev)


def resident(particles: Particles, n_dev: int, nx: int, bound_min, cell_size) -> bool:
    """Whether a particle array already has the slot-major layout over
    ``n_dev`` slots, as a bucketed run's state (and its checkpoints) holds
    it: n_dev equal row blocks, every live row in its own slot's x-slab.
    One host read."""
    n = particles.x.shape[0]
    if n % n_dev or nx % n_dev or nx // n_dev < 2:
        return False
    slab = torch.div(_home_x(particles.x[:, 0], bound_min[0], cell_size[0], nx), nx // n_dev, rounding_mode="floor")
    slot = torch.div(torch.arange(n, device=slab.device), n // n_dev, rounding_mode="floor")
    return bool(((slab == slot) | (particles.m <= 0)).all())


def _check_mesh(mesh: Mesh, spec: BucketSpec):
    if len(mesh.axis_names) != 1 or mesh.size != spec.n_dev:
        raise ValueError(f"the bucketed layout of {spec.n_dev} slots needs a 1D mesh of as many slots, got {mesh}")


def _home_x(px_x, bound_min_x: float, h_x: float, nx: int):
    return torch.clamp(torch.floor((px_x - bound_min_x) / h_x).to(torch.int32), 0, nx - 1)


def _argsort(key):
    return torch.sort(key, stable=True).indices


def _rows(mesh: Mesh, a, k: int):
    """Slot k's block of a slot-major array, on the slot's device
    (`particle_sharding`'s)."""
    return particle_sharding(mesh).block(a, k)


def _mask_rows(ok, a):
    return torch.where(ok.reshape((-1,) + (1,) * (a.ndim - 1)), a, torch.zeros((), dtype=a.dtype, device=a.device))


def _place_by_slot(p: Particles, slot, n_dev: int, cap: int) -> Particles:
    """The rows of `p` (on one device) placed by their slot: sorted stably
    by slot (``slot`` n_dev for inert rows, which sort last), numbered
    within their slot; rows past a slot's ``cap`` and inert rows are
    dropped.  Returns the (n_dev * cap, ...) slot-major arrays."""
    dev = p.x.device
    order = _argsort(slot)
    xs, vs, cs, ms = (t[order] for t in (p.x, p.v, p.c, p.m))
    slot_s = slot[order]
    k = slot_s.shape[0]
    first = torch.ones(k, dtype=torch.bool, device=dev)
    first[1:] = slot_s[1:] != slot_s[:-1]
    ar = torch.arange(k, dtype=torch.int32, device=dev)
    within = ar - torch.cummax(torch.where(first, ar, 0), dim=0).values
    valid = (ms > 0) & (within < cap) & (slot_s < n_dev)
    dest = torch.where(valid, slot_s * cap + within, n_dev * cap).long()  # row n_dev * cap is dropped

    def place(a):
        buf = torch.zeros((n_dev * cap + 1,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        buf[dest] = _mask_rows(valid, a)
        return buf[:-1]

    return Particles(x=place(xs), v=place(vs), c=place(cs), m=place(ms))


def bucket_particles(particles: Particles, mesh: Mesh, spec: BucketSpec, bound_min, cell_size) -> Particles:
    """The first bucketing, over the whole set, into the slot-major
    layout (on slot 0's device): rows sorted stably by slab (inert rows
    last), numbered within their slab; rows past a slab's ``cap`` and
    inert rows are dropped."""
    _check_mesh(mesh, spec)
    n_dev = spec.n_dev
    dev = mesh.devices[0]
    p = Particles(*(t.to(dev) for t in (particles.x, particles.v, particles.c, particles.m)))
    slab = torch.div(_home_x(p.x[:, 0], bound_min[0], cell_size[0], spec.slab_w * n_dev), spec.slab_w,
                     rounding_mode="floor")
    return _place_by_slot(p, torch.where(p.m > 0, slab, n_dev), n_dev, spec.cap)


def _group(mask, rows, ex: int):
    """The rows where mask, compacted stably into ex rows (m = 0 past them)."""
    order = _argsort(torch.where(mask, 0, 1).to(torch.int32))[:ex]
    ok = mask[order]
    return tuple(_mask_rows(ok, t[order]) for t in rows)


def _exchange(blocks, rings, slab_of, cap: int, ex: int):
    """The bounded one-slab exchange along each ring of slots: each
    slot's block ``blocks[s]`` (x, v, c, m on its device) sends at most
    ``ex`` rows to each ring neighbour (zeros past the ring's ends) and
    compacts its survivors and arrivals stably into ``cap`` rows.
    ``slab_of(x)`` is each row's position along the ring.  Returns (the
    new blocks, each slot's overflow count, int32)."""
    out, overflow = list(blocks), [None] * len(blocks)
    for ring in rings:
        n = len(ring)
        sends, kept = [], []
        for j, s in enumerate(ring):
            x, v, c, m = blocks[s]
            live = m > 0
            # under CFL |slab - j| <= 1; anything wilder goes to the
            # neighbour, and the next rebucket carries it on
            dest = torch.clamp(slab_of(x), j - 1, j + 1)
            go_l, go_r, stay = live & (dest < j), live & (dest > j), live & (dest == j)
            sends.append((_group(go_l, blocks[s], ex), _group(go_r, blocks[s], ex)))
            overflow[s] = (torch.clamp(go_l.sum(dtype=torch.int32) - ex, min=0)
                           + torch.clamp(go_r.sum(dtype=torch.int32) - ex, min=0))
            kept.append((x, v, c, torch.where(stay, m, torch.zeros((), dtype=m.dtype, device=m.device))))
        for j, s in enumerate(ring):
            dev = kept[j][0].device
            # arrivals: the left neighbour's right-going rows, the right
            # neighbour's left-going rows; zeros at the ring's ends
            zeros = tuple(torch.zeros_like(t) for t in sends[j][0])
            in_l = tuple(t.to(dev) for t in sends[j - 1][1]) if j > 0 else zeros
            in_r = tuple(t.to(dev) for t in sends[j + 1][0]) if j < n - 1 else zeros
            merged = [torch.cat([a, b, c]) for a, b, c in zip(kept[j], in_l, in_r)]
            mm = merged[3]
            overflow[s] = overflow[s] + torch.clamp((mm > 0).sum(dtype=torch.int32) - cap, min=0)
            order = _argsort(torch.where(mm > 0, 0, 1).to(torch.int32))[:cap]
            out[s] = tuple(t[order] for t in merged)
    return out, overflow


def _slot_blocks(mesh: Mesh, particles: Particles, cap: int):
    return [tuple(_rows(mesh, t, k) for t in (particles.x, particles.v, particles.c, particles.m))
            for k, dev in enumerate(mesh.devices)]


def _join_slots(mesh: Mesh, blocks, overflow):
    """(the slots' blocks as slot-major particles on slot 0's device, the
    overflow counts summed there)."""
    dev0 = mesh.devices[0]
    lost = torch.zeros((), dtype=torch.int32, device=dev0)
    for of in overflow:
        lost = lost + of.to(dev0)
    return Particles(*(torch.cat([b[i].to(dev0) for b in blocks]) for i in range(4))), lost


def rebucket(particles: Particles, mesh: Mesh, spec: BucketSpec, bound_min, cell_size):
    """The bounded one-slab exchange that restores residency after a move.

    Returns (particles, lost): ``lost`` (int32, on slot 0's device) counts
    the particles dropped to inert because an exchange buffer or a bucket
    overflowed (0 in a healthy run: the caps carry 1.6x / 0.25x slack)."""
    _check_mesh(mesh, spec)
    nx = spec.slab_w * spec.n_dev

    def slab_of(x):
        return torch.div(_home_x(x[:, 0], bound_min[0], cell_size[0], nx), spec.slab_w, rounding_mode="floor")

    blocks, overflow = _exchange(_slot_blocks(mesh, particles, spec.cap), [list(range(spec.n_dev))], slab_of,
                                 spec.cap, spec.exchange_cap)
    return _join_slots(mesh, blocks, overflow)


# ---------------------------------------------------------------------------
# neighbour traffic of the shard-local transfers (JAX's ppermute folds)
# ---------------------------------------------------------------------------

def _comb(a, b, combine):
    return a + b if combine == "add" else torch.minimum(a, b)


def _reduce_planes(block, combine):
    return torch.sum(block, dim=0) if combine == "add" else torch.amin(block, dim=0)


def _x_halo_fold(exts: List[torch.Tensor], width: int, combine: str = "add", fill=0.0, keep_high_tail=False):
    """Fold each slot's x-extended field (W + 2 width planes, covering
    global rows [lo - width, hi + width)) onto its owned W planes: the
    spill planes go to the neighbour that owns them and combine there,
    and at the domain's ends they fold into the boundary row (the
    reference's per-corner border clamp, applied to the whole domain).

    With ``keep_high_tail`` (width 1) the last slot's high spill plane is
    not folded but returned apart: the trailing entry of an (nx + 1)
    parity-class array.  Returns (owned blocks, tail or None)."""
    n = len(exts)
    owned, tail = [], None
    for k, ext in enumerate(exts):
        low, high = ext[:width], ext[-width:]
        mid = ext[width:-width].clone()
        ident = torch.full_like(low, fill)
        if k == 0:
            add_low = ident.clone()
            add_low[0] = _reduce_planes(low, combine)
        else:
            add_low = exts[k - 1][-width:].to(ext.device)
        mid[:width] = _comb(mid[:width], add_low, combine)
        if keep_high_tail:
            if width != 1:
                raise ValueError("keep_high_tail needs width 1")
            if k == n - 1:
                tail = high[0]
                add_high = ident
            else:
                add_high = exts[k + 1][:width].to(ext.device)
        elif k == n - 1:
            add_high = ident.clone()
            add_high[-1] = _reduce_planes(high, combine)
        else:
            add_high = exts[k + 1][:width].to(ext.device)
        mid[-width:] = _comb(mid[-width:], add_high, combine)
        owned.append(mid)
    return owned, tail


def _x_halo_exchange_clamped(locs: List[torch.Tensor], width: int) -> List[torch.Tensor]:
    """Each slot's block extended by `width` neighbour planes a side; at
    the domain's ends the boundary plane repeated (the gathers' clamp:
    a read of clip(i, 0, n - 1) sees the edge value)."""
    n = len(locs)
    out = []
    for k, loc in enumerate(locs):
        lo = locs[k - 1][-width:].to(loc.device) if k > 0 else loc[:1].expand((width,) + tuple(loc.shape[1:]))
        hi = locs[k + 1][:width].to(loc.device) if k < n - 1 else loc[-1:].expand((width,) + tuple(loc.shape[1:]))
        out.append(torch.cat([lo, loc, hi], dim=0))
    return out


def _local_ext_ids(gi, lo: int, slab_w: int, dims_yz):
    """Ids on a slot's extended grid: x rows [lo - 1, lo + W], y / z rows
    [-1, n] (`ops/scatter.py::home_ids_extended`, on the slab)."""
    ext = (slab_w + 2,) + tuple(int(n) + 2 for n in dims_yz)
    idx = torch.clamp(gi[:, 0].to(torch.int64) - lo + 1, 0, slab_w + 1)
    for k, n in enumerate(dims_yz):
        idx = idx * ext[k + 1] + torch.clamp(gi[:, k + 1].to(torch.int64) + 1, 0, int(n) + 1)
    return idx, ext


def _fold_extended(seg, axis_shifts, out_shape, combine="add", fill=0.0, noclip_axes=(0,)):
    """JAX's ``fold_scattered_sep(..., noclip_axes=...)``: each noclip axis
    folds onto its extended extent E + max - min with no clamp (target
    e + s - min_s), i.e. the fold with that axis' shifts moved to start
    at 0."""
    shifts = [tuple(s - min(a) for s in a) if i in noclip_axes else tuple(a) for i, a in enumerate(axis_shifts)]
    return fold_scattered_sep(seg, shifts, out_shape, combine, fill)


def _slot_sort(ids, *rows):
    order = _argsort(ids)
    return (ids[order], order) + tuple(r[order] for r in rows)


def _cat_sort(mesh, sorts, ext) -> SortInfo:
    """The slots' sorts as one `SortInfo` in the slot-major layout (each
    block's ``order`` indexes its own block), on slot 0's device."""
    dev0 = mesh.devices[0]
    return SortInfo(*(torch.cat([s[i].to(dev0) for s in sorts]) for i in range(2)), ext,
                    torch.cat([s[2].to(dev0) for s in sorts]))


def _gather(mesh, blocks):
    return torch.cat([b.to(mesh.devices[0]) for b in blocks], dim=0)


def sharded_p2g_all(particles: Particles, mesh: Mesh, spec: BucketSpec, gres, face_shapes, biases, bound_min,
                    cell_size, volume=None, mass_floor: float = 0.0):
    """Shard-local `transfers.p2g_all`: each slot scatters its particles
    into its own slab (one sort, one segmented sum of every axis' and
    the volume's channels, one fold an output), and the two x-spill
    planes of each output fold into the neighbours.  Returns (gm_list,
    gv_list[, vol_classes], sort_info), the grid fields whole on slot 0's
    device and sort_info in the slot-major layout, for `sharded_g2p_all`."""
    _check_mesh(mesh, spec)
    d = len(gres)
    W, cap = spec.slab_w, spec.cap
    ny_nz = tuple(int(n) for n in gres[1:])
    outs = None  # per output: the slots' extended fields
    vol_exts, sorts = {}, []
    for k, dev in enumerate(mesh.devices):
        px, pm, pv, pc = (_rows(mesh, t, k) for t in (particles.x, particles.m, particles.v, particles.c))
        gi0, _, _ = _corner_setup(px, bound_min, cell_size, (0.0,) * d)
        ids, ext = _local_ext_ids(gi0, k * W, W, ny_nz)
        sorted_ids, order, px_s, pm_s, pv_s, pc_s = _slot_sort(padding_dump_ids(ids, pm, ext), px, pm, pv, pc)
        sorts.append((sorted_ids, order, px_s))
        blocks, specs, vol_rs = _p2g_channels(px_s, pm_s, pv_s, pc_s, biases, bound_min, cell_size, volume)
        seg_cf = segment_reduce_cf(torch.cat(blocks, dim=-1), sorted_ids, math.prod(ext), ext)
        slot_outs = []
        for a in range(d):
            idxs = [j for j, (aa, _) in enumerate(specs) if aa == a]
            axis_shifts = [tuple(c - 1 for c in ((-1, 0, 1) if biases[a][dd] != 0.0 else (0, 1))) for dd in range(d)]
            x_lo, x_hi = min(axis_shifts[0]), max(axis_shifts[0])
            acc_x = (W + 2) + (x_hi - x_lo)
            for chsel in ([2 * j for j in idxs], [2 * j + 1 for j in idxs]):
                folded = _fold_extended(seg_cf[chsel], axis_shifts, (acc_x,) + ny_nz)
                # plane j is global row lo + j + x_lo; the targets lie in [lo - 1, hi]
                s0 = -1 - x_lo
                slot_outs.append(folded[s0:s0 + W + 2])
        outs = [[o] for o in slot_outs] if outs is None else [acc + [o] for acc, o in zip(outs, slot_outs)]
        if volume is not None:
            n_p2g = 2 * len(specs)
            for p in itertools.product((0, 1), repeat=d):
                sel = [n_p2g + i for i, r in enumerate(vol_rs) if all(ra % 2 == pa for ra, pa in zip(r, p))]
                axis_shifts = [(-1, 0) if pp == 0 else (-1,) for pp in p]
                yz_res = tuple(int(n) + 1 if pp == 0 else int(n) for n, pp in zip(gres[1:], p[1:]))
                acc_x = (W + 2) + (max(axis_shifts[0]) - min(axis_shifts[0]))
                folded = _fold_extended(seg_cf[sel], axis_shifts, (acc_x,) + yz_res)
                if p[0] == 0:
                    # entries [lo, hi] on W + 1 planes: entry hi is the right
                    # neighbour's entry lo, or the (nx + 1)-array's tail on
                    # the last slot
                    ext_arr = folded[1:W + 2]
                    vol_exts.setdefault(p, []).append(torch.cat([torch.zeros_like(ext_arr[:1]), ext_arr]))
                else:  # shifts (-1,) only: targets [lo, hi), no spill
                    vol_exts.setdefault(p, []).append(folded[1:1 + W])
    grids = [_gather(mesh, _x_halo_fold(o, 1, "add", 0.0)[0]) for o in outs]
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
    si = _cat_sort(mesh, sorts, (W + 2,) + tuple(int(n) + 2 for n in gres[1:]))
    if volume is None:
        return gms, gvs, si
    fine_vol = math.prod(volume[1])
    classes = {}
    for p, exts in vol_exts.items():
        if p[0] == 0:
            owned, tail = _x_halo_fold(exts, 1, "add", 0.0, keep_high_tail=True)
            cls = _gather(mesh, owned + [tail.to(owned[0].device)[None]])
        else:
            cls = _gather(mesh, exts)
        classes[p] = torch.clamp(cls, max=fine_vol)
    return gms, gvs, classes, si


def sharded_fluid_levelset(p_x, p_m, mesh: Mesh, spec: BucketSpec, gres, bound_min, cell_size, gdx: float):
    """Shard-local union-of-balls level set (`ops/levelset.py::
    compute_fluid_levelset`): each slot's 5^d scatter-min over its slab,
    then width-2 min-folds of the spill planes into the neighbours.
    Returns the (nx, ...) field on slot 0's device."""
    _check_mesh(mesh, spec)
    d = len(gres)
    W, cap = spec.slab_w, spec.cap
    ny_nz = tuple(int(n) for n in gres[1:])
    background = 3.0 * gdx
    r = gdx * 0.5 * math.sqrt(float(d)) * 1.02
    offsets = list(itertools.product(range(-2, 3), repeat=d))
    exts = []
    for k, dev in enumerate(mesh.devices):
        px, pm = _rows(mesh, p_x, k), _rows(mesh, p_m, k)
        hi_clip = const(tuple(int(n) - 1 for n in gres), torch.int32, dev)
        gi = torch.minimum(torch.clamp(torch.floor((px - _vec(bound_min, px)) / _vec(cell_size, px)).to(torch.int32),
                                       min=0), hi_clip)
        # the homes are resident: x in [lo, lo + W)
        ids = torch.clamp(gi[:, 0].to(torch.int64) - k * W, 0, W - 1)
        for j, n in enumerate(ny_nz):
            ids = ids * n + gi[:, j + 1]
        sorted_ids, _, px_s, gi_s, pm_s = _slot_sort(padding_dump_ids(ids, pm, (W,) + ny_nz), px, gi, pm)
        offs = const(tuple(offsets), torch.int32, dev)
        dist2 = None
        for ax in range(d):
            gii = torch.clamp(gi_s[:, ax][:, None] + offs[None, :, ax], 0, int(gres[ax]) - 1)
            cd = (gii.to(px.dtype) + 0.5) * cell_size[ax] + bound_min[ax] - px_s[:, ax][:, None]
            dist2 = cd * cd if dist2 is None else dist2 + cd * cd
        vals = torch.where(pm_s[:, None] > 0, rounded_sqrt(dist2) - r, background)
        seg = segment_reduce_cf(vals, sorted_ids, W * math.prod(ny_nz), (W,) + ny_nz, "min", background)
        exts.append(_fold_extended(seg, [tuple(range(-2, 3))] * d, (W + 4,) + ny_nz, "min", background))
    return _gather(mesh, _x_halo_fold(exts, 2, "min", background)[0])


def _padded_edge(a, pads):
    """`a` (3D) edge-padded by (lo, hi) an axis, axis 0 first."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(a[None, None], tuple(flat), mode="replicate")[0, 0]


def _unsort_slots(mesh, spec, res_blocks, sort_info):
    cap = spec.cap
    return torch.cat([unsort_rows(res, _rows(mesh, sort_info.order, k)).to(mesh.devices[0])
                      for k, res in enumerate(res_blocks)])


def sharded_g2p_all(gvs, mesh: Mesh, spec: BucketSpec, gres, biases, bound_min, cell_size, sort_info: SortInfo):
    """Shard-local `transfers.g2p_all`: each slot's face-velocity slab
    extended by the clamped width-1 halo, then the corner table, the
    segment broadcast over `sharded_p2g_all`'s per-slot sort and the
    weights.  Returns (pv, pc) in the bucketed row order."""
    _check_mesh(mesh, spec)
    d = len(gres)
    W, cap = spec.slab_w, spec.cap
    offs_lists = [_axis_offsets(biases[a], d) for a in range(d)]
    base_shape = tuple(int(n) for n in gres)
    sizes = (W + 2,) + tuple(int(n) + 2 for n in gres[1:])
    # the trailing face planes are never read (clamp to gres - 1)
    halos = [_x_halo_exchange_clamped(split_blocks(mesh, g[tuple(slice(0, n) for n in base_shape)]), 1) for g in gvs]
    res_blocks = []
    for k, dev in enumerate(mesh.devices):
        chans = []
        for a in range(d):
            # x: one more edge plane a side (the ext ids' margin rows);
            # y / z: the global clamp's two
            padded = _padded_edge(halos[a][k], [(1, 1)] + [(2, 2)] * (d - 1))
            for o in offs_lists[a]:
                start = (o[0] + 1,) + tuple(1 + oo for oo in o[1:])
                win = padded[tuple(slice(s, s + z) for s, z in zip(start, sizes))]
                chans.append(win.reshape(-1))
        vals = segment_broadcast_sorted(torch.stack(chans, dim=-1), _rows(mesh, sort_info.sorted_ids, k))
        px_s = _rows(mesh, sort_info.px_sorted, k)
        res_blocks.append(_g2p_reduce(vals, px_s, offs_lists, biases, bound_min, cell_size))
    res = _unsort_slots(mesh, spec, res_blocks, sort_info)
    pv = res[:, 0::(1 + d)]
    pc = torch.stack([res[:, a * (1 + d) + 1:(a + 1) * (1 + d)] for a in range(d)], dim=1)
    return pv, pc


def sharded_scatter_mass_volume(p_x, p_m, mesh: Mesh, spec: BucketSpec, gres, pvol, bound_min, cell_size):
    """Shard-local `density.scatter_mass_volume` (the cell-centred
    trilinear mass and volume scatter, DensityCGSolver3D.py:8-36) over a
    per-slot sort of the center-biased homes, kept for
    `sharded_apply_displacement`.  Returns (gm, gvol, sort_info)."""
    _check_mesh(mesh, spec)
    d = len(gres)
    W, cap = spec.slab_w, spec.cap
    ny_nz = tuple(int(n) for n in gres[1:])
    corners = list(itertools.product((0, 1), repeat=d))
    exts, sorts = ([], []), []
    for k, dev in enumerate(mesh.devices):
        px, pm = _rows(mesh, p_x, k), _rows(mesh, p_m, k)
        gi, _, _ = _corner_setup(px, bound_min, cell_size, (0.5,) * d)
        ids, ext = _local_ext_ids(gi, k * W, W, ny_nz)
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
            # corner shifts {-1, 0} (the ids are +1-extended); plane j is
            # global row lo + j - 1, the targets [lo - 1, hi]
            acc = _fold_extended(seg_cf[chsel], [(-1, 0)] * d, (W + 3,) + ny_nz)
            exts[i].append(acc[:W + 2])
    gm, gvol = (_gather(mesh, _x_halo_fold(e, 1, "add", 0.0)[0]) for e in exts)
    return gm, gvol, _cat_sort(mesh, sorts, (W + 2,) + tuple(int(n) + 2 for n in gres[1:]))


def sharded_apply_displacement(disp_faces, mesh: Mesh, spec: BucketSpec, gres, bound_min, cell_size,
                               sort_info: SortInfo):
    """Shard-local `density.apply_displacement_all`: each slot's
    displacement face slabs extended by the clamped halo (width 2: the
    own-axis offsets from the center home are {0, 1, 2}), the corner
    table, the segment broadcast over `sharded_scatter_mass_volume`'s
    per-slot sort and the weights.  The x-face array's trailing plane nx
    (a gather target: the displacement clamps to the face dims,
    DensityCGSolver3D.py:232) is the last slot's high halo.  Returns the
    (K, d) displacement in the bucketed row order."""
    _check_mesh(mesh, spec)
    d = len(gres)
    W, cap = spec.slab_w, spec.cap
    nx = int(gres[0])
    offs_lists = [list(itertools.product(*[(0, 1, 2) if k == a else (0, 1) for k in range(d)])) for a in range(d)]
    halos = [_x_halo_exchange_clamped(split_blocks(mesh, f[:nx]), 2) for f in disp_faces]
    tail_x = disp_faces[0][nx]
    sizes = (W + 2,) + tuple(int(n) + 2 for n in gres[1:])
    res_blocks = []
    for k, dev in enumerate(mesh.devices):
        chans = []
        for a in range(d):
            gh = halos[a][k]  # plane j is global x-row lo - 2 + j
            if a == 0 and k == mesh.size - 1:
                gh = gh.clone()
                gh[-2] = tail_x.to(dev)
                gh[-1] = tail_x.to(dev)
            padded = _padded_edge(gh, [(1, 1)] + [(1, 2) if j == a else (2, 2) for j in range(1, d)])
            for o in offs_lists[a]:
                start = [o[0] + 2] + [o[j] if j == a else 1 + o[j] for j in range(1, d)]
                win = padded[tuple(slice(s, s + z) for s, z in zip(start, sizes))]
                chans.append(win.reshape(-1))
        vals = segment_broadcast_sorted(torch.stack(chans, dim=-1), _rows(mesh, sort_info.sorted_ids, k))
        px_s = _rows(mesh, sort_info.px_sorted, k)
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
        res_blocks.append(torch.stack(outs, dim=-1))
    return _unsort_slots(mesh, spec, res_blocks, sort_info)
