"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/transfers.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

APIC particle <-> grid transfers (P2G / G2P), 3D.

Counterpart of ``python_fluid_simulation_tpu.ops.transfers`` (the
reference's notebook cells 2-3, :94-223): trilinear scatter of particle
momentum with the APIC affine term, and the gather that rebuilds particle
velocity + affine-gradient rows.

One stable cell sort per particle epoch serves every transfer over the
same positions (`make_sort_info`): all three axes' staggered home cells
are rebased onto the bias-0 home b0 = floor(t) — exact, since
floor(t - 0.5) is b0 - 1 or b0 — with the corner offsets widened to
{-1, 0, 1} on biased axes (weights vanish on the inapplicable offset).

Reference quirks preserved:
  * corner indices are clamped to ``gres - 1`` per axis — the base
    resolution — so the trailing face plane never receives mass
    (cell 2 :128);
  * weights use the |gx - x| formula with the lower-corner bias
    (cell 2 :117-123).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.ops.indexing import const
from portbench.reference.ops.scatter import (
    fold_scattered_sep,
    home_ids_extended,
    segment_broadcast_sorted,
    segment_reduce_cf,
    sort_by_segment,
    unsort_rows,
)


class SortInfo(NamedTuple):
    """A cell sort of the particle set, reusable across transfers."""

    sorted_ids: torch.Tensor  # (K,) non-decreasing extended-grid cell ids
    order: torch.Tensor  # (K,) permutation: sorted[i] = orig[order[i]]
    ext: Tuple[int, ...]  # extended grid shape the ids index
    px_sorted: torch.Tensor  # (K, d) positions in sorted order


def _vec(vals, like):
    return const(tuple(vals), like.dtype, like.device)


def _corner_setup(px, bound_min, cell_size, bias):
    """gi (lower corner index), disp = gx - x, w = |disp| / h."""
    bmin = _vec(bound_min, px)
    h = _vec(cell_size, px)
    b = _vec(bias, px)
    gi = torch.floor((px - bmin) / h - b).to(torch.int32)
    gx = (gi.to(px.dtype) + b) * h + bmin
    disp = gx - px
    w = torch.abs(disp) / h
    return gi, disp, w


def _corner_weight(w, offs):
    """The trilinear weight of corner `offs`: prod_d (w_d if offs_d else 1 - w_d)."""
    out = None
    for d, o in enumerate(offs):
        wd = (1.0 - w[:, d]) if o == 0 else w[:, d]
        out = wd if out is None else out * wd
    return out


def _flat_index(gi_corner, shape):
    idx = gi_corner[:, 0].to(torch.int64)
    for d in range(1, len(shape)):
        idx = idx * shape[d] + gi_corner[:, d]
    return idx


def padding_dump_ids(ids, pm, grid_shape):
    """Redirect zero-mass padding rows to distinct out-of-range ids
    (reduces drop them; the sort puts them last)."""
    if pm is None:
        return ids
    size = 1
    for s in grid_shape:
        size *= int(s)
    k = ids.shape[0]
    dump = size + k + torch.arange(k, dtype=ids.dtype, device=ids.device)
    return torch.where(pm > 0, ids, dump)


def make_sort_info(px, pm, gres, bound_min, cell_size) -> SortInfo:
    """One stable bias-0 home-cell sort over `px`, shared by P2G, G2P,
    the density scatter and displacement, and the fluid level set."""
    d = px.shape[-1]
    gi0, _, _ = _corner_setup(px, bound_min, cell_size, (0.0,) * d)
    ids, ext = home_ids_extended(gi0, gres)
    ids = padding_dump_ids(ids, pm, ext)
    sorted_ids, order = torch.sort(ids, stable=True)
    return SortInfo(sorted_ids=sorted_ids, order=order, ext=ext, px_sorted=px[order])


def p2g_axis(px, pm, pv, pc_a, axis: int, gres, face_shape, bias, bound_min, cell_size):
    """Scatter the mass and momentum of one velocity component to its face
    grid (reference p2g_particle + p2g_grid, cell 2 :96-177; JAX
    ``p2g_axis``).  ``pc_a`` is the component's (K, d) affine row.

    One home-cell sort, one segmented sum of the 2^d corners x (mass,
    momentum) channels in live form (`segment_reduce_cf`: on the card the
    segmented scan and the live placement), and per-corner folds onto the
    base grid with the border clamp to gres - 1 (`fold_scattered_sep`: on
    the card the fold kernel); the trailing face plane never receives
    mass.  JAX's ``widen=True`` (a TPU layout workaround for narrow
    channel counts) has no counterpart here.  Returns (gm, gv) of
    ``face_shape``, gv divided by the mass (0 where there is none)."""
    d = px.shape[-1]
    gi, disp, w = _corner_setup(px, bound_min, cell_size, bias)
    chans = []
    for offs in itertools.product((0, 1), repeat=d):
        weight = _corner_weight(w, offs)
        # APIC affine term: cv = sum_d (disp_d + offs_d h_d) c_a[:, d]
        off_h = const(tuple(float(o * h) for o, h in zip(offs, cell_size)), px.dtype, px.device)
        cv = torch.sum((disp + off_h) * pc_a, dim=-1)
        chans.append(weight * pm)
        chans.append(weight * pm * (pv[:, axis] + cv))
    vals = torch.stack(chans, dim=-1)
    ids, ext = home_ids_extended(gi, gres)
    sorted_ids, sorted_vals = sort_by_segment(ids, vals)
    size = 1
    for s in ext:
        size *= s
    seg_cf = segment_reduce_cf(sorted_vals, sorted_ids, size, ext)
    base_shape = tuple(int(n) for n in gres)
    gm = _pad_to(fold_scattered_sep(seg_cf[0::2], [(-1, 0)] * d, base_shape, "add", 0.0), face_shape)
    gv_m = _pad_to(fold_scattered_sep(seg_cf[1::2], [(-1, 0)] * d, base_shape, "add", 0.0), face_shape)
    gv = torch.where(gm > 0, gv_m / torch.where(gm > 0, gm, 1.0), 0.0)
    return gm, gv


def g2p_axis(px, gv, axis: int, gres, bias, bound_min, cell_size):
    """Gather one velocity component and its APIC affine-gradient row
    (reference g2p_particle, cell 3 :174-209; JAX ``g2p_axis``): plain
    gathers, each corner index clamped to gres - 1.  Returns (pv_a (K,),
    pc_a (K, d))."""
    d = px.shape[-1]
    gi, _, w = _corner_setup(px, bound_min, cell_size, bias)
    clamp_hi = const(tuple(int(n) - 1 for n in gres), torch.int32, px.device)
    flat = gv.reshape(-1)
    pv_a = torch.zeros(px.shape[0], dtype=px.dtype, device=px.device)
    cols = [torch.zeros(px.shape[0], dtype=px.dtype, device=px.device) for _ in range(d)]
    for offs in itertools.product((0, 1), repeat=d):
        oi = const(tuple(offs), torch.int32, px.device)
        corner = torch.minimum(torch.clamp(gi + oi, min=0), clamp_hi)
        v = flat[_flat_index(corner, gv.shape)]
        # per-axis weights and their signed derivatives (cell 3 :196-205)
        wd = [(w[:, k] if o == 1 else 1.0 - w[:, k]) for k, o in enumerate(offs)]
        weight = wd[0]
        for k in range(1, d):
            weight = weight * wd[k]
        pv_a = pv_a + weight * v
        for k in range(d):
            grad_k = torch.full((), float(2 * offs[k] - 1), dtype=px.dtype, device=px.device)
            for j in range(d):
                if j != k:
                    grad_k = grad_k * wd[j]
            cols[k] = cols[k] + grad_k * v / cell_size[k]
    return pv_a, torch.stack(cols, dim=-1)


def _weight_cols(offs_list, delta, w, dd):
    """(K, C) per-dim corner weight for channel offsets `offs_list`
    relative to a home rebased by `delta` (the trilinear factor where
    o in {0, 1}, else 0), plus the integer offset o itself."""
    off_col = const(tuple(o[dd] for o in offs_list), torch.int32, w.device)[None, :]
    o = off_col - delta[:, dd][:, None]
    w_col = w[:, dd][:, None]
    wd = torch.where(o == 0, 1.0 - w_col, torch.where(o == 1, w_col, torch.zeros((), dtype=w.dtype, device=w.device)))
    return wd, o


def _axis_offsets(bias, d):
    return list(itertools.product(*[(-1, 0, 1) if bias[k] != 0.0 else (0, 1) for k in range(d)]))


def _p2g_channels(px, pm, pv, pc, biases, bound_min, cell_size, volume):
    """Per-particle channel blocks: all axes' (mass, momentum) corner
    channels on the bias-0 home, plus the optional dual-lattice volume
    channels.  Returns (blocks, specs, vol_rs)."""
    d = px.shape[-1]
    h = _vec(cell_size, px)
    gi0, _, w0 = _corner_setup(px, bound_min, cell_size, (0.0,) * d)
    blocks, specs = [], []
    for a in range(d):
        gi_a, disp_a, w_a = _corner_setup(px, bound_min, cell_size, biases[a])
        delta = gi_a - gi0  # in {-1, 0} per axis, exact
        coffs_list = _axis_offsets(biases[a], d)
        specs += [(a, c) for c in coffs_list]
        weight = None
        cv = None  # APIC affine term sum_dd (disp_dd + o_dd h_dd) c[a, dd]
        for dd in range(d):
            wd, o = _weight_cols(coffs_list, delta, w_a, dd)
            weight = wd if weight is None else weight * wd
            term = (disp_a[:, dd][:, None] + o.to(px.dtype) * h[dd]) * pc[:, a, dd][:, None]
            cv = term if cv is None else cv + term
        m_blk = weight * pm[:, None]
        v_blk = m_blk * (pv[:, a][:, None] + cv)
        # interleave [m0, v0, m1, v1, ...] to match `specs` pairing
        blocks.append(torch.stack([m_blk, v_blk], dim=-1).reshape(px.shape[0], 2 * len(coffs_list)))
    vol_rs = []
    if volume is not None:
        pvol, _ = volume
        two_w = 2.0 * w0
        s_fine = torch.floor(two_w).to(torch.int32)  # in {0, 1}
        frac_f = two_w - s_fine
        pv_vol = pvol * (pm > 0)  # zero-mass particles are padding
        vol_rs = list(itertools.product((0, 1, 2), repeat=d))
        ua_prod = None
        for dd in range(d):
            r_col = const(tuple(r[dd] for r in vol_rs), torch.int32, px.device)[None, :]
            s_col = s_fine[:, dd][:, None]
            f_col = frac_f[:, dd][:, None]
            ua = torch.where(
                s_col == r_col, 1.0 - f_col,
                torch.where(s_col + 1 == r_col, f_col, torch.zeros((), dtype=px.dtype, device=px.device)),
            )
            ua_prod = ua if ua_prod is None else ua_prod * ua
        blocks.append(ua_prod * pv_vol[:, None])
    return blocks, specs, vol_rs


def _pad_to(a, shape):
    """Zero-pad the trailing end of each axis of `a` up to `shape`."""
    pads = []
    for n, s in zip(reversed(a.shape), reversed(tuple(shape))):
        pads += [0, int(s) - int(n)]
    return F.pad(a, pads)


def p2g_all(
    px, pm, pv, pc, gres, face_shapes, biases, bound_min, cell_size,
    volume=None, with_sort_info: bool = False, sort_info: SortInfo | None = None,
    mass_floor: float = 0.0,
):
    """All axes' P2G over one cell sort + one segmented sum.

    ``mass_floor`` floors the momentum/mass division denominator: a face
    carrying less than that is numerically empty (the engine passes 1e-7
    of one particle mass; the default 0 keeps the reference's exact
    ``m > 0`` semantics).  ``pc`` is the full (K, d, d) affine matrix.
    Returns (gm_list, gv_list[, vol_classes][, sort_info]).

    ``volume=(pvol, fine_cell_size)`` also emits the dual-lattice
    fluid-volume field as parity-class grids (see
    `ops.levelset.compute_fluid_volume_classes`) from the same sort.
    """
    d = px.shape[-1]
    if sort_info is None:
        sort_info = make_sort_info(px, pm, gres, bound_min, cell_size)
    sorted_ids, order, ext, px_s = sort_info
    n_p = px.shape[0]
    payload = torch.cat([pm[:, None], pv, pc.reshape(n_p, -1)], dim=-1)[order]
    pm_s = payload[:, 0]
    pv_s = payload[:, 1 : 1 + d]
    pc_s = payload[:, 1 + d :].reshape(n_p, d, d)
    blocks, specs, vol_rs = _p2g_channels(px_s, pm_s, pv_s, pc_s, biases, bound_min, cell_size, volume)
    sorted_vals = torch.cat(blocks, dim=-1)
    size = 1
    for s in ext:
        size *= s
    seg_cf = segment_reduce_cf(sorted_vals, sorted_ids, size, ext)

    base_shape = tuple(gres)
    gms, gvs = [], []
    for a in range(d):
        idxs = [j for j, (aa, _) in enumerate(specs) if aa == a]  # contiguous
        axis_shifts = [
            tuple(c - 1 for c in ((-1, 0, 1) if biases[a][dd] != 0.0 else (0, 1)))
            for dd in range(d)
        ]
        m_ch = seg_cf[2 * idxs[0] : 2 * idxs[-1] + 1 : 2]
        v_ch = seg_cf[2 * idxs[0] + 1 : 2 * idxs[-1] + 2 : 2]
        gm = _pad_to(fold_scattered_sep(m_ch, axis_shifts, base_shape, "add", 0.0), face_shapes[a])
        gv_m = _pad_to(fold_scattered_sep(v_ch, axis_shifts, base_shape, "add", 0.0), face_shapes[a])
        if mass_floor:
            den = torch.clamp(gm, min=mass_floor)
        else:
            den = torch.where(gm > 0, gm, 1.0)
        gvs.append(torch.where(gm > 0, gv_m / den, 0.0))
        gms.append(gm)
    out = [gms, gvs]
    if volume is not None:
        n_p2g = 2 * len(specs)
        fine_vol = 1.0
        for c in volume[1]:
            fine_vol *= c
        vol_cf = seg_cf[n_p2g : n_p2g + len(vol_rs)]
        out.append(_volume_classes(vol_cf, vol_rs, gres, fine_vol))
    if with_sort_info:
        out.append(sort_info)
    return tuple(out)


def _volume_classes(vol_cf, vol_rs, gres, fine_vol):
    """Fold the 3^d per-cell volume channels into the 2^d parity-class
    grids of the dual lattice, clamped at the fine cell volume."""
    d = len(gres)
    classes = {}
    for p in itertools.product((0, 1), repeat=d):
        class_res = tuple(int(n) + 1 if pp == 0 else int(n) for n, pp in zip(gres, p))
        sel = [i for i, r in enumerate(vol_rs) if all(ra % 2 == pa for ra, pa in zip(r, p))]
        axis_shifts = [(-1, 0) if pp == 0 else (-1,) for pp in p]
        vol = fold_scattered_sep(vol_cf[sel], axis_shifts, class_res, "add", 0.0)
        classes[p] = torch.clamp(vol, max=fine_vol)
    return classes


def corner_table(arrs, offs_lists, ext, crop=None):
    """Dense per-cell table of corner values: channel (a, o) holds
    arrs[a][clip(c + o, 0, n-1)] at extended home cell c (edge-padded
    shifts; `crop` first cuts each array to the given shape)."""
    chans = []
    for a, arr in enumerate(arrs):
        base = arr if crop is None else arr[tuple(slice(0, int(n)) for n in crop)]
        padded = F.pad(base[None, None], (2, 2, 2, 2, 2, 2), mode="replicate")[0, 0]
        for o in offs_lists[a]:
            # padded[j] = base[clip(j-2)]; channel[e] = base[clip(e-1+o)]
            win = padded[tuple(slice(1 + oo, 1 + oo + int(e)) for oo, e in zip(o, ext))]
            chans.append(win.reshape(-1))
    return torch.stack(chans, dim=-1)


def _g2p_reduce(vals, px_s, offs_lists, biases, bound_min, cell_size):
    """Weights & affine-gradient factors applied to broadcast corner
    values, in sorted space.  Returns (K, d*(1+d)): per axis
    [pv_a, pc_a0..d]."""
    d = px_s.shape[-1]
    h = _vec(cell_size, px_s)
    gi0, _, _ = _corner_setup(px_s, bound_min, cell_size, (0.0,) * d)
    outs = []
    col = 0
    for a in range(d):
        gi_a, _, w_a = _corner_setup(px_s, bound_min, cell_size, biases[a])
        delta = gi_a - gi0
        C = len(offs_lists[a])
        v_a = vals[:, col : col + C]
        col += C
        wd, sg = [], []
        for dd in range(d):
            w_dd, o = _weight_cols(offs_lists[a], delta, w_a, dd)
            wd.append(w_dd)
            sg.append(torch.where(o == 1, 1.0, torch.where(o == 0, -1.0, 0.0)).to(px_s.dtype))
        weight = wd[0]
        for dd in range(1, d):
            weight = weight * wd[dd]
        outs.append(torch.sum(weight * v_a, dim=-1))
        # affine-gradient row: dim k swaps wd_k for the signed unit
        # derivative (cell 3 :196-205)
        for k in range(d):
            g = sg[k]
            for j in range(d):
                if j != k:
                    g = g * wd[j]
            outs.append(torch.sum(g * v_a, dim=-1) / h[k])
    return torch.stack(outs, dim=-1)


def g2p_all(gvs, gres, biases, bound_min, cell_size, sort_info: SortInfo):
    """All-axes G2P (reference g2p_particle, cell 3 :174-209) by segment
    broadcast of a dense per-cell corner table over P2G's cell sort
    (positions do not change between P2G and G2P).  The clamp to gres-1
    applies to each corner index, so the trailing face plane is never
    read (cell 3 :190-193).  Returns (pv (K, d), pc (K, d, d))."""
    d = len(gres)
    offs_lists = [_axis_offsets(biases[a], d) for a in range(d)]
    table = corner_table(gvs, offs_lists, sort_info.ext, crop=gres)
    vals = segment_broadcast_sorted(table, sort_info.sorted_ids)
    res = unsort_rows(
        _g2p_reduce(vals, sort_info.px_sorted, offs_lists, biases, bound_min, cell_size),
        sort_info.order,
    )
    pv = res[:, 0 :: (1 + d)]
    pc = torch.stack([res[:, a * (1 + d) + 1 : (a + 1) * (1 + d)] for a in range(d)], dim=1)
    return pv, pc
