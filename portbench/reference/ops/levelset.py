"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/levelset.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Fluid level set (union of balls) and fluid-volume field.

Counterpart of ``python_fluid_simulation_tpu.ops.levelset`` (the
reference's notebook cells 4 and 6, :224-278, :442-500).  The reference
builds both with per-particle CUDA atomics (``atomic.min`` over a 5^d
stencil, cell 4 :288; trilinear ``atomic.add``, cell 6 :468); here both
are segmented reduces over cell-sorted rows, deterministic.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import torch

from portbench.reference.ops.indexing import const, rounded_sqrt
from portbench.reference.ops.scatter import (
    fold_scattered_sep,
    home_ids_extended,
    segment_reduce_cf,
    sort_by_segment,
)
from portbench.reference.ops.transfers import (
    _corner_setup,
    _corner_weight,
    _flat_index,
    _vec,
    _volume_classes,
    padding_dump_ids,
)


def compute_fluid_levelset(
    px: torch.Tensor,
    res: Sequence[int],
    bound_min: Sequence[float],
    cell_size: Sequence[float],
    gdx: float,
    pm: torch.Tensor | None = None,
    sort_info=None,
) -> torch.Tensor:
    """Union-of-balls SDF at cell centers.

    Reference (cell 4): background phi = 3*gdx; particle radius
    r = gdx * 0.5 * sqrt(d) * 1.02; scatter-min of |center - x_p| - r over
    the particle's 5^d-cell neighbourhood with border clamping
    (:270-288).  Zero-mass particles (padding) contribute nothing.
    ``sort_info`` rides an existing bias-0 home-cell sort
    (`transfers.make_sort_info`), re-sorted stably by the clipped
    home-cell key: the clip keeps the borrowed order only while every
    home cell lies inside the grid (a particle beyond the last x plane
    clips onto it after rows of a larger y), and the segment reduce needs
    non-decreasing ids (its kernel reads them as tile boundaries).  The
    JAX package keeps the borrowed order (``ops/levelset.py:70-75``), so
    there a cell whose rows the clip splits takes the min of one run.
    """
    d = px.shape[-1]
    r = gdx * 0.5 * math.sqrt(float(d)) * 1.02
    bmin = _vec(bound_min, px)
    h = _vec(cell_size, px)
    hi = const(tuple(int(n) - 1 for n in res), torch.int32, px.device)
    background = 3.0 * float(gdx)
    size = 1
    for s in res:
        size *= int(s)

    if sort_info is not None:
        px_s = sort_info.px_sorted
        gi_s = torch.minimum(torch.clamp(torch.floor((px_s - bmin) / h).to(torch.int32), min=0), hi)
        pm_s = None if pm is None else pm[sort_info.order]
        sorted_ids = _flat_index(gi_s, res)
        if pm_s is not None:
            k = sorted_ids.shape[0]
            sorted_ids = torch.where(
                pm_s > 0, sorted_ids,
                size + torch.arange(k, dtype=sorted_ids.dtype, device=px.device),
            )
        sorted_ids, perm = torch.sort(sorted_ids, stable=True)
        px_s, gi_s = px_s[perm], gi_s[perm]
        pm_s = None if pm_s is None else pm_s[perm]
    else:
        gi = torch.minimum(torch.clamp(torch.floor((px - bmin) / h).to(torch.int32), min=0), hi)
        idx = padding_dump_ids(_flat_index(gi, res), pm, res)
        if pm is None:
            sorted_ids, px_s, gi_s = sort_by_segment(idx, px, gi)
            pm_s = None
        else:
            sorted_ids, px_s, gi_s, pm_s = sort_by_segment(idx, px, gi, pm)

    # (K, 5^d) distance channels; the reference clamps the target cell
    # before measuring the distance (cell 4 :281-284)
    n = px.shape[0]
    offsets = const(tuple(itertools.product(range(-2, 3), repeat=d)), torch.int32, px.device)
    dist2 = None
    for ax in range(d):
        gii = torch.clamp(gi_s[:, ax][:, None] + offsets[None, :, ax], 0, int(res[ax]) - 1)
        cd = (gii.to(px.dtype) + 0.5) * cell_size[ax] + bound_min[ax] - px_s[:, ax][:, None]
        dist2 = cd * cd if dist2 is None else dist2 + cd * cd
    vals = rounded_sqrt(dist2) - r
    if pm_s is not None:
        vals = torch.where(pm_s[:, None] > 0, vals, background)
    seg_cf = segment_reduce_cf(vals, sorted_ids, size, tuple(res), "min", background)
    return fold_scattered_sep(seg_cf, [tuple(range(-2, 3))] * d, tuple(res), "min", background)


def compute_fluid_volume(
    px: torch.Tensor,
    pvol: float,
    dual_res: Sequence[int],
    bound_min: Sequence[float],
    fine_cell_size: Sequence[float],
    pm: torch.Tensor | None = None,
) -> torch.Tensor:
    """Particle volume scattered onto the (2N+1)^d dual lattice, clamped
    (JAX ``compute_fluid_volume``; reference cell 6: node-biased trilinear
    scatter, bias 0, with border clamping, then the per-node clamp to the
    fine cell volume, constrain_fluid_volume_kernel :528-533).

    One sort of the home nodes on the extended lattice (zero-mass padding
    rows sent past it by `padding_dump_ids`), one segmented sum of the
    2^d corner channels in live form and one fold onto the lattice: on
    the card the segmented scan, the live placement and the fold kernel.
    `compute_fluid_volume_classes` is its parity split (``split_parity``),
    computed from the coarse home cells instead."""
    d = px.shape[-1]
    gi, _, w = _corner_setup(px, bound_min, fine_cell_size, (0.0,) * d)
    # zero-mass particles are padding (see compute_fluid_levelset)
    pv = pvol if pm is None else pvol * (pm > 0)
    vals = torch.stack([_corner_weight(w, offs) * pv for offs in itertools.product((0, 1), repeat=d)], dim=-1)
    ids, ext = home_ids_extended(gi, dual_res)
    ids = padding_dump_ids(ids, pm, ext)
    sorted_ids, sorted_vals = sort_by_segment(ids, vals)
    size = 1
    for e in ext:
        size *= e
    seg_cf = segment_reduce_cf(sorted_vals, sorted_ids, size, ext)
    vol = fold_scattered_sep(seg_cf, [(-1, 0)] * d, tuple(int(n) for n in dual_res), "add", 0.0)
    fine_vol = 1.0
    for c in fine_cell_size:
        fine_vol *= c
    return torch.clamp(vol, max=fine_vol)


def compute_fluid_volume_classes(
    px: torch.Tensor,
    pvol: float,
    gres: Sequence[int],
    bound_min: Sequence[float],
    fine_cell_size: Sequence[float],
    pm: torch.Tensor | None = None,
) -> dict:
    """Particle volume scattered onto the (2N+1)^d dual lattice (node-
    biased trilinear, border-clamped, clamped per node at the fine cell
    volume — reference cell 6, constrain_fluid_volume_kernel :528-533),
    emitted directly as the lattice's 2^d parity-class grids.

    The fine home node g = floor((px-bmin)/fine_h) decomposes as
    g = 2b + s with b the coarse home cell and s in {0,1}; the corner
    targets g + {0,1} become per-cell channels r = s + {0,1} in
    {0,1,2}^d, and channel r lands in parity class (r mod 2) at class
    index b + (r - r mod 2)/2.
    """
    d = px.shape[-1]
    gi, _, w = _corner_setup(px, bound_min, fine_cell_size, (0.0,) * d)
    b = torch.div(gi, 2, rounding_mode="floor")
    s = gi - 2 * b
    pv = pvol if pm is None else pvol * (pm > 0)
    rs = list(itertools.product((0, 1, 2), repeat=d))
    zero = torch.zeros((), dtype=px.dtype, device=px.device)
    chans = []
    for r in rs:
        weight = None
        for a, ra in enumerate(r):
            ua = torch.where(s[:, a] == ra, 1.0 - w[:, a], torch.where(s[:, a] + 1 == ra, w[:, a], zero))
            weight = ua if weight is None else weight * ua
        chans.append(weight * pv)
    vals = torch.stack(chans, dim=-1)
    ids, ext = home_ids_extended(b, gres)
    ids = padding_dump_ids(ids, pm, ext)
    sorted_ids, sorted_vals = sort_by_segment(ids, vals)
    size = 1
    for e in ext:
        size *= e
    seg_cf = segment_reduce_cf(sorted_vals, sorted_ids, size, ext)
    fine_vol = 1.0
    for c in fine_cell_size:
        fine_vol *= c
    return _volume_classes(seg_cf, rs, gres, fine_vol)
