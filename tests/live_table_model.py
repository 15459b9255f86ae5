"""A model of the index logic of the scatter's two live-form kernels, over
torch tensors on any device:

* ``csrc/binned_segment.cu``'s live placement: tiles of kLiveTile
  segments, each tile's first row (pass 1), its segment-last rows counted
  (pass 2), its first column the counts of the tiles before it, its rows
  numbered in row order (pass 3), the slot map -1 elsewhere;
* ``csrc/fold.cu``'s tiled fold of a live table: kTX x kTY x kTZ target
  tiles, each tile's source box (the per-axis source windows
  [src_lo, src_hi] of its first and last targets), the box's shared-memory
  size, and the targets whose window holds a nonempty source; the others
  write ``fill`` where the wrapper allows the shortcut, the rest take the
  dense fold's value.

The tile sizes are read from the sources.  tests/test_torch_live_table.py
holds the model against the plain versions and the JAX package on the CPU;
``chip_smoke.py`` holds the kernels on the card against it, bitwise, on
every reduce and fold of its steps.  The model imports no JAX.
"""

import re

import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build
from python_fluid_simulation_tpu_torch.ops.cuda_binned import LiveTable
from python_fluid_simulation_tpu_torch.ops.cuda_fold import fold_plain, fold_shortcut
from python_fluid_simulation_tpu_torch.ops.cuda_scan import combine


def _const(source, name):
    text = (_cuda_build.SRC_DIR / source).read_text()
    return int(re.search(rf"\b{name} = (\d+)[;,]", text).group(1))


LIVE_TILE = _const("binned_segment.cu", "kLiveTile")
TILE = tuple(_const("fold.cu", n) for n in ("kTX", "kTY", "kTZ"))
SMEM_CAP = 48 * 1024  # the fold's launcher refuses a larger box


def place_live_model(scanned, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    """The live placement, tile by tile."""
    k, c = scanned.shape
    m = int(num_segments)
    dev = scanned.device
    ntiles = -(-m // LIVE_TILE)
    bounds = torch.clamp(torch.arange(ntiles + 1, device=dev) * LIVE_TILE, max=m)
    rstart = torch.searchsorted(sorted_ids, bounds)  # pass 1: tile t's rows are [rstart[t], rstart[t + 1])
    last = torch.ones(k, dtype=torch.bool, device=dev)
    last[:-1] = sorted_ids[1:] != sorted_ids[:-1]
    before = torch.zeros(k + 1, dtype=torch.int64, device=dev)  # before[i]: segment-last rows among rows < i
    before[1:] = torch.cumsum(last, 0)
    counts = before[rstart[1:]] - before[rstart[:-1]]  # pass 2
    first = torch.cumsum(counts, 0) - counts  # each tile's first column
    rows = torch.arange(k, device=dev)
    sel = last & (rows >= rstart[0]) & (rows < rstart[-1])  # the tiles' segment-last rows
    r = rows[sel]
    tile = torch.searchsorted(rstart, r, right=True) - 1
    col = first[tile] + before[r] - before[rstart[tile]]  # pass 3: in row order from the tile's first column
    live = torch.empty((c, min(k, m)), dtype=scanned.dtype, device=dev)
    picked = scanned[sel]
    live[:, col] = combine(torch.full_like(picked, float(fill)), picked, op).t()
    slot = torch.full((m,), -1, dtype=torch.int32, device=dev)
    slot[sorted_ids[sel]] = col.to(torch.int32)
    return LiveTable(live, slot, (m,), float(fill), tuple(range(c)))


def _windows(n, e, shifts):
    """Per target t of an axis: the plane group's source window
    [src_lo, src_hi] (fold.cu's group_lo / group_hi / src_lo / src_hi)."""
    smin, smax = min(shifts), max(shifts)
    nint = e + smax - smin
    t = torch.arange(n)
    glo = torch.clamp(torch.where(t == 0, 0, t - smin), min=0)
    ghi = torch.clamp(torch.where(t == n - 1, nint - 1, t - smin), max=nint - 1)
    return torch.clamp(glo + smin - smax, min=0), torch.clamp(ghi, max=e - 1)


def fold_boxes(grid_shape, axis_shifts, out_shape):
    """The source windows of every target along each axis and the largest
    tile box per axis, checking that each target's window lies in its
    tile's box; returns (windows, box, shared-memory bytes)."""
    windows, box = [], []
    for n, e, shifts, tl in zip(out_shape, grid_shape, axis_shifts, TILE):
        lo, hi = _windows(int(n), int(e), shifts)
        t0 = torch.arange(int(n)) // tl * tl
        t1 = torch.clamp(t0 + tl, max=int(n)) - 1
        blo, bhi = lo[t0], hi[t1]
        inside = (lo > hi) | ((lo >= blo) & (hi <= bhi))
        if not bool(inside.all()):
            raise AssertionError(f"a target's source window leaves its tile's box: {shifts}, N {n}, E {e}")
        windows.append((lo, hi))
        box.append(int(torch.clamp(bhi - blo + 1, min=0).max()))
    smem = box[0] * box[1] * box[2] * 4 + box[0] * box[1] * TILE[2] + box[0] * TILE[1] * TILE[2]
    if smem > SMEM_CAP:
        raise AssertionError(f"fold box {box}: {smem} bytes of shared memory")
    return windows, box, smem


def fold_live_targets(table: LiveTable, axis_shifts, out_shape):
    """Whether each target's source window holds a nonempty cell (an
    integral image of the map over the windows)."""
    dev = table.slot.device
    occ = (table.slot >= 0).reshape(table.grid_shape).to(torch.int64)
    (lx, hx), (ly, hy), (lz, hz) = [(lo.to(dev), hi.to(dev)) for lo, hi in
                                    fold_boxes(table.grid_shape, axis_shifts, out_shape)[0]]
    p = torch.zeros(tuple(int(e) + 1 for e in table.grid_shape), dtype=torch.int64, device=dev)
    p[1:, 1:, 1:] = occ.cumsum(0).cumsum(1).cumsum(2)
    # half-open [lo, hi + 1), empty where hi < lo
    e0, e1, e2 = (int(e) for e in table.grid_shape)
    lx, ly, lz = torch.clamp(lx, max=e0), torch.clamp(ly, max=e1), torch.clamp(lz, max=e2)
    ex, ey, ez = torch.maximum(hx + 1, lx), torch.maximum(hy + 1, ly), torch.maximum(hz + 1, lz)
    x0, x1 = lx[:, None, None], ex[:, None, None]
    y0, y1 = ly[None, :, None], ey[None, :, None]
    z0, z1 = lz[None, None, :], ez[None, None, :]
    count = (p[x1, y1, z1] - p[x0, y1, z1] - p[x1, y0, z1] - p[x1, y1, z0]
             + p[x0, y0, z1] + p[x0, y1, z0] + p[x1, y0, z0] - p[x0, y0, z0])
    return count > 0


def fold_live_model(table: LiveTable, axis_shifts, out_shape, combine: str = "add", fill=0.0) -> torch.Tensor:
    """The tiled fold of a live table: `fill` at the targets with no
    nonempty source where the shortcut holds, the dense fold elsewhere."""
    dense = fold_plain(table.dense(), axis_shifts, out_shape, combine, fill)
    if not fold_shortcut(table.fill, fill, combine):
        return dense
    live = fold_live_targets(table, axis_shifts, out_shape)
    return torch.where(live, dense, torch.full((), float(fill), dtype=dense.dtype, device=dense.device))
