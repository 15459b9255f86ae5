"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/scatter.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Deterministic particle <-> grid scatter machinery over cell-sorted rows.

Counterpart of ``python_fluid_simulation_tpu.ops.scatter``: one stable
sort of the per-particle home-cell ids, then

  * segmented add / min over the sorted rows and the segment broadcast
    ``out[i] = table[sorted_ids[i]]`` — the kernels of
    ``ops/cuda_binned.py`` (a reduce adds each segment's rows in row
    order, on either of its routes, so the sums are bitwise repeatable,
    no atomics), whose plain versions run on the CPU; the transfers'
    per-cell tables come in live form (`segment_reduce_cf`: only the
    nonempty cells' columns and a map over the cells),
  * per-corner-offset folds of the per-cell tables onto the grid that
    reproduce the reference's per-corner border clamping
    (``max(0, min(gres-1, gi + offs))``, cell 2 :128) — the fold kernel
    of ``ops/cuda_fold.py``, whose plain version runs on the CPU.

Ids outside [0, M) — negative ones included — are dropped by the reduce
and read 0 in the broadcast.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from portbench.reference.ops.cuda_binned import LiveTable, scan_reduce, segment_broadcast
from portbench.reference.ops.cuda_fold import fold


def sort_by_segment(ids: torch.Tensor, *vals: torch.Tensor):
    """Stable sort of (ids, vals...) by ids; vals may be (K,) or (K, C)."""
    sorted_ids, order = torch.sort(ids, stable=True)
    return (sorted_ids,) + tuple(v[order] for v in vals)


def _rows(vals: torch.Tensor) -> torch.Tensor:
    """(K,) or (K, C...) -> contiguous (K, C)."""
    return vals.reshape(vals.shape[0], -1).contiguous()


def segment_broadcast_sorted(table: torch.Tensor, sorted_ids: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[sorted_ids[i]]``; rows whose id lies outside
    [0, M) read 0."""
    out = segment_broadcast(_rows(table), sorted_ids.contiguous())
    return out.reshape(tuple(sorted_ids.shape) + tuple(table.shape[1:]))


def segment_reduce_cf(vals, sorted_ids, num_segments: int, grid_shape: Sequence[int], op: str = "add",
                      fill=0.0) -> LiveTable:
    """Segmented reduce of (K, C) rows emitted channels-first over
    `grid_shape`, in live form: a `LiveTable` of shape (C, *grid_shape)
    (its `dense()` is the (C, *grid_shape) table) for
    `fold_scattered_sep`; channel slices and lists share its columns.
    The scan route (`scan_reduce`), the only one that writes the live
    form: on the card at most `cuda_binned.SCAN_CHANNELS` (256) channels."""
    table = scan_reduce(vals.contiguous(), sorted_ids.contiguous(), num_segments, op, float(fill))
    return dataclasses.replace(table, grid_shape=tuple(int(n) for n in grid_shape))


def channels_first(seg_mc: torch.Tensor, grid_shape: Sequence[int]) -> torch.Tensor:
    """(M, C) segment table -> (C, *grid_shape) channel-major grids (a
    copy; the transfers take the live form of `segment_reduce_cf`)."""
    return seg_mc.movedim(-1, 0).reshape((seg_mc.shape[-1],) + tuple(int(n) for n in grid_shape))


def unsort_rows(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Invert a sort permutation: out[order[i]] = values[i]."""
    out = torch.empty_like(values)
    out[order] = values
    return out


def home_ids_extended(gi: torch.Tensor, gres: Sequence[int]) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Linear ids of (possibly out-of-range) home cells on the extended
    (n+2)^d grid covering gi in [-1, n] per axis."""
    d = gi.shape[-1]
    ext = tuple(int(n) + 2 for n in gres)
    g = gi.to(torch.int64) + 1
    idx = torch.clamp(g[:, 0], 0, ext[0] - 1)
    for k in range(1, d):
        idx = idx * ext[k] + torch.clamp(g[:, k], 0, ext[k] - 1)
    return idx, ext


def fold_scattered_sep(seg, axis_shifts, out_shape: Sequence[int], combine: str = "add", fill=0.0) -> torch.Tensor:
    """Combine per-corner segment grids onto clipped targets: channel k
    (lexicographic index into product(axis_shifts)) of seg (K, G...), a
    tensor or a `LiveTable`, contributes to target
    t = clip(grid_index + shifts[k], 0, out_n - 1) per axis
    (``ops/cuda_fold.py``: one kernel launch on the card)."""
    return fold(seg, axis_shifts, out_shape, combine, fill)


