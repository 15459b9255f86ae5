"""Deterministic particle <-> grid scatter machinery over cell-sorted rows.

Counterpart of ``python_fluid_simulation_tpu.ops.scatter``: one stable
sort of the per-particle home-cell ids, then

  * segmented add / min over the sorted rows and the segment broadcast
    ``out[i] = table[sorted_ids[i]]`` — the binned segment kernels of
    ``ops/cuda_binned.py`` (each segment reduced by one thread in row
    order, so the sums are exact per segment and bitwise repeatable, no
    atomics), whose plain versions run on the CPU,
  * per-corner-offset folds of the per-cell tables onto the grid that
    reproduce the reference's per-corner border clamping
    (``max(0, min(gres-1, gi + offs))``, cell 2 :128).

Ids outside [0, M) — negative ones included — are dropped by the reduce
and read 0 in the broadcast.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from python_fluid_simulation_tpu_torch.ops.cuda_binned import segment_broadcast, segment_reduce


def sort_by_segment(ids: torch.Tensor, *vals: torch.Tensor):
    """Stable sort of (ids, vals...) by ids; vals may be (K,) or (K, C)."""
    sorted_ids, order = torch.sort(ids, stable=True)
    return (sorted_ids,) + tuple(v[order] for v in vals)


def _rows(vals: torch.Tensor) -> torch.Tensor:
    """(K,) or (K, C...) -> contiguous (K, C)."""
    return vals.reshape(vals.shape[0], -1).contiguous()


def segment_sum_sorted(vals: torch.Tensor, sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment sums of rows sorted by segment id: (M,) or (M, C);
    empty segments are 0."""
    out = segment_reduce(_rows(vals), sorted_ids.contiguous(), num_segments, "add", 0.0)
    return out.reshape((num_segments,) + tuple(vals.shape[1:]))


def segment_min_sorted(vals: torch.Tensor, sorted_ids: torch.Tensor, num_segments: int, fill) -> torch.Tensor:
    """Per-segment minima CLAMPED at ``fill``: row m is
    ``min(fill, min over segment m)``, and ``fill`` where it is empty —
    the reference's background-initialised ``atomic.min`` (cell 4 :288)."""
    out = segment_reduce(_rows(vals), sorted_ids.contiguous(), num_segments, "min", float(fill))
    return out.reshape((num_segments,) + tuple(vals.shape[1:]))


def segment_broadcast_sorted(table: torch.Tensor, sorted_ids: torch.Tensor) -> torch.Tensor:
    """``out[i] = table[sorted_ids[i]]``; rows whose id lies outside
    [0, M) read 0."""
    out = segment_broadcast(_rows(table), sorted_ids.contiguous())
    return out.reshape(tuple(sorted_ids.shape) + tuple(table.shape[1:]))


def segment_reduce_cf(vals, sorted_ids, num_segments: int, grid_shape: Sequence[int], op: str = "add", fill=0.0):
    """Segmented reduce of (K, C) rows emitted channels-first:
    (C, *grid_shape)."""
    out = segment_reduce(vals.contiguous(), sorted_ids.contiguous(), num_segments, op, float(fill), channels_first=True)
    return out.reshape((vals.shape[-1],) + tuple(grid_shape))


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


def _combine(acc, piece, combine):
    if acc is None:
        return piece
    return acc + piece if combine == "add" else torch.minimum(acc, piece)


def fold_scattered_sep(seg: torch.Tensor, axis_shifts, out_shape: Sequence[int], combine: str = "add", fill=0.0) -> torch.Tensor:
    """Combine per-corner segment grids onto clipped targets, separably.

    seg: (K, G...) with channel k = lexicographic index into
    product(axis_shifts); channel k contributes to target
    t = clip(grid_index + shifts[k], 0, out_n - 1) per axis.  Folds axis
    by axis on whole channel blocks, then `fold_clip` resolves the
    border clamping.
    """
    from python_fluid_simulation_tpu_torch.ops.indexing import sample

    d = len(out_shape)
    sizes = [len(s) for s in axis_shifts]
    min_s = [min(s) for s in axis_shifts]
    max_s = [max(s) for s in axis_shifts]
    cur = seg.reshape(tuple(sizes) + tuple(seg.shape[1:]))
    for a in range(d):
        # cur dims: (s_a, .., s_{d-1}, T_0..T_{a-1}, X_a, .., X_{d-1});
        # the spatial axis to shift sits at index d after taking cur[i]
        t_a = cur.shape[d] + max_s[a] - min_s[a]
        acc = None
        for i, s in enumerate(axis_shifts[a]):
            tgt = list(cur.shape[1:])
            tgt[d - 1] = t_a
            off = [0] * len(tgt)
            off[d - 1] = min_s[a] - s
            acc = _combine(acc, sample(cur[i], tuple(off), tuple(tgt), fill), combine)
        cur = acc
    return fold_clip(cur, tuple(min_s), out_shape, combine, fill)


def fold_clip(field: torch.Tensor, shifts: Sequence[int], out_shape: Sequence[int], combine: str = "add", fill=0.0) -> torch.Tensor:
    """Redistribute `field` onto targets t = clip(c + shift, 0, out_n-1)
    per axis, reducing all clipped planes into the edge rows.  Targets no
    source plane reaches get `fill`."""
    out = field
    for axis, (s, out_n) in enumerate(zip(shifts, out_shape)):
        s = int(s)
        n = out.shape[axis]

        def take(a, b, src=out, axis=axis):
            return src.narrow(axis, a, b - a)

        def reduce_planes(planes, axis=axis):
            if combine == "add":
                return torch.sum(planes, dim=axis, keepdim=True)
            return torch.amin(planes, dim=axis, keepdim=True)

        def fill_plane(k, ref=out, axis=axis):
            shape = list(ref.shape)
            shape[axis] = k
            return torch.full(shape, fill, dtype=ref.dtype, device=ref.device)

        # source groups: [0, L) -> t=0;  [L, R) -> t=c+s;  [R, n) -> t=out_n-1
        L = min(max(1 - s, 0), n)
        R = max(min(max(out_n - 1 - s, 0), n), L)
        pieces = [reduce_planes(take(0, L)) if L > 0 else fill_plane(1)]
        pre_gap = (L + s - 1) if L > 0 else (s - 1)
        pre_gap = max(0, min(out_n - 2, pre_gap))
        if pre_gap:
            pieces.append(fill_plane(pre_gap))
        if R > L:
            pieces.append(take(L, R))
        post_gap = max(0, (out_n - 1) - ((R + s) if R > L else (1 + pre_gap)))
        if post_gap:
            pieces.append(fill_plane(post_gap))
        pieces.append(reduce_planes(take(R, n)) if R < n else fill_plane(1))
        out = torch.cat(pieces, dim=axis)
        if out.shape[axis] != out_n:
            raise AssertionError((tuple(out.shape), axis, out_n, s))
    return out
