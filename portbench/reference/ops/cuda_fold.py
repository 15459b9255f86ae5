"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/cuda_fold.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

The clipped per-corner fold of a segment table: CUDA kernel + plain
version.

Replaces ``python_fluid_simulation_tpu/ops/pallas_fold.py::
fold_scattered_sep_pallas``.  Every transfer scatters its particles into
a channel-major table ``seg (C, E0, E1, E2)`` (one channel per corner
offset, ``ops/scatter.py``); the fold then lands channel c of source cell
e on the target ``t = clip(e + s_c, 0, N - 1)`` per axis (the reference's
per-corner border clamp, cell 2 :128), combining by add or min, ``fill``
where nothing lands.

The table is dense (a (C, E0, E1, E2) tensor, any channel stride) or
the scatter's live form (``ops/cuda_binned.py::LiveTable``: the nonempty
source cells' columns and a map over the cells).  On Hopper either is
one launch of ``csrc/fold.cu``: a block owns a tile of targets; in the
live form it stages the map over the tile's source box in shared memory,
writes ``fill`` at the targets with no nonempty source (most of them)
and walks only the nonempty columns for the rest, so it is bound by the
map, the nonempty columns and the grid's bytes.  The plain version folds
axis by axis on whole channel blocks and then resolves the clipped
border planes (`fold_clip`), in the same order of operations as the
kernel: the clipped planes combine in a left fold (not ``torch.sum``'s
order), so kernel and plain version agree bitwise, sums included; a live
table's plain fold is `fold_plain` of its dense expansion.

A 2D fold (the 2D engine's transfers, level set and volume) runs on the
same kernel as a 3D fold with a unit leading axis (`lift_2d`).

Routing: a CUDA tensor launches the kernel; a CPU tensor runs
`fold_plain`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from portbench.reference.ops.cuda_binned import LiveTable
from portbench.reference.ops.indexing import sample


def _combine(acc, piece, combine):
    if acc is None:
        return piece
    return acc + piece if combine == "add" else torch.minimum(acc, piece)


def fold_plain(seg, axis_shifts, out_shape: Sequence[int], combine: str = "add", fill=0.0) -> torch.Tensor:
    """Combine per-corner segment grids onto clipped targets, separably.

    seg: (K, G...) with channel k = lexicographic index into
    product(axis_shifts), or a `LiveTable` (folded as its dense
    expansion); channel k contributes to target
    t = clip(grid_index + shifts[k], 0, out_n - 1) per axis.  Folds axis
    by axis on whole channel blocks, then `fold_clip` resolves the
    border clamping.
    """
    if isinstance(seg, LiveTable):
        seg = seg.dense()
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
    per axis, combining all clipped planes into the edge rows (a left
    fold, plane by plane).  Targets no source plane reaches get `fill`."""
    out = field
    for axis, (s, out_n) in enumerate(zip(shifts, out_shape)):
        s = int(s)
        n = out.shape[axis]

        def take(a, b, src=out, axis=axis):
            return src.narrow(axis, a, b - a)

        def reduce_planes(a, b, src=out, axis=axis):
            acc = None
            for k in range(a, b):
                acc = _combine(acc, src.narrow(axis, k, 1), combine)
            return acc

        def fill_plane(k, ref=out, axis=axis):
            shape = list(ref.shape)
            shape[axis] = k
            return torch.full(shape, fill, dtype=ref.dtype, device=ref.device)

        if out_n == 1:  # one target takes every plane (the unit axis of a lifted 2D fold)
            out = reduce_planes(0, n)
            continue
        # source groups: [0, L) -> t=0;  [L, R) -> t=c+s;  [R, n) -> t=out_n-1
        L = min(max(1 - s, 0), n)
        R = max(min(max(out_n - 1 - s, 0), n), L)
        pieces = [reduce_planes(0, L) if L > 0 else fill_plane(1)]
        pre_gap = (L + s - 1) if L > 0 else (s - 1)
        pre_gap = max(0, min(out_n - 2, pre_gap))
        if pre_gap:
            pieces.append(fill_plane(pre_gap))
        if R > L:
            pieces.append(take(L, R))
        post_gap = max(0, (out_n - 1) - ((R + s) if R > L else (1 + pre_gap)))
        if post_gap:
            pieces.append(fill_plane(post_gap))
        pieces.append(reduce_planes(R, n) if R < n else fill_plane(1))
        out = torch.cat(pieces, dim=axis)
        if out.shape[axis] != out_n:
            raise AssertionError((tuple(out.shape), axis, out_n, s))
    return out


def fold(seg, axis_shifts, out_shape: Sequence[int], combine: str = "add", fill=0.0) -> torch.Tensor:
    """The fold of `fold_plain`."""
    return fold_plain(seg, axis_shifts, out_shape, combine, fill)

