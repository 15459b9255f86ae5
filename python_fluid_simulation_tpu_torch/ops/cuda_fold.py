"""The clipped per-corner fold of a segment table: CUDA kernel + plain
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

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb
from python_fluid_simulation_tpu_torch.ops.cuda_binned import LiveTable
from python_fluid_simulation_tpu_torch.ops.indexing import sample
from python_fluid_simulation_tpu_torch.utils.step_bytes import counted_bytes

MAX_SHIFTS = 5  # shifts per axis the kernel takes
MAX_TARGETS = 1 << 30  # the kernel indexes targets in 32 bits


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


def fold_shortcut(table_fill, fill, combine: str) -> bool:
    """Whether a target whose every source reads `fill` may write `fill`
    without combining them: the empty cells hold `fill` too (bitwise), it
    is not NaN, and combine(fill, fill) == fill (min, or add of a zero)."""
    f, t = np.float32(fill), np.float32(table_fill)
    if f.tobytes() != t.tobytes() or np.isnan(f):
        return False
    return combine == "min" or (f + f).tobytes() == f.tobytes()


def lift_2d(seg, axis_shifts, out_shape):
    """A 2D fold as the 3D fold the kernel runs: the table over (1, E0, E1)
    (a dense (C, E0, E1) tensor gains a unit axis, a `LiveTable` the same
    grid with a unit axis in front: its map over E0 * E1 cells is
    unchanged), the shift list (0,) on that axis, and the targets
    (1, N0, N1).  The unit axis leads so that the kernel's warps, which
    run along the last axis, run along E1 (a trailing unit axis would
    leave 31 of a warp's 32 lanes idle); the arithmetic is the 2D fold's
    in either place (one shift and one plane on the unit axis combine
    nothing)."""
    if isinstance(seg, LiveTable):
        seg3 = dataclasses.replace(seg, grid_shape=(1,) + tuple(seg.grid_shape))
    else:
        seg3 = seg.unsqueeze(1)
    return seg3, [(0,)] + [tuple(a) for a in axis_shifts], (1,) + tuple(int(n) for n in out_shape)


def fold_bytes(seg, out_shape) -> int:
    """A fold's traffic (row 14): of a live table the map and the folded
    channels' S nonempty columns read once, of a dense table every entry;
    the targets written once."""
    n_out = int(np.prod([int(n) for n in out_shape]))
    if isinstance(seg, LiveTable):
        s = int((seg.slot >= 0).sum())
        return seg.slot.numel() * 4 + s * len(seg.channels) * 4 + n_out * 4
    return (seg.numel() + n_out) * 4


@counted_bytes(lambda out, seg, out_shape, **_: fold_bytes(seg, out_shape))
def fold(seg, axis_shifts, out_shape: Sequence[int], combine: str = "add", fill=0.0) -> torch.Tensor:
    """The fold of `fold_plain`; on CUDA one kernel launch.

    The kernel takes a 3D fold of a float32 table -- a (C, E0, E1, E2)
    tensor whose three grid dims are contiguous (any channel stride: the
    callers pass channel slices of one table), or a `LiveTable` over an
    (E0, E1, E2) grid -- with at most `MAX_SHIFTS` shifts an axis, onto at
    most `MAX_TARGETS` cells, and a 2D fold (a (C, E0, E1) table or a
    `LiveTable` over (E0, E1)) as the 3D fold of `lift_2d`.
    """
    live = isinstance(seg, LiveTable)
    dev = (seg.live if live else seg).device
    if dev.type == "cpu":
        return fold_plain(seg, axis_shifts, out_shape, combine, fill)
    if dev.type != "cuda":
        raise ValueError(f"fold: unsupported device {dev}")
    if len(out_shape) == 2 and len(seg.shape) == 3 and len(axis_shifts) == 2:
        seg3, shifts3, out3 = lift_2d(seg, axis_shifts, out_shape)
        return fold(seg3, shifts3, out3, combine, fill).reshape(tuple(int(n) for n in out_shape))
    shifts = [tuple(int(s) for s in a) for a in axis_shifts]
    n_ch = int(np.prod([len(s) for s in shifts]))
    if len(out_shape) != 3 or len(seg.shape) != 4 or len(shifts) != 3:
        raise ValueError(f"fold: 2D or 3D folds only, got seg {tuple(seg.shape)} onto {tuple(out_shape)}")
    values = seg.live if live else seg
    if values.dtype != torch.float32 or seg.shape[0] != n_ch or any(len(s) > MAX_SHIFTS for s in shifts):
        raise ValueError(f"fold: need float32 ({n_ch}, E0, E1, E2) and <= {MAX_SHIFTS} shifts an axis, "
                         f"got {values.dtype} {tuple(seg.shape)}, shifts {shifts}")
    _, e0, e1, e2 = (int(v) for v in seg.shape)
    if live:
        if (values.ndim != 2 or values.stride(1) != 1 or seg.slot.dtype != torch.int32
                or not seg.slot.is_contiguous() or seg.slot.shape != (e0 * e1 * e2,) or seg.slot.device != dev):
            raise ValueError("fold: a live table needs (C, cap) columns with contiguous rows and an int32 map "
                             f"over its {e0 * e1 * e2} cells on {dev}")
        choff = [c * values.stride(0) for c in seg.channels]
        slot, table_fill = seg.slot.data_ptr(), seg.fill
    else:
        if seg.stride()[1:] != (e1 * e2, e2, 1):
            raise ValueError(f"fold: the grid dims of seg must be contiguous, strides {seg.stride()}")
        choff = [c * seg.stride(0) for c in range(n_ch)]
        slot, table_fill = None, fill
    if int(np.prod([int(n) for n in out_shape])) > MAX_TARGETS:
        raise ValueError(f"fold: more than {MAX_TARGETS} targets {tuple(out_shape)}")
    if combine not in ("add", "min"):
        raise ValueError(f"fold: unknown combine {combine!r}")
    out = torch.empty(tuple(int(n) for n in out_shape), dtype=torch.float32, device=dev)
    flat = [s for a in shifts for s in a]
    with cb.launching("fold", values, seg.slot if live else None) as stream:
        err = cb.LIB.get().pfs_fold(
            values.data_ptr(), (ctypes.c_longlong * n_ch)(*choff), slot, out.data_ptr(), e0, e1, e2, *out.shape,
            *[len(s) for s in shifts], (ctypes.c_int * len(flat))(*flat), float(np.float32(fill)),
            float(np.float32(table_fill)), int(fold_shortcut(table_fill, fill, combine)), int(combine == "min"),
            stream,
        )
    cb.check(err, "fold launch")
    fold.launches += 1
    return out


fold.launches = 0
