"""The clipped per-corner fold of a segment table: CUDA kernel + plain
version.

Replaces ``python_fluid_simulation_tpu/ops/pallas_fold.py::
fold_scattered_sep_pallas``.  Every transfer scatters its particles into
a channel-major table ``seg (C, E0, E1, E2)`` (one channel per corner
offset, ``ops/scatter.py``); the fold then lands channel c of source cell
e on the target ``t = clip(e + s_c, 0, N - 1)`` per axis (the reference's
per-corner border clamp, cell 2 :128), combining by add or min, ``fill``
where nothing lands.

On Hopper it is one launch (``csrc/fold.cu``): one thread per target
cell walks the source positions of each channel that land on it, so the
table is read once and the grid written once; it is bound by those bytes
(the level set's 125-channel min table at 64x256x64 is 524 MB).  The
plain version folds axis by axis on whole channel blocks and then
resolves the clipped border planes (`fold_clip`), in the same order of
operations as the kernel: the clipped planes combine in a left fold
(not ``torch.sum``'s order), so kernel and plain version agree bitwise,
sums included.

Routing: a CUDA tensor launches the kernel; a CPU tensor runs
`fold_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb
from python_fluid_simulation_tpu_torch.ops.indexing import sample

MAX_SHIFTS = 5  # shifts per axis the kernel takes
MAX_TARGETS = 1 << 30  # the kernel indexes targets in 32 bits


def _combine(acc, piece, combine):
    if acc is None:
        return piece
    return acc + piece if combine == "add" else torch.minimum(acc, piece)


def fold_plain(seg: torch.Tensor, axis_shifts, out_shape: Sequence[int], combine: str = "add", fill=0.0) -> torch.Tensor:
    """Combine per-corner segment grids onto clipped targets, separably.

    seg: (K, G...) with channel k = lexicographic index into
    product(axis_shifts); channel k contributes to target
    t = clip(grid_index + shifts[k], 0, out_n - 1) per axis.  Folds axis
    by axis on whole channel blocks, then `fold_clip` resolves the
    border clamping.
    """
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


def fold(seg: torch.Tensor, axis_shifts, out_shape: Sequence[int], combine: str = "add", fill=0.0) -> torch.Tensor:
    """The fold of `fold_plain`; on CUDA one kernel launch.

    The kernel takes a 3D fold of a float32 (C, E0, E1, E2) table whose
    three grid dims are contiguous (any channel stride: the callers pass
    channel slices of one table) with at most `MAX_SHIFTS` shifts an axis,
    onto at most `MAX_TARGETS` cells.
    """
    if seg.device.type == "cpu":
        return fold_plain(seg, axis_shifts, out_shape, combine, fill)
    if seg.device.type != "cuda":
        raise ValueError(f"fold: unsupported device {seg.device}")
    shifts = [tuple(int(s) for s in a) for a in axis_shifts]
    n_ch = int(np.prod([len(s) for s in shifts]))
    if len(out_shape) != 3 or seg.ndim != 4 or len(shifts) != 3:
        raise ValueError(f"fold: 3D folds only, got seg {tuple(seg.shape)} onto {tuple(out_shape)}")
    if seg.dtype != torch.float32 or seg.shape[0] != n_ch or any(len(s) > MAX_SHIFTS for s in shifts):
        raise ValueError(f"fold: need float32 ({n_ch}, E0, E1, E2) and <= {MAX_SHIFTS} shifts an axis, "
                         f"got {seg.dtype} {tuple(seg.shape)}, shifts {shifts}")
    _, e0, e1, e2 = (int(v) for v in seg.shape)
    if seg.stride()[1:] != (e1 * e2, e2, 1):
        raise ValueError(f"fold: the grid dims of seg must be contiguous, strides {seg.stride()}")
    if int(np.prod([int(n) for n in out_shape])) > MAX_TARGETS:
        raise ValueError(f"fold: more than {MAX_TARGETS} targets {tuple(out_shape)}")
    if combine not in ("add", "min"):
        raise ValueError(f"fold: unknown combine {combine!r}")
    out = torch.empty(tuple(int(n) for n in out_shape), dtype=torch.float32, device=seg.device)
    flat = [s for a in shifts for s in a]
    err = cb.LIB.get().pfs_fold(
        seg.data_ptr(), int(seg.stride()[0]), out.data_ptr(), e0, e1, e2, *out.shape,
        *[len(s) for s in shifts], (ctypes.c_int * len(flat))(*flat), float(np.float32(fill)),
        int(combine == "min"), cb.stream_of(seg),
    )
    cb.check(err, "fold launch")
    fold.launches += 1
    return out


fold.launches = 0
