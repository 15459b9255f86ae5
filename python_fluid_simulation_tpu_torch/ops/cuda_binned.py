"""Segmented reduce and broadcast over cell-sorted rows: CUDA kernels +
plain versions.

Replaces ``python_fluid_simulation_tpu/ops/pallas_binned.py::
binned_segment_reduce`` (``_kernel``, row-major and ``channels_first``)
and ``binned_segment_broadcast`` (``_bcast_kernel``), the engine's
particle -> cell reduces (P2G, level sets, volumes, density scatter) and
cell -> particle gathers (G2P, density displacement).  The kernels are in
``csrc/binned_segment.cu``:

  * reduce: one thread per (segment, channel), the segment's row range
    found by binary search on the sorted ids inside the kernel, the rows
    reduced serially in row order from ``fill`` (no atomics: bitwise
    repeatable, and the same order as ``torch.segment_reduce``);
  * broadcast: one thread per output element, 0 for ids outside [0, M).

Both are bound by bytes.  The JAX package runs its binned kernels only
above 4e5 segments (a TPU fusion trade-off); here a CUDA tensor takes the
kernels at every size.

Contract (the same on both routes): ``sorted_ids`` is non-decreasing
int64; rows whose id lies outside [0, M) (negative ids included) are
dropped by the reduce and read 0 in the broadcast; ``min`` is clamped at
``fill``; ``add`` adds the rows to ``fill``.

Routing: a CUDA tensor launches the kernel; a CPU tensor runs the plain
version (`segment_reduce_plain`, `segment_broadcast_plain`).
"""

from __future__ import annotations

import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb

_OPS = {"add": "sum", "min": "min"}


def _offsets(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """offsets[m] = first row with id >= m, for m in [0, M]: rows of
    segment m are offsets[m]:offsets[m+1]; rows with ids outside [0, M)
    fall outside every segment."""
    bounds = torch.arange(num_segments + 1, device=sorted_ids.device, dtype=sorted_ids.dtype)
    return torch.searchsorted(sorted_ids, bounds)


def segment_reduce_plain(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0, channels_first: bool = False):
    """(K, C) sorted rows -> (M, C), or (C, M) with `channels_first`."""
    seg = torch.segment_reduce(
        vals, _OPS[op], offsets=_offsets(sorted_ids, num_segments), axis=0,
        unsafe=True, initial=float(fill),
    )
    return seg.t().contiguous() if channels_first else seg


def segment_broadcast_plain(table, sorted_ids):
    """``out[i] = table[sorted_ids[i]]``, 0 for ids outside [0, M)."""
    m = table.shape[0]
    valid = (sorted_ids >= 0) & (sorted_ids < m)
    rows = table[torch.clamp(sorted_ids, 0, m - 1)]
    mask = valid.reshape(valid.shape + (1,) * (rows.ndim - 1))
    return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))


# The kernels take the segment count and the channel count as 32-bit ints
# and a reduce block walks its 256 segments' (segment, channel) pairs with
# a 32-bit counter; every element offset (row * C + c, segment * C + c,
# c * M + segment) is 64-bit, so a table may hold more than 2^31 entries
# (the level set's 125-channel reduce at 126x504x126 cells: 1.0e9).
MAX_SEGMENTS = 2**31 - 1
MAX_CHANNELS = (2**31 - 1) // 256


def _check_extents(name, m, c):
    if not (0 <= m <= MAX_SEGMENTS and 0 < c <= MAX_CHANNELS):
        raise ValueError(f"{name}: at most {MAX_SEGMENTS} segments of at most {MAX_CHANNELS} channels, got {m} x {c}")


def _check_rows(name, vals, sorted_ids):
    if vals.ndim != 2 or vals.dtype != torch.float32 or not vals.is_contiguous():
        raise ValueError(f"{name}: need contiguous float32 (K, C) values, got {vals.dtype} {tuple(vals.shape)}")
    if (sorted_ids.ndim != 1 or sorted_ids.dtype != torch.int64 or not sorted_ids.is_contiguous()
            or sorted_ids.device != vals.device):
        raise ValueError(f"{name}: need contiguous int64 (K,) ids on {vals.device}, got "
                         f"{sorted_ids.dtype} {tuple(sorted_ids.shape)} on {sorted_ids.device}")


def segment_reduce(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0, channels_first: bool = False):
    """Reduce the (K, C) rows of each segment: (M, C), or (C, M) with
    `channels_first`."""
    if op not in _OPS:
        raise ValueError(f"segment_reduce: op must be one of {tuple(_OPS)}, got {op!r}")
    if vals.device.type == "cpu":
        return segment_reduce_plain(vals, sorted_ids, num_segments, op, fill, channels_first)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_reduce: unsupported device {vals.device}")
    _check_rows("segment_reduce", vals, sorted_ids)
    k, c = vals.shape
    if sorted_ids.shape[0] != k:
        raise ValueError(f"segment_reduce: {sorted_ids.shape[0]} ids for {k} rows")
    _check_extents("segment_reduce", int(num_segments), c)
    out = torch.empty((c, num_segments) if channels_first else (num_segments, c), dtype=vals.dtype, device=vals.device)
    err = cb.LIB.get().pfs_binned_reduce(
        vals.data_ptr(), sorted_ids.data_ptr(), k, int(num_segments), c, int(op == "min"),
        int(channels_first), float(fill), out.data_ptr(), cb.stream_of(vals),
    )
    cb.check(err, "binned_segment_reduce launch")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0


def segment_broadcast(table, sorted_ids):
    """``out[i] = table[sorted_ids[i]]`` for a (M, C) table: (K, C)."""
    if table.device.type == "cpu":
        return segment_broadcast_plain(table, sorted_ids)
    if table.device.type != "cuda":
        raise ValueError(f"segment_broadcast: unsupported device {table.device}")
    _check_rows("segment_broadcast", table, sorted_ids)
    m, c = table.shape
    _check_extents("segment_broadcast", m, c)
    k = sorted_ids.shape[0]
    out = torch.empty((k, c), dtype=table.dtype, device=table.device)
    err = cb.LIB.get().pfs_binned_broadcast(
        table.data_ptr(), sorted_ids.data_ptr(), k, m, c, out.data_ptr(), cb.stream_of(table),
    )
    cb.check(err, "binned_segment_broadcast launch")
    segment_broadcast.launches += 1
    return out


segment_broadcast.launches = 0
