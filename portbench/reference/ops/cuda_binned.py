"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/cuda_binned.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Segmented reduce and broadcast over cell-sorted rows: CUDA kernels +
plain versions.

Replaces ``python_fluid_simulation_tpu/ops/pallas_binned.py::
binned_segment_reduce`` (``_kernel``, row-major and ``channels_first``,
and the two-phase ``_scan_kernel``) and ``binned_segment_broadcast``
(``_bcast_kernel``), the engine's particle -> cell reduces (P2G, level
sets, volumes, density scatter) and cell -> particle gathers (G2P,
density displacement).  The kernels are in ``csrc/binned_segment.cu``
and ``csrc/seg_scan.cu``:

  * the serial reduce (`serial_reduce`): tiles of 128 segments dealt to
    the resident blocks, each tile's row range from two binary searches
    and its segments' rows from one marking pass; a warp reduces a
    segment x 32-channel group, a lane a channel, serially in row order
    from ``fill`` (no atomics: bitwise repeatable, and the same order as
    ``torch.segment_reduce``), staged through shared memory so that both
    layouts are written coalesced; a tile with no rows writes ``fill``
    only;
  * the scan reduce (`scan_reduce`, the step's route): the inclusive
    segmented scan of the rows (``ops/cuda_scan.py::seg_scan_sorted``,
    every row read once, coalesced), then `place_live`, which writes each
    segment's last row, combined with ``fill``, in live form: only the
    nonempty segments' columns and a map over the segments, a
    `LiveTable`, for at most `SCAN_CHANNELS` channels;
  * broadcast: a warp walks 32 sorted rows at a time, reads each run of
    equal ids' table row once and writes it to every row of the run (as
    float2 vectors where C is even), 0 for ids outside [0, M).

All are bound by bytes.  `segment_reduce` gives the dense table: the
scan route expanded (`LiveTable.dense`) for at most `SCAN_CHANNELS`
channels, the serial kernel for wider rows; the JAX package's gates (its
4e5-segment binned gate, ``PFS_SCAN_REDUCE``) are TPU trade-offs and do
not carry over.  Both routes add in row order, so with ``fill`` = 0
(every add caller) they agree bitwise, and the min is order-free.

Contract (the same on every route): ``sorted_ids`` is non-decreasing
int64; rows whose id lies outside [0, M) (negative ids included) are
dropped by the reduce and read 0 in the broadcast; ``min`` is clamped at
``fill``; ``add`` adds the rows to ``fill``.

Routing: a CUDA tensor launches the kernels; a CPU tensor takes the same
route and runs its plain versions (`segment_reduce_plain`,
`scan_reduce_plain`, `place_live_plain`, `segment_broadcast_plain`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from portbench.reference.ops.cuda_scan import MAX_CHANNELS as SCAN_CHANNELS
from portbench.reference.ops.cuda_scan import combine, seg_scan_sorted, seg_scan_sorted_plain

_OPS = {"add": "sum", "min": "min"}


@dataclasses.dataclass(frozen=True)
class LiveTable:
    """A channel-major segment table in live form: only the nonempty
    segments' columns, and a map over the segments.

    Channel k, segment m holds ``live[channels[k], slot[m]]`` where
    ``slot[m] >= 0`` and ``fill`` where ``slot[m] == -1`` (an empty
    segment).  ``live`` is (C, cap) float32 with contiguous rows: column j
    is the j-th nonempty segment in ascending id order, and the columns
    past the last nonempty segment are never written.  ``slot`` is (M,)
    int32 over the segments of ``grid_shape`` (M = its product, z
    fastest).  Selecting channels (a slice or a list of ints) shares the
    columns and the map; nothing is copied.
    """

    live: torch.Tensor
    slot: torch.Tensor
    grid_shape: Tuple[int, ...]
    fill: float
    channels: Tuple[int, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.channels),) + tuple(self.grid_shape)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            chans = self.channels[idx]
        else:
            chans = tuple(self.channels[int(i)] for i in idx)
        return dataclasses.replace(self, channels=chans)

    def dense(self) -> torch.Tensor:
        """The dense (C, *grid_shape) table (the plain expansion)."""
        live = self.live[list(self.channels)]
        full = torch.full((live.shape[0], self.slot.shape[0]), float(self.fill), dtype=live.dtype, device=live.device)
        has = self.slot >= 0
        full[:, has] = live[:, self.slot[has].long()]
        return full.reshape(self.shape)


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


MAX_CHANNELS = (2**31 - 1) // 256


def segment_reduce(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0, channels_first: bool = False):
    """Reduce the (K, C) rows of each segment into the dense table: (M, C),
    or (C, M) with `channels_first`.  The scan route's live form expanded
    for at most `SCAN_CHANNELS` channels (the scan kernels' limit), the
    serial kernel for wider rows."""
    if op not in _OPS:
        raise ValueError(f"segment_reduce: op must be one of {tuple(_OPS)}, got {op!r}")
    if vals.shape[-1] > SCAN_CHANNELS:
        return serial_reduce(vals, sorted_ids, num_segments, op, fill, channels_first)
    table = scan_reduce(vals, sorted_ids, num_segments, op, fill).dense()
    return table if channels_first else table.t().contiguous()


def serial_reduce(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0, channels_first: bool = False):
    """The serial route (the plain version)."""
    return segment_reduce_plain(vals, sorted_ids, num_segments, op, fill, channels_first)


def segment_same(sorted_ids):
    """``same[i]``: row i continues row i-1's segment (row 0: False)."""
    same = torch.zeros(sorted_ids.shape, dtype=torch.bool, device=sorted_ids.device)
    torch.eq(sorted_ids[1:], sorted_ids[:-1], out=same[1:])
    return same


def place_live_plain(scanned, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    """The segment table in live form: the nonempty segments'
    columns (each segment's last scanned row combined with `fill`, in
    ascending id order) and their map; (M,) grid, every channel."""
    k, c = scanned.shape
    last = torch.ones(k, dtype=torch.bool, device=scanned.device)
    torch.ne(sorted_ids[1:], sorted_ids[:-1], out=last[:-1])
    keep = last & (sorted_ids >= 0) & (sorted_ids < num_segments)
    rows = scanned[keep]
    live = torch.empty((c, min(k, num_segments)), dtype=scanned.dtype, device=scanned.device)
    live[:, : rows.shape[0]] = combine(torch.full_like(rows, float(fill)), rows, op).t()
    slot = torch.full((num_segments,), -1, dtype=torch.int32, device=scanned.device)
    slot[sorted_ids[keep]] = torch.arange(rows.shape[0], dtype=torch.int32, device=scanned.device)
    return LiveTable(live, slot, (int(num_segments),), float(fill), tuple(range(c)))


def place_live(scanned, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    """`place_live_plain`."""
    return place_live_plain(scanned, sorted_ids, num_segments, op, fill)


def scan_reduce(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    """The scan route in live form: `seg_scan_sorted` of the rows, then
    `place_live`; the plain versions on the CPU."""
    return place_live(seg_scan_sorted(vals, segment_same(sorted_ids), op), sorted_ids, num_segments, op, fill)


def scan_reduce_plain(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    return place_live_plain(seg_scan_sorted_plain(vals, segment_same(sorted_ids), op), sorted_ids, num_segments, op,
                            fill)


def segment_broadcast(table, sorted_ids):
    """``out[i] = table[sorted_ids[i]]`` for a (M, C) table: (K, C) (the
    plain version)."""
    return segment_broadcast_plain(table, sorted_ids)

