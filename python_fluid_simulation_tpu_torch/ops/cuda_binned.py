"""Segmented reduce and broadcast over cell-sorted rows: CUDA kernels +
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
`scan_reduce_plain`, `place_live_plain`, `segment_broadcast_plain`;
`place_segments_plain` is the dense placement's, the yardstick of the
live form).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb
from python_fluid_simulation_tpu_torch.ops.cuda_scan import MAX_CHANNELS as SCAN_CHANNELS
from python_fluid_simulation_tpu_torch.ops.cuda_scan import combine, seg_scan_sorted, seg_scan_sorted_plain
from python_fluid_simulation_tpu_torch.utils.step_bytes import counted_bytes

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


# The kernels take the segment count and the channel count as 32-bit ints
# (channels at most 2^31 / 256, so no 32-bit channel index a kernel steps
# through can overflow); every element offset (row * C + c, segment * C +
# c, c * M + segment) is 64-bit, so a table may hold more than 2^31
# entries (the level set's 125-channel reduce at 126x504x126 cells: 1.0e9).
MAX_SEGMENTS = 2**31 - 1
MAX_CHANNELS = (2**31 - 1) // 256


def live_rows(sorted_ids, num_segments: int) -> int:
    """Rows whose id lies in [0, M): the rows a reduce reads."""
    offs = _offsets(sorted_ids, num_segments)
    return int(offs[-1] - offs[0])


def reduce_bytes(live: int, k: int, c: int, m: int) -> int:
    """A dense reduce's traffic (row 10): the live rows and the K int64
    ids read once, the (M, C) table written once."""
    return live * c * 4 + k * 8 + m * c * 4


def place_live_bytes(k: int, s: int, c: int, m: int) -> int:
    """`place_live`'s traffic (row 11's placement): the ids and the S
    nonempty segments' last rows read, their S columns and the (M,) map
    written."""
    return k * 8 + 2 * s * c * 4 + m * 4


def live_route_bytes(live: int, k: int, s: int, c: int, m: int) -> int:
    """The scan route's function (`scan_reduce`: scan, then the live
    placement) as one: the live rows and the ids read once, the S columns
    and the map written once."""
    return live * c * 4 + k * 8 + s * c * 4 + m * 4


def broadcast_bytes(k: int, used: int, c: int) -> int:
    """`segment_broadcast`'s traffic (row 12): the K int64 ids and the
    used table rows read once, the (K, C) rows written once."""
    return k * 8 + used * c * 4 + k * c * 4


def used_rows(table, sorted_ids) -> int:
    """Distinct in-range table rows a broadcast reads."""
    m = table.shape[0]
    return int(torch.unique_consecutive(sorted_ids[(sorted_ids >= 0) & (sorted_ids < m)]).numel())


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


@counted_bytes(lambda out, vals, sorted_ids, num_segments, **_: reduce_bytes(
    live_rows(sorted_ids, num_segments), vals.shape[0], vals.shape[1], int(num_segments)))
def serial_reduce(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0, channels_first: bool = False):
    """The serial route: on CUDA one launch of the serial reduce kernel."""
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
    with cb.launching("segment_reduce", vals, sorted_ids) as stream:
        err = cb.LIB.get().pfs_binned_reduce(
            vals.data_ptr(), sorted_ids.data_ptr(), k, int(num_segments), c, int(op == "min"),
            int(channels_first), float(fill), out.data_ptr(), stream,
        )
    cb.check(err, "binned_segment_reduce launch")
    serial_reduce.launches += 1
    return out


serial_reduce.launches = 0


def segment_same(sorted_ids):
    """``same[i]``: row i continues row i-1's segment (row 0: False)."""
    same = torch.zeros(sorted_ids.shape, dtype=torch.bool, device=sorted_ids.device)
    torch.eq(sorted_ids[1:], sorted_ids[:-1], out=same[1:])
    return same


def place_segments_plain(scanned, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0,
                         channels_first: bool = False):
    """Each segment's last scanned row combined with `fill` (add:
    ``fill + row``; min: the row where it is below fill), `fill` in the
    empty segments; rows with ids outside [0, M) are dropped."""
    k, c = scanned.shape
    last = torch.ones(k, dtype=torch.bool, device=scanned.device)
    torch.ne(sorted_ids[1:], sorted_ids[:-1], out=last[:-1])
    keep = last & (sorted_ids >= 0) & (sorted_ids < num_segments)
    out = torch.full((num_segments, c), float(fill), dtype=scanned.dtype, device=scanned.device)
    rows = scanned[keep]
    out[sorted_ids[keep]] = combine(torch.full_like(rows, float(fill)), rows, op)
    return out.t().contiguous() if channels_first else out


def place_live_plain(scanned, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    """`place_segments_plain` in live form: the nonempty segments'
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


LIVE_TILE = 512  # segments a live-placement tile covers (kLiveTile, csrc/binned_segment.cu)


@counted_bytes(lambda out, scanned, num_segments, **_: place_live_bytes(
    scanned.shape[0], int((out.slot >= 0).sum()), scanned.shape[1], int(num_segments)))
def place_live(scanned, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    """`place_live_plain`; on CUDA one cooperative launch of the live
    placement kernel, for at most `SCAN_CHANNELS` channels.  The table has
    min(K, M) columns (no host read of the nonempty count)."""
    if scanned.device.type == "cpu":
        return place_live_plain(scanned, sorted_ids, num_segments, op, fill)
    if scanned.device.type != "cuda":
        raise ValueError(f"place_live: unsupported device {scanned.device}")
    _check_rows("place_live", scanned, sorted_ids)
    k, c = scanned.shape
    m = int(num_segments)
    if sorted_ids.shape[0] != k:
        raise ValueError(f"place_live: {sorted_ids.shape[0]} ids for {k} rows")
    _check_extents("place_live", m, c)
    if c > SCAN_CHANNELS:
        raise ValueError(f"place_live: at most {SCAN_CHANNELS} channels, got {c}")
    cap = min(k, m)
    live = torch.empty((c, cap), dtype=scanned.dtype, device=scanned.device)
    slot = torch.empty((m,), dtype=torch.int32, device=scanned.device)
    work = torch.empty((2 * -(-m // LIVE_TILE) + 1,), dtype=torch.int64, device=scanned.device)  # tile starts, counts
    with cb.launching("place_live", scanned, sorted_ids) as stream:
        err = cb.LIB.get().pfs_binned_place_live(
            scanned.data_ptr(), sorted_ids.data_ptr(), k, m, c, int(op == "min"), float(fill),
            live.data_ptr(), cap, slot.data_ptr(), work.data_ptr(), work.numel(), stream,
        )
    cb.check(err, "binned_segment_place_live launch")
    place_live.launches += 1
    return LiveTable(live, slot, (m,), float(fill), tuple(range(c)))


place_live.launches = 0


def scan_reduce(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    """The scan route in live form: `seg_scan_sorted` of the rows, then
    `place_live`; the plain versions on the CPU."""
    return place_live(seg_scan_sorted(vals, segment_same(sorted_ids), op), sorted_ids, num_segments, op, fill)


def scan_reduce_plain(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0) -> LiveTable:
    return place_live_plain(seg_scan_sorted_plain(vals, segment_same(sorted_ids), op), sorted_ids, num_segments, op,
                            fill)


@counted_bytes(lambda out, table, sorted_ids: broadcast_bytes(sorted_ids.shape[0], used_rows(table, sorted_ids),
                                                            table.shape[1]))
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
    with cb.launching("segment_broadcast", table, sorted_ids) as stream:
        err = cb.LIB.get().pfs_binned_broadcast(
            table.data_ptr(), sorted_ids.data_ptr(), k, m, c, out.data_ptr(), stream,
        )
    cb.check(err, "binned_segment_broadcast launch")
    segment_broadcast.launches += 1
    return out


segment_broadcast.launches = 0
