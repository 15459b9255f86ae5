"""A model of the index logic of ``csrc/binned_segment.cu``'s serial reduce
(``binned_reduce_kernel``, the route of ``ops/cuda_binned.py::
serial_reduce``), over torch tensors on any device:

* tiles of kTile segments dealt to the grid's blocks, kBatch at a time
  (`dealt_tiles`);
* each tile's rows [lo, hi) from two binary searches (lower bounds of its
  first segment and of the next tile's, clamped at M);
* the segments' first rows from one marking pass over the tile's rows
  (`segment_starts`: row i writes the starts of segments (id[i - 1],
  id[i]], the tile's last row the end of the rest);
* per channel group of kGroup, the units (segment, 32-channel group), a
  lane a channel, reducing the segment's rows in row order from ``fill``
  (add rounds every add, min clamps at fill and lets a NaN through);
* the staging at ``stage[cc * (kTile + 1) + s]`` and the writes along
  segments (channels-first) or channels (row-major); a tile with no rows
  writes ``fill``.

The constants are read from the source.  tests/test_torch_serial_reduce.py
holds the model against the plain version and a row-order serial sum on
the CPU.  The model imports no JAX.
"""

import re

import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build


_SOURCE = (_cuda_build.SRC_DIR / "binned_segment.cu").read_text()


def _const(name):
    return int(re.search(rf"\b{name} = (\d+);", _SOURCE).group(1))


THREADS = _const("kThreads")
TILE = _const("kTile")
GROUP = _const("kGroup")
assert "kBatch = kThreads / 2;" in _SOURCE
BATCH = THREADS // 2  # a search a thread, two a tile


def dealt_tiles(ntiles: int, grid: int):
    """Block b's tiles in the order it takes them: batches of BATCH tiles
    b + j * grid, the next batch from b + grid * BATCH."""
    out = []
    for b in range(grid):
        mine = []
        for first in range(b, ntiles, grid * BATCH):
            mine += [t for t in (first + j * grid for j in range(BATCH)) if t < ntiles]
        out.append(mine)
    return out


def tile_rows(sorted_ids, m: int, t: int):
    """Tile t's rows [lo, hi): the lower bounds of t * kTile and of
    min((t + 1) * kTile, M)."""
    bounds = torch.tensor([t * TILE, min((t + 1) * TILE, m)], dtype=sorted_ids.dtype, device=sorted_ids.device)
    lo, hi = torch.searchsorted(sorted_ids, bounds).tolist()
    return lo, hi


def segment_starts(ids, lo: int, hi: int, m0: int, nseg: int):
    """The marking pass: start[s] the first row of segment m0 + s, start[nseg]
    = hi.  Every entry is written exactly once."""
    start = [None] * (nseg + 1)

    def mark(s, i):
        assert start[s] is None, f"start[{s}] written twice"
        start[s] = i

    for i in range(lo, hi):  # a thread a row: the writes are disjoint
        cur = ids[i] - m0
        prev = -1 if i == lo else ids[i - 1] - m0
        for s in range(prev + 1, cur + 1):
            mark(s, i)
        if i == hi - 1:
            for s in range(cur + 1, nseg + 1):
                mark(s, hi)
    assert None not in start
    return start


def _step(op, acc, v):
    if op == "add":
        return acc + v  # fp32, rounded every add: __fadd_rn
    return torch.where(torch.isnan(v) | (v < acc), v, acc)


def serial_reduce_model(vals, sorted_ids, num_segments: int, op: str = "add", fill: float = 0.0,
                        channels_first: bool = False, grid: int = 3):
    """The kernel on `grid` blocks: (M, C), or (C, M) with channels_first."""
    k, c = vals.shape
    m = int(num_segments)
    dev = vals.device
    ids = sorted_ids.tolist()
    out = torch.empty((m * c,), dtype=vals.dtype, device=dev)
    written = torch.zeros((m * c,), dtype=torch.int64, device=dev)

    def put(idx, v):  # idx: distinct entries
        out[idx] = v
        written[idx] += 1

    ld = TILE + 1
    ntiles = -(-m // TILE)
    dealt = dealt_tiles(ntiles, grid)
    assert sorted(t for mine in dealt for t in mine) == list(range(ntiles))
    for t in (t for mine in dealt for t in mine):
        m0 = t * TILE
        nseg = min(TILE, m - m0)
        lo, hi = tile_rows(sorted_ids, m, t)
        lane = torch.arange(nseg, device=dev)
        if lo == hi:  # fill only
            if channels_first:
                idx = (torch.arange(c, device=dev)[:, None] * m + m0 + lane).reshape(-1)
            else:
                idx = m0 * c + torch.arange(nseg * c, device=dev)
            put(idx, fill)
            continue
        start = torch.tensor(segment_starts(ids, lo, hi, m0, nseg), device=dev)
        for c0 in range(0, c, GROUP):
            g = min(GROUP, c - c0)
            nch = -(-g // 32)
            # units: warp-strided u -> (s, 32-channel group), a lane a channel
            u = torch.arange(nseg * nch, device=dev)
            s_of, cc_of = u // nch, ((u % nch) * 32)[:, None] + torch.arange(32, device=dev)
            keep = cc_of < g
            pairs = torch.stack([s_of[:, None].expand_as(cc_of)[keep], cc_of[keep]], 1)
            assert pairs.shape[0] == nseg * g and torch.unique(pairs[:, 0] * g + pairs[:, 1]).numel() == nseg * g
            lens = start[1:] - start[:-1]
            acc = torch.full((nseg, g), float(fill), dtype=vals.dtype, device=dev)
            for r in range(int(lens.max())):  # row order within every segment
                live = r < lens
                acc[live] = _step(op, acc[live], vals[start[:-1][live] + r, c0:c0 + g])
            stage = torch.empty((GROUP * ld,), dtype=vals.dtype, device=dev)
            ccs = torch.arange(g, device=dev)
            stage[(ccs[None, :] * ld + lane[:, None]).reshape(-1)] = acc.reshape(-1)
            if channels_first:  # a warp a channel, its lanes along the segments
                dst = (c0 + ccs[:, None]) * m + m0 + lane[None, :]
                src = ccs[:, None] * ld + lane[None, :]
            else:  # a warp a segment, lanes along its channels
                dst = (m0 + lane[:, None]) * c + c0 + ccs[None, :]
                src = ccs[None, :] * ld + lane[:, None]
            put(dst.reshape(-1), stage[src.reshape(-1)])
    assert bool((written == 1).all()), "an output entry written other than once"
    return out.reshape((c, m) if channels_first else (m, c))
