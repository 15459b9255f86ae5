"""The serial segment reduce (``ops/cuda_binned.py::serial_reduce``,
``csrc/binned_segment.cu``'s ``binned_reduce_kernel``) on the CPU: its
index model (``tests/serial_reduce_model.py``: tiles dealt to the blocks,
each tile's rows from two searches, the segments' first rows from a
marking pass, the lanes' row-order reduces, the staging and the writes)
against the plain version for ``min`` and against a row-order serial
fp32 sum for ``add``, bitwise, at 1, 3, 33, 125 and 320 channels, both
layouts, ``fill`` 0 and nonzero.  The rows hold negative ids and ids >= M
(dropped), tiles with no rows, a tile that holds one segment of 2,500
rows, and a last tile of 12 segments (the tile size read from the
source).  The JAX comparison of the plain
version is ``tests/test_torch_binned.py::
test_reduce_plain_matches_binned_kernel``.
"""

import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu_torch.ops import cuda_binned
from serial_reduce_model import BATCH, TILE, dealt_tiles, segment_starts, serial_reduce_model

torch.set_num_threads(1)

M = 9 * TILE + 12  # 10 tiles, the last of 12 segments
LONG_ID, LONG_ROWS = 4 * TILE + 12, 2500


def _rows(c, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([
        [-4, -4], np.full(7, -1),  # negative ids: dropped
        rng.integers(0, TILE, 200),  # tile 0, with empty segments; tiles 1-3 empty
        np.full(LONG_ROWS, LONG_ID), rng.integers(4 * TILE, 5 * TILE, 40),  # tile 4: one long segment
        rng.integers(5 * TILE, 7 * TILE, 300),  # tiles 5-6; tiles 7-8 empty
        rng.integers(9 * TILE, M, 30), [M - 1],  # the last, partial tile
        [M, M, M + 1, 50 * TILE],  # ids >= M: dropped
    ]).astype(np.int64)
    ids.sort()
    vals = rng.standard_normal((ids.size, c)).astype(np.float32)
    return torch.from_numpy(ids), torch.from_numpy(vals)


def _row_order_sum(ids, vals, m, fill):
    """fp32 sums, each segment's rows added one at a time in row order
    from fill."""
    ids, vals = ids.numpy(), vals.numpy()
    out = np.full((m, vals.shape[1]), np.float32(fill), np.float32)
    for i, s in enumerate(ids):
        if 0 <= s < m:
            out[s] = out[s] + vals[i]
    return torch.from_numpy(out)


def test_rows_cover_the_cases():
    ids, _ = _rows(1)
    tiles = set((ids[(ids >= 0) & (ids < M)] // TILE).tolist())
    assert {1, 2, 3, 7, 8}.isdisjoint(tiles) and {0, 4, 9} <= tiles and M % TILE == 12
    assert int((ids == LONG_ID).sum()) >= LONG_ROWS and (ids < 0).any() and (ids >= M).any()


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("fill", [0.0, 1.5])
@pytest.mark.parametrize("op", ["add", "min"])
@pytest.mark.parametrize("c", [1, 3, 33, 125, 320])
def test_model_is_the_plain_reduce(c, op, fill, channels_first):
    ids, vals = _rows(c, seed=c)
    got = serial_reduce_model(vals, ids, M, op, fill, channels_first)
    if op == "min":
        want = cuda_binned.segment_reduce_plain(vals, ids, M, op, fill, channels_first)
    else:
        want = _row_order_sum(ids, vals, M, fill)
        want = want.t().contiguous() if channels_first else want
    assert got.shape == want.shape
    assert torch.equal(got, want)
    # the wrapper on CPU tensors: the plain version, no launch
    launches = cuda_binned.serial_reduce.launches
    plain = cuda_binned.serial_reduce(vals, ids, M, op, fill, channels_first)
    assert cuda_binned.serial_reduce.launches == launches
    if op == "min":
        assert torch.equal(plain, want)


def test_min_lets_a_nan_through():
    ids, vals = _rows(33, seed=5)
    rows = [20, int((ids == LONG_ID).nonzero()[5]), int((ids >= 5 * TILE).nonzero()[0])]  # tiles 0, 4 and 5
    vals[rows] = float("nan")
    got = serial_reduce_model(vals, ids, M, "min", 0.0, True)
    want = cuda_binned.segment_reduce_plain(vals, ids, M, "min", 0.0, True)
    assert int(torch.isnan(got).sum()) == 3 * 33
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.parametrize("ntiles,grid", [(1, 1), (10, 3), (10, 16), (1000, 7), (190_000, 1056)])
def test_tiles_are_dealt_once_in_batches(ntiles, grid):
    dealt = dealt_tiles(ntiles, grid)
    assert sorted(t for mine in dealt for t in mine) == list(range(ntiles))
    for b, mine in enumerate(dealt):
        assert all(t % grid == b for t in mine) and mine == sorted(mine)
        assert len(mine) == len(range(b, ntiles, grid))
    assert BATCH * 2 == 256  # a search a thread, two a tile


def test_segment_starts_mark_every_segment_once():
    ids = [3, 3, 5, 5, 5, 9]  # segments 0-2 start at row 0, 4-5 at 2, 6-9 at 5, the end at 6
    assert segment_starts(ids, 0, 6, 0, 12) == [0, 0, 0, 0, 2, 2, 5, 5, 5, 5, 6, 6, 6]
    assert segment_starts([7, 8, 8, 31], 1, 4, 0, 32)[8:10] == [1, 3]
