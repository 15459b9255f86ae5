"""The scatter's live form (``ops/cuda_binned.py::LiveTable``: the nonempty
segments' columns and an int32 map over the segments) on the CPU: the live
placement (``place_live_plain``), the live fold (``ops/cuda_fold.py``'s
plain fold of a live table) and the index model of their two kernels
(``tests/live_table_model.py``), against the dense placement, the dense
fold and the JAX package's Pallas fold in interpret mode.

Tolerances: the placements and the port's folds bitwise (the live form
holds the dense table's values; -0.0 compared by its bits); the port's
fold against the Pallas kernel as ``tests/test_torch_coiling.py`` holds it
(add rtol 2e-6 / atol 2e-6, min bitwise).  The level-set family (125
channels, a table of the grid's own shape) is held against the JAX
package's ``fold_scattered_sep``, as that file does for E = N.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from live_table_model import LIVE_TILE, TILE, fold_boxes, fold_live_model, fold_live_targets, place_live_model
from python_fluid_simulation_tpu.ops.pallas_fold import fold_scattered_sep_pallas
from python_fluid_simulation_tpu.ops.scatter import fold_scattered_sep as j_fold
from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_fold, cuda_scan, levelset, scatter, transfers
from python_fluid_simulation_tpu_torch.solvers import density

torch.set_num_threads(1)

FOLD_TOL = dict(rtol=2e-6, atol=2e-6)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_bitwise(got, want, msg=""):
    assert got.shape == want.shape, msg
    assert torch.equal(_bits(got), _bits(want)), msg


def _assert_same_live(a, b):
    """Two live tables: equal maps and equal written columns, bitwise."""
    assert torch.equal(a.slot, b.slot) and a.grid_shape == b.grid_shape and a.channels == b.channels
    s = int((a.slot >= 0).sum())
    assert a.live.shape == b.live.shape and s <= a.live.shape[1]
    _assert_bitwise(a.live[:, :s], b.live[:, :s])


def _dense_reduce(vals, ids, m, op, fill):
    """The dense (C, M) table of the scan route: the scan, then the dense
    placement's plain version."""
    scanned = cuda_scan.seg_scan_sorted_plain(vals, cuda_binned.segment_same(ids), op)
    return cuda_binned.place_segments_plain(scanned, ids, m, op, fill, channels_first=True)


def _rows(kind, k=3000, c=7, m=5000, seed=0):
    """Sorted ids over M = 5000 segments (three placement tiles) and
    values: ``mixed`` has ids < 0 and >= M, empty segments and -0.0
    values; ``none`` no id in [0, M); ``all`` every segment nonempty."""
    rng = np.random.default_rng(seed)
    if kind == "all":
        ids = np.sort(np.concatenate([np.arange(m), rng.integers(0, m, k)]))
    elif kind == "none":
        ids = np.sort(np.concatenate([-1 - rng.integers(0, 9, k // 2), m + rng.integers(0, 9, k - k // 2)]))
    else:
        ids = np.sort(np.concatenate([rng.integers(-5, 0, 30), rng.integers(0, m, k - 60), m + rng.integers(0, 5, 30)]))
    vals = rng.standard_normal((ids.shape[0], c)).astype(np.float32)
    if kind == "mixed":
        lone = np.flatnonzero((ids >= 0) & (ids < m) & (np.r_[True, ids[1:] != ids[:-1]])
                              & (np.r_[ids[1:] != ids[:-1], True]))
        vals[lone[:5]] = -0.0  # one-row segments of -0.0: the add's fill + row is +0.0
    return torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(vals), m


@pytest.mark.parametrize("op,fill,kind", [
    ("add", 0.0, "mixed"), ("add", 1.5, "mixed"), ("min", 9.5, "mixed"), ("min", -0.25, "mixed"),
    ("add", 0.0, "none"), ("min", 9.5, "all"),
])
def test_live_placement_is_the_dense_placement(op, fill, kind):
    ids, vals, m = _rows(kind)
    scanned = cuda_scan.seg_scan_sorted_plain(vals, cuda_binned.segment_same(ids), op)
    live = cuda_binned.place_live_plain(scanned, ids, m, op, fill)
    dense = cuda_binned.place_segments_plain(scanned, ids, m, op, fill, channels_first=True)
    _assert_bitwise(live.dense(), dense)
    _assert_same_live(place_live_model(scanned, ids, m, op, fill), live)
    # the map: ascending columns over the nonempty in-range segments
    in_range = ids[(ids >= 0) & (ids < m)]
    nonempty = torch.unique(in_range)
    s = int((live.slot >= 0).sum())
    assert s == nonempty.numel() and live.live.shape == (vals.shape[1], min(ids.shape[0], m))
    assert torch.equal(live.slot[nonempty], torch.arange(s, dtype=torch.int32))
    assert {"none": s == 0, "all": s == m}.get(kind, 0 < s < m)
    if kind == "mixed" and op == "add" and fill == 0.0:
        zeros = vals[:, 0] == 0
        assert (torch.signbit(vals[:, 0]) & zeros).any() and not torch.signbit(live.live[:, :s]).logical_and(
            live.live[:, :s] == 0).any()
    # the whole live reduce, and the scatter entry point over a grid
    _assert_same_live(cuda_binned.scan_reduce_plain(vals, ids, m, op, fill), live)
    grid = scatter.segment_reduce_cf(vals, ids, m, (10, 25, 20), op, fill)
    assert grid.shape == (vals.shape[1], 10, 25, 20)
    _assert_bitwise(grid.dense(), dense.reshape(grid.shape))
    assert m > 2 * LIVE_TILE  # three tiles


# (name, axis_shifts, combine, fill, table extent beyond the grid, channel view)
FAMILIES = [
    ("levelset", [tuple(range(-2, 3))] * 3, "min", 3.0, 0, None),
    ("p2g_face", [(-1, 0), (-2, -1, 0), (-2, -1, 0)], "add", 0.0, 2, slice(0, None, 2)),
    ("p2g_322", [(-2, -1, 0), (-1, 0), (-1, 0)], "add", 0.0, 2, slice(1, None, 2)),
    ("density", [(-2, -1, 0)] * 3, "add", 0.0, 2, slice(1, None, 2)),
    ("volume_even", [(-1, 0)] * 3, "add", 0.0, 1, [0, 2, 6, 8, 18, 20, 24, 26]),
    ("volume_odd", [(-1,)] * 3, "add", 0.0, 2, [13]),
    ("volume_mixed", [(-1, 0), (-1,), (-1, 0)], "add", 0.0, 1, [3, 5, 21, 23]),
]


def _live_table(n_ch, view, grid, fill, seed, op):
    """A live table over `grid` whose nonempty cells fill one corner
    block (so some targets have no nonempty source), from sorted rows, and
    the dense placement of the same rows; both viewed as `view` selects."""
    rng = np.random.default_rng(seed)
    width = n_ch if view is None else (2 * n_ch if isinstance(view, slice) else 27)
    cells = np.stack(np.meshgrid(*[np.arange(max(1, n // 2)) for n in grid], indexing="ij"), -1).reshape(-1, 3)
    cells = cells[rng.random(len(cells)) < 0.4]
    flat = (cells[:, 0] * grid[1] + cells[:, 1]) * grid[2] + cells[:, 2]
    ids = np.sort(np.repeat(flat, rng.integers(1, 4, len(flat))))
    vals = rng.standard_normal((len(ids), width)).astype(np.float32)
    ids, vals = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(vals)
    m = int(np.prod(grid))
    live = cuda_binned.scan_reduce_plain(vals, ids, m, op, fill)
    live = dataclasses.replace(live, grid_shape=tuple(grid))
    dense = _dense_reduce(vals, ids, m, op, fill).reshape((width,) + tuple(grid))
    if view is not None:
        live, dense = live[view], dense[view]
    assert live.shape == dense.shape == (n_ch,) + tuple(grid)
    return live, dense


@pytest.mark.parametrize("family", [f[0] for f in FAMILIES])
def test_live_fold_matches_dense_fold_and_pallas(family):
    _, shifts, comb, fill, ext, view = next(f for f in FAMILIES if f[0] == family)
    n_ch = int(np.prod([len(s) for s in shifts]))
    op = "min" if comb == "min" else "add"
    before = cuda_fold.fold.launches
    # a multi-tile grid (3 x 2 x 2 target tiles) against the dense fold and the model
    big = (9, 10, 35)
    live, dense = _live_table(n_ch, view, tuple(n + ext for n in big), fill, 1, op)
    got = cuda_fold.fold(live, shifts, big, comb, fill)
    _assert_bitwise(got, cuda_fold.fold_plain(dense, shifts, big, comb, fill), family)
    _assert_bitwise(fold_live_model(live, shifts, big, comb, fill), got, family)
    flags = fold_live_targets(live, shifts, big)
    assert flags.any() and not flags.all()  # both kinds of target
    # the step's families stage at most 2 halo planes a side
    assert all(b <= t + 4 for b, t in zip(fold_boxes(live.grid_shape, shifts, big)[1], TILE))
    # a small grid against the JAX package
    small = (5, 6, 7)
    live, dense = _live_table(n_ch, view, tuple(n + ext for n in small), fill, 2, op)
    got = scatter.fold_scattered_sep(live, shifts, small, comb, fill).numpy()
    seg = jnp.asarray(dense.contiguous().numpy())
    if ext:
        want = np.asarray(fold_scattered_sep_pallas(seg, shifts, small, comb, fill, interpret=True))
    else:
        want = np.asarray(j_fold(seg, shifts, small, comb, fill))
    np.testing.assert_allclose(got, want, **FOLD_TOL, err_msg=family)
    if comb == "min":
        np.testing.assert_array_equal(got, want)
    assert cuda_fold.fold.launches == before  # the CPU runs the plain versions


@pytest.mark.parametrize("case", [
    # (N, E, shifts, combine, fill, table fill): edge tiles, shifts all below
    # zero, a table larger and smaller than the grid, no shortcut
    ((4, 8, 32), (4, 8, 32), [(-2, -1, 0, 1, 2)] * 3, "min", 1.0, 1.0),
    ((13, 17, 70), (15, 19, 72), [(-1,), (-1, 0), (-2, -1, 0)], "add", 0.0, 0.0),
    ((7, 9, 33), (5, 6, 30), [(-1, 0, 1)] * 3, "add", 0.0, 0.0),
    ((6, 9, 40), (8, 11, 42), [(-2, -1, 0)] * 3, "add", 0.5, 0.5),
    ((6, 9, 40), (6, 9, 40), [(-2, -1, 0, 1, 2)] * 3, "min", 2.0, 1.0),
])
def test_index_model_agrees_with_the_plain_fold(case):
    n, e, shifts, comb, fill, tfill = case
    n_ch = int(np.prod([len(s) for s in shifts]))
    live, _ = _live_table(n_ch, None, e, tfill, 3, "min" if comb == "min" else "add")
    assert fold_boxes(e, shifts, n)[2] <= 48 * 1024
    _assert_bitwise(fold_live_model(live, shifts, n, comb, fill), cuda_fold.fold_plain(live, shifts, n, comb, fill))
    assert cuda_fold.fold_shortcut(tfill, fill, comb) == (fill == tfill and (comb == "min" or fill == 0.0))


def _dense_reduce_cf(vals, sorted_ids, num_segments, grid_shape, op="add", fill=0.0):
    """The dense channels-first table the transfers folded before the
    live form."""
    out = _dense_reduce(vals.contiguous(), sorted_ids.contiguous(), num_segments, op, float(fill))
    return out.reshape((vals.shape[-1],) + tuple(grid_shape))


def _particles(seed, n=300, gres=(6, 7, 5)):
    rng = np.random.default_rng(seed)
    px = (rng.random((n, 3)) * np.array(gres) * 0.1 + np.array([-0.3, 0.0, -0.3])).astype(np.float32)
    pm = np.where(rng.random(n) < 0.05, 0.0, 1e-3).astype(np.float32)
    pv = rng.standard_normal((n, 3)).astype(np.float32)
    pc = rng.standard_normal((n, 3, 3)).astype(np.float32)
    return [torch.from_numpy(a) for a in (px, pm, pv, pc)]


@pytest.mark.parametrize("caller", ["p2g_all", "levelset", "volume_classes", "density"])
def test_step_callers_on_the_live_route_equal_the_dense_route(caller, monkeypatch):
    """The four callers fold live tables; their results are bitwise those
    of the dense tables they folded before."""
    px, pm, pv, pc = _particles(4)
    gres, bmin, h = (6, 7, 5), (-0.3, 0.0, -0.3), (0.1, 0.1, 0.1)
    bias = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))
    fshapes = [tuple(nn + (1 if i == a else 0) for i, nn in enumerate(gres)) for a in range(3)]
    fine = tuple(0.5 * x for x in h)
    run = {
        "p2g_all": lambda: transfers.p2g_all(px, pm, pv, pc, gres, fshapes, bias, bmin, h, volume=(1e-4, fine)),
        "levelset": lambda: (levelset.compute_fluid_levelset(px, gres, bmin, h, 0.1, pm=pm),),
        "volume_classes": lambda: levelset.compute_fluid_volume_classes(px, 1e-4, gres, bmin, fine, pm=pm),
        "density": lambda: density.scatter_mass_volume(px, pm, 1e-4, gres, bmin, h),
    }[caller]

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        if isinstance(out, dict):
            return [t for k in sorted(out) for t in flat(out[k])]
        return [t for o in out for t in flat(o)]

    got = flat(run())
    for mod in (scatter, transfers, levelset, density):
        monkeypatch.setattr(mod, "segment_reduce_cf", _dense_reduce_cf)
    want = flat(run())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _assert_bitwise(g, w, caller)


def test_live_wrappers_refuse_other_devices_and_ops():
    """The device routes (no knob): CPU tensors run the plain versions, a
    tensor on another device is refused."""
    ids, vals, m = _rows("mixed", k=400, m=60)
    counts = (cuda_binned.place_live.launches, cuda_scan.seg_scan_sorted.launches, cuda_fold.fold.launches)
    table = cuda_binned.scan_reduce(vals, ids, m, "min", 0.5)
    cuda_fold.fold(dataclasses.replace(table[:1], grid_shape=(3, 4, 5)), [(0,)] * 3, (3, 4, 5), "min", 0.5)
    assert (cuda_binned.place_live.launches, cuda_scan.seg_scan_sorted.launches, cuda_fold.fold.launches) == counts
    with pytest.raises(ValueError):
        cuda_binned.place_live(vals.to("meta"), ids, m)
    with pytest.raises(ValueError):
        cuda_binned.scan_reduce(vals, ids, m, op="max")
    meta = dataclasses.replace(table, live=table.live.to("meta"), slot=table.slot.to("meta"), grid_shape=(3, 4, 5))
    with pytest.raises(ValueError):
        cuda_fold.fold(meta[:1], [(0,)] * 3, (3, 4, 5), "min", 0.5)
