"""The scan route of the port's segmented reduce (rows 11 and 13 of the
kernel table: ``ops/cuda_scan.py::seg_scan_sorted``, ``csrc/seg_scan.cu``,
and ``ops/cuda_binned.py::scan_reduce`` / ``place_live``) against the
JAX package on CPU, and the channel limit that routes ``segment_reduce``.

* The scan's plain version against ``pallas_segscan.seg_scan_sorted(...,
  interpret=True)`` (tests/test_scatter.py's inputs: K = 2 * 2048 + 513
  rows with one segment longer than the TPU block), add and min,
  C in {3, 54, 125}.  Tolerances: min bitwise (order-free); add rtol 2e-6
  and atol 2e-6 of max |value|: the JAX kernel adds a 128-row tile as a
  masked matmul and carries across blocks, the port adds in row order.
* The scan route (scan, then the live placement, expanded) against the JAX
  ``binned_segment_reduce`` with ``PFS_SCAN_REDUCE=1`` (interpret mode,
  tests/test_pallas.py's K 9000, C 54, M 5000 with a segment across the
  TPU kernel's 2048-row chunks), both layouts, add and min with fill 9.5,
  ids outside [0, M).  Same tolerances.
* The scan route against the serial route in the port: bitwise (both add
  in row order; fill = 0 for add, as every add caller passes).
* The route by width, and one flagship step on the scan route against the
  exact-sum JAX step (tests/test_torch_flagship.py's recipe and bounds) and
  against the same step on the serial route's dense tables.
* ``scaled_buckling_config(256)`` against the JAX config.  The JAX scene
  at that size seeds 2.9M particles in ~35 s on the CPU, so the particle
  count is checked on the card (chip_smoke.py), not here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu.ops.pallas_binned import binned_segment_reduce
from python_fluid_simulation_tpu.ops.pallas_segscan import _BLOCK, seg_scan_sorted
from python_fluid_simulation_tpu_torch.convert import state_from_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, scaled_buckling_config
from python_fluid_simulation_tpu_torch.engine.step import simulate
from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_scan, levelset, scatter, transfers
from python_fluid_simulation_tpu_torch.solvers import density

torch.set_num_threads(1)

STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)
ADD_RTOL = 2e-6
ADD_ATOL_OF_MAX = 2e-6


def _assert_add_close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=ADD_RTOL, atol=ADD_ATOL_OF_MAX * np.abs(want).max(), err_msg=msg)


def _launch_counts():
    return (cuda_binned.serial_reduce.launches, cuda_scan.seg_scan_sorted.launches,
            cuda_binned.place_live.launches)


def _segscan_rows(c):
    rng = np.random.default_rng(7)
    k = 2 * _BLOCK + 513
    seg_lens = [1, 3, _BLOCK + 700, 2, 1]
    while sum(seg_lens) < k:
        seg_lens.append(int(rng.integers(1, 9)))
    seg_lens[-1] -= sum(seg_lens) - k
    ids = np.repeat(np.arange(len(seg_lens)), seg_lens)[:k]
    same = np.concatenate([[False], ids[1:] == ids[:-1]])
    vals = np.random.default_rng(100 + c).standard_normal((k, c)).astype(np.float32)
    return vals, same


@pytest.mark.parametrize("c", [3, 54, 125])
@pytest.mark.parametrize("op", ["add", "min"])
def test_seg_scan_matches_pallas_interpret(op, c):
    vals, same = _segscan_rows(c)
    before = _launch_counts()
    got = cuda_scan.seg_scan_sorted(torch.from_numpy(vals), torch.from_numpy(same), op).numpy()
    assert _launch_counts() == before  # the CPU runs the plain version
    want = np.asarray(seg_scan_sorted(jnp.asarray(vals), jnp.asarray(same), op, interpret=True))
    assert got.shape == want.shape == vals.shape
    if op == "min":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_add_close(got, want, f"c={c}")
    # rows of a segment's start are the rows themselves
    np.testing.assert_array_equal(got[~same], vals[~same])


def _dense(table, channels_first):
    """A live table's dense expansion in the layout asked for."""
    out = table.dense()
    return out if channels_first else out.t().contiguous()


def _reduce_rows(seed=9, k=9000, c=54, m=5000):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, m, k))
    a, b = 19 * k // 90, 26 * k // 90
    ids[a:b] = ids[a]  # a long segment (rows 1900-2599 at k = 9000: across the TPU kernel's 2048-row chunk)
    ids[:k // 300] = -4 - np.arange(k // 300)[::-1]  # negative ids, dropped
    ids[-(k // 150):] = m + 3 + np.arange(k // 150)  # ids >= M, dropped
    ids = np.sort(ids).astype(np.int64)
    vals = rng.standard_normal((k, c)).astype(np.float32)
    return ids, vals, m


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("op,fill", [("add", 0.0), ("min", 9.5)])
def test_scan_reduce_matches_pallas_scan_mode(op, fill, channels_first, monkeypatch):
    ids, vals, m = _reduce_rows()
    before = _launch_counts()
    got = _dense(cuda_binned.scan_reduce(torch.from_numpy(vals), torch.from_numpy(ids), m, op, fill),
                 channels_first).numpy()
    assert _launch_counts() == before
    monkeypatch.setenv("PFS_SCAN_REDUCE", "1")
    binned_segment_reduce._clear_cache()  # the switch is read when the function is traced
    try:
        want = np.asarray(binned_segment_reduce(jnp.asarray(vals), jnp.asarray(ids.astype(np.int32)), m, op=op,
                                                fill=fill, interpret=True, channels_first=channels_first))
    finally:
        binned_segment_reduce._clear_cache()
    assert got.shape == want.shape == ((vals.shape[1], m) if channels_first else (m, vals.shape[1]))
    if op == "min":
        assert (want < fill).any() and (want == fill).any()  # the clamp and the empty segments show
        np.testing.assert_array_equal(got, want)
    else:
        _assert_add_close(got, want)


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("op,fill", [("add", 0.0), ("min", 9.5), ("min", -0.25)])
def test_scan_route_is_bitwise_the_serial_route(op, fill, channels_first):
    ids, vals, m = _reduce_rows(seed=4, c=27)
    vals[5, 3] = -0.0
    args = (torch.from_numpy(vals), torch.from_numpy(ids), m, op, fill)
    scan, serial = _dense(cuda_binned.scan_reduce(*args), channels_first), cuda_binned.serial_reduce(*args, channels_first)
    assert torch.equal(scan, serial)
    assert torch.equal(_dense(cuda_binned.scan_reduce_plain(*args), channels_first), scan)
    assert torch.equal(cuda_binned.segment_reduce(*args, channels_first), scan)


def test_scan_route_adds_to_a_nonzero_fill():
    """``add`` adds the segment's sum to fill (the serial route adds the
    rows to it one by one: equal to fp32 rounding)."""
    ids, vals, m = _reduce_rows(seed=5, c=8)
    args = (torch.from_numpy(vals), torch.from_numpy(ids), m, "add", 1.5)
    scan, serial = _dense(cuda_binned.scan_reduce(*args), False).numpy(), cuda_binned.serial_reduce(*args).numpy()
    assert (scan == 1.5).any()
    _assert_add_close(scan, serial)


def test_placement_writes_each_segments_last_row():
    ids = torch.tensor([-2, 0, 0, 2, 2, 2, 5, 7], dtype=torch.int64)
    scanned = torch.arange(8, dtype=torch.float32)[:, None].repeat(1, 2)
    out = cuda_binned.place_live(scanned, ids, 6, "add", 0.0)
    np.testing.assert_array_equal(out.slot.numpy(), [0, -1, 1, -1, -1, 2])
    np.testing.assert_array_equal(out.live[0, :3].numpy(), [2, 5, 6])
    np.testing.assert_array_equal(out.dense()[0].numpy(), [2, 0, 5, 0, 0, 6])
    out = cuda_binned.place_live(scanned, ids, 6, "min", 4.0)
    np.testing.assert_array_equal(out.dense()[1].numpy(), [2, 4, 4, 4, 4, 4])
    np.testing.assert_array_equal(out.dense().numpy(), cuda_binned.place_segments_plain(scanned, ids, 6, "min", 4.0,
                                                                                         channels_first=True).numpy())


def _taken(monkeypatch):
    """Record which reduce route each call takes."""
    taken = []
    for name in ("scan_reduce", "serial_reduce"):
        fn = getattr(cuda_binned, name)
        monkeypatch.setattr(cuda_binned, name, lambda *a, _fn=fn, _n=name, **kw: taken.append(_n) or _fn(*a, **kw))
    return taken


def test_gate_is_a_function_of_shapes(monkeypatch):
    """Every reduce of the measured steps fits the scan route, the only
    one that writes the live form (C <= 256: the level-set min's 125, the
    density scatter's 54, P2G's 135 with the volumes); on the dense
    contract only rows wider than the scan kernels take (C > 256) go to
    the serial kernel."""
    assert max(125, 54, 135) <= cuda_binned.SCAN_CHANNELS == cuda_scan.MAX_CHANNELS == 256
    taken = _taken(monkeypatch)
    ids = torch.tensor([0, 0, 1, 3], dtype=torch.int64)
    for c in (cuda_scan.MAX_CHANNELS, cuda_scan.MAX_CHANNELS + 1):
        out = cuda_binned.segment_reduce(torch.ones(4, c), ids, 4)
        assert out.shape == (4, c) and out[:, 0].tolist() == [2, 1, 0, 1]
    assert taken == ["scan_reduce", "serial_reduce"]


def test_segment_reduce_takes_the_gated_route(monkeypatch):
    """CPU tensors take the same route by width and run that route's plain
    version; the two routes give the same minima."""
    ids, vals, m = _reduce_rows(seed=6, k=600, c=cuda_scan.MAX_CHANNELS + 1, m=40)
    taken = _taken(monkeypatch)
    t_vals, t_ids = torch.from_numpy(vals), torch.from_numpy(ids)
    a = scatter.segment_min_sorted(t_vals[:, :5].contiguous(), t_ids, m, 0.5)
    b = scatter.segment_min_sorted(t_vals, t_ids, m, 0.5)
    assert taken == ["scan_reduce", "serial_reduce"]
    assert torch.equal(a, b[:, :5])


def test_scan_wrappers_refuse_other_devices_and_ops():
    vals, same = torch.zeros(8, 3), torch.zeros(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        cuda_scan.seg_scan_sorted(vals.to("meta"), same)
    with pytest.raises(ValueError):
        cuda_scan.seg_scan_sorted(vals, same, op="max")
    with pytest.raises(ValueError):
        cuda_binned.place_live(vals.to("meta"), torch.zeros(8, dtype=torch.int64), 4)


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


def _serial_reduce_cf(vals, sorted_ids, num_segments, grid_shape, op="add", fill=0.0):
    out = cuda_binned.serial_reduce(vals.contiguous(), sorted_ids.contiguous(), num_segments, op, float(fill), True)
    return out.reshape((vals.shape[-1],) + tuple(grid_shape))


def test_flagship_step_on_the_scan_route_matches_exact_sum_jax(monkeypatch):
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    jax.clear_caches()  # no step traced before the patch may be reused
    try:
        j_state = j_scene(j_cfg())
        j_final, j_metrics = j_simulate(j_state, j_cfg(), 1)
        j_final = jax.device_get(j_final)
    finally:
        jax.clear_caches()
    start = {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx,
    }
    state = state_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu")
    with monkeypatch.context() as mp:
        # the same step on the serial route's dense tables (the fold takes either form)
        for mod in (scatter, transfers, levelset, density):
            mp.setattr(mod, "segment_reduce_cf", _serial_reduce_cf)
        serial_final, _ = simulate(state, buckling_config(), 1)
    scans = []
    scan_reduce = scatter.scan_reduce
    monkeypatch.setattr(scatter, "scan_reduce", lambda *a, **kw: scans.append(a[0].shape) or scan_reduce(*a, **kw))
    final, metrics = simulate(state, buckling_config(), 1)
    # every reduce of the step: two level-set mins, the density scatter, P2G with the volumes
    assert sorted(s[1] for s in scans) == [54, 125, 125, 135]
    for solver in ("density", "viscosity", "pressure"):
        np.testing.assert_array_equal(metrics[f"{solver}_iters"].numpy(), np.asarray(j_metrics[f"{solver}_iters"]))
        assert metrics[f"{solver}_converged"].all()
    for k, tol in STEP_TOL.items():
        np.testing.assert_allclose(getattr(final.particles, k).numpy(), np.asarray(getattr(j_final.particles, k)),
                                   atol=tol, err_msg=k)
        # both routes add in row order: the step does not depend on the route
        assert torch.equal(getattr(final.particles, k), getattr(serial_final.particles, k)), k


def test_scaled_buckling_256_config_matches_jax():
    from python_fluid_simulation_tpu.engine.scenes import scaled_buckling_config as j_scaled

    got, want = scaled_buckling_config(256), j_scaled(256)
    assert got.grid.res == want.grid.res == (154, 256, 154)
    assert got.grid.dx == want.grid.dx == 1.0 / 256 and got.particle_dx == want.particle_dx == 0.5 / 256
    assert dataclasses.asdict(got.solver) == dataclasses.asdict(want.solver)
    assert (got.solver.precond, got.solver.viscosity_precond, got.solver.max_iter) == ("jacobi", "jacobi", 600)
