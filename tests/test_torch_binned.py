"""The plain versions of the port's binned segment kernels
(``ops/cuda_binned.py``, ``csrc/binned_segment.cu``) against the JAX
package's Pallas kernels ``binned_segment_reduce`` and
``binned_segment_broadcast`` in interpret mode, on CPU.

Inputs (numpy, seeded) carry negative ids, padding dump rows with ids
>= M, empty segments, a segment of 409 rows that spans the TPU kernel's
2048-row chunks, and values above the min's fill.  Tolerances: min and
broadcast bitwise (no arithmetic, or an order-free min); sums atol 1e-4
on O(1) values of up to 409 rows (test_pallas.py's tolerance for the TPU
kernel against a float64 sum), against both the TPU kernel and a float64
sum: the TPU kernel adds a chunk-crossing segment as chunk partials, the
port adds every segment's rows in one pass in row order, and the two
differ by ~2e-5 on that segment.  ``segment_reduce`` takes the scan
route (its live form expanded) up to 256 channels, the serial kernel
above; both routes add in row order and agree bitwise
(tests/test_torch_scan.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops.pallas_binned import binned_segment_broadcast, binned_segment_reduce
from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_scan, scatter

torch.set_num_threads(1)

SUM_TOL = dict(atol=1e-4, rtol=0)


def _rows(seed, k=9000, c=30, m=5000):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, m, k))
    long = slice(2 * k // 9, 2 * k // 9 + k // 22)
    ids[long] = ids[long.start]  # a long segment (rows 2000-2408 at k = 9000, across row 2048)
    ids[:40] = -3 - np.arange(40)[::-1]  # negative ids, dropped
    ids[-100:] = m + 7 + np.arange(100)  # padding dump rows
    ids = np.sort(ids).astype(np.int64)
    vals = rng.standard_normal((k, c)).astype(np.float32)
    assert len(np.unique(ids[(ids >= 0) & (ids < m)])) < m  # some segments are empty
    return ids, vals, m


def _numpy_reduce(ids, vals, m, op, fill):
    live = (ids >= 0) & (ids < m)
    ref = np.full((m, vals.shape[1]), fill, np.float64)
    if op == "add":
        np.add.at(ref, ids[live], vals[live].astype(np.float64))
    else:
        np.minimum.at(ref, ids[live], vals[live].astype(np.float64))
    return ref


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("op,fill", [("add", 0.0), ("min", 0.5)])
def test_reduce_plain_matches_binned_kernel(op, fill, channels_first):
    ids, vals, m = _rows(7)
    counts = (cuda_binned.serial_reduce, cuda_scan.seg_scan_sorted, cuda_binned.place_live)
    before = [w.launches for w in counts]
    got = cuda_binned.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), m, op, fill, channels_first)
    assert [w.launches for w in counts] == before  # the CPU runs the plain versions
    want = np.asarray(binned_segment_reduce(
        jnp.asarray(vals), jnp.asarray(ids.astype(np.int32)), m, op=op, fill=fill,
        interpret=True, channels_first=channels_first,
    ))
    ref = _numpy_reduce(ids, vals, m, op, fill)
    if channels_first:
        ref = ref.T
    assert got.shape == want.shape == ref.shape
    if op == "min":
        # values straddle the fill, so the clamp shows
        assert (ref < fill).any() and (vals.min(axis=0) < fill).all()
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))
    else:
        np.testing.assert_allclose(got.numpy(), want, **SUM_TOL)
        np.testing.assert_allclose(got.numpy(), ref, **SUM_TOL)


def test_broadcast_plain_matches_binned_kernel():
    ids, _, m = _rows(11, c=54)
    table = np.random.default_rng(12).standard_normal((m, 54)).astype(np.float32)
    before = cuda_binned.segment_broadcast.launches
    got = cuda_binned.segment_broadcast(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    assert cuda_binned.segment_broadcast.launches == before
    want = np.asarray(binned_segment_broadcast(jnp.asarray(table), jnp.asarray(ids.astype(np.int32)), interpret=True))
    ref = np.zeros((ids.shape[0], 54), np.float32)
    live = (ids >= 0) & (ids < m)
    ref[live] = table[ids[live]]
    # the JAX kernel reads negative ids as rows of the first tile; the
    # contract (and the port) reads them as 0
    np.testing.assert_array_equal(got[live], want[live])
    np.testing.assert_array_equal(got, ref)


def test_scatter_entry_points_route_through_the_wrappers():
    """``ops/scatter.py`` keeps its contracts on top of the wrappers:
    (K,) and (K, C) rows, channels-first grids (in live form, expanded by
    ``dense()``), tables of any width."""
    ids, vals, m = _rows(3, k=600, c=8, m=40)
    t_ids, t_vals = torch.from_numpy(ids), torch.from_numpy(vals)
    np.testing.assert_allclose(scatter.segment_sum_sorted(t_vals[:, 2], t_ids, m).numpy(),
                               _numpy_reduce(ids, vals, m, "add", 0.0)[:, 2], **SUM_TOL)
    np.testing.assert_array_equal(scatter.segment_min_sorted(t_vals, t_ids, m, 0.25).numpy(),
                                  _numpy_reduce(ids, vals, m, "min", 0.25).astype(np.float32))
    cf = scatter.segment_reduce_cf(t_vals, t_ids, m, (5, 8), "min", 0.25)
    assert cf.shape == (8, 5, 8)
    np.testing.assert_array_equal(cf.dense().reshape(8, m).t().numpy(),
                                  scatter.segment_min_sorted(t_vals, t_ids, m, 0.25).numpy())
    table = torch.from_numpy(vals[:m, :3].copy())
    b = scatter.segment_broadcast_sorted(table[:, 1], t_ids)
    assert b.shape == (600,)
    live = (ids >= 0) & (ids < m)
    np.testing.assert_array_equal(b.numpy()[live], vals[:m, 1][ids[live]])
    assert (b.numpy()[~live] == 0).all()


def test_wrappers_refuse_other_devices_and_dtypes():
    ids, vals, m = _rows(5, k=600, c=4, m=40)
    with pytest.raises(ValueError):
        cuda_binned.segment_reduce(torch.from_numpy(vals).to("meta"), torch.from_numpy(ids), m)
    with pytest.raises(ValueError):
        cuda_binned.segment_broadcast(torch.from_numpy(vals).to("meta"), torch.from_numpy(ids))
    with pytest.raises(ValueError):
        cuda_binned.segment_reduce(torch.from_numpy(vals), torch.from_numpy(ids), m, op="max")
