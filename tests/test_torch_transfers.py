"""The PyTorch port's scatter, transfer and level-set modules against the
JAX package (and, for the segment ops, a numpy loop), on CPU.

Tolerances: the port sums each segment exactly in row order while the
JAX package's CPU route takes differences of a running cumsum, so
scattered sums agree to fp32 rounding of the running total (~1e-6
relative to the largest entry); gathers and minima are exact or within
a few ulp.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from python_fluid_simulation_tpu.ops import levelset as jls
from python_fluid_simulation_tpu.ops import transfers as jtr
from python_fluid_simulation_tpu_torch.ops import levelset, scatter, transfers

torch.set_num_threads(1)

GRES = (6, 7, 5)
BMIN = (-0.3, 0.0, -0.3)
H = (0.1, 0.1, 0.1)
FACE_BIAS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))
FSHAPES = [tuple(n + (1 if i == a else 0) for i, n in enumerate(GRES)) for a in range(3)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def _segments(seed, k=300, m=40, c=5):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(-4, m + 4, k)).astype(np.int64)  # some outside [0, M)
    vals = rng.standard_normal((k, c)).astype(np.float32)
    return ids, vals, m


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sum_min_broadcast_match_numpy(seed):
    ids, vals, m = _segments(seed)
    fill = 0.25
    want_sum = np.zeros((m, vals.shape[1]), np.float64)
    want_min = np.full((m, vals.shape[1]), fill, np.float32)
    for i, s in enumerate(ids):
        if 0 <= s < m:
            want_sum[s] += vals[i]
            want_min[s] = np.minimum(want_min[s], vals[i])
    np.testing.assert_allclose(scatter.segment_sum_sorted(_t(vals), _t(ids), m).numpy(), want_sum, atol=1e-5)
    np.testing.assert_array_equal(scatter.segment_min_sorted(_t(vals), _t(ids), m, fill).numpy(), want_min)
    np.testing.assert_allclose(scatter.segment_sum_sorted(_t(vals[:, 0]), _t(ids), m).numpy(), want_sum[:, 0], atol=1e-5)
    table = np.random.default_rng(seed + 10).standard_normal((m, 3)).astype(np.float32)
    out = scatter.segment_broadcast_sorted(_t(table), _t(ids)).numpy()
    for i, s in enumerate(ids):
        np.testing.assert_array_equal(out[i], table[s] if 0 <= s < m else 0.0)
    assert (ids < 0).any() and (ids >= m).any()


def test_sort_is_stable_and_unsort_inverts():
    ids = torch.tensor([3, 1, 3, 0, 1, 3])
    sorted_ids, rows = scatter.sort_by_segment(ids, torch.arange(6))
    assert sorted_ids.tolist() == [0, 1, 1, 3, 3, 3]
    assert rows.tolist() == [3, 1, 4, 0, 2, 5]
    vals = torch.randn(6, 2)
    _, order = torch.sort(ids, stable=True)
    np.testing.assert_array_equal(scatter.unsort_rows(vals[order], order).numpy(), vals.numpy())


def _particles(seed, n=400, zero_mass=0):
    rng = np.random.default_rng(seed)
    lo = np.asarray(BMIN) + 0.5 * np.asarray(H)
    hi = np.asarray(BMIN) + (np.asarray(GRES) - 0.5) * np.asarray(H)
    px = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    pm = rng.uniform(0.5, 1.5, n).astype(np.float32) * 1e-3
    pm[:zero_mass] = 0.0
    pv = rng.standard_normal((n, 3)).astype(np.float32)
    pc = rng.standard_normal((n, 3, 3)).astype(np.float32)
    return px, pm, pv, pc


@pytest.mark.parametrize("mass_floor", [0.0, 1e-7])
def test_p2g_all_matches_jax(mass_floor):
    px, pm, pv, pc = _particles(5, zero_mass=7)
    volume = (0.05**3, (0.05, 0.05, 0.05))
    gm_t, gv_t, vol_t, _ = transfers.p2g_all(
        _t(px), _t(pm), _t(pv), _t(pc), GRES, FSHAPES, FACE_BIAS, BMIN, H,
        volume=volume, with_sort_info=True, mass_floor=mass_floor,
    )
    gm_j, gv_j, vol_j, _ = jtr.p2g_all(
        *map(jnp.asarray, (px, pm, pv, pc)), GRES, FSHAPES, FACE_BIAS, BMIN, H,
        volume=volume, with_sort_info=True, mass_floor=mass_floor,
    )
    for a in range(3):
        assert tuple(gm_t[a].shape) == FSHAPES[a]
        _close(gm_t[a].numpy(), gm_j[a])
        # velocities divide momentum by mass, which scales the sums'
        # rounding up by the momentum/mass ratio: 1e-4 of the largest
        _close(gv_t[a].numpy(), gv_j[a], rel=1e-4)
    assert set(vol_t) == set(vol_j)
    for k in vol_j:
        _close(vol_t[k].numpy(), vol_j[k])


def test_g2p_all_matches_jax():
    px, pm, pv, pc = _particles(6)
    rng = np.random.default_rng(7)
    gvs = [rng.standard_normal(s).astype(np.float32) for s in FSHAPES]
    si_t = transfers.make_sort_info(_t(px), _t(pm), GRES, BMIN, H)
    si_j = jtr.make_sort_info(jnp.asarray(px), jnp.asarray(pm), GRES, BMIN, H)
    np.testing.assert_array_equal(si_t.sorted_ids.numpy(), np.asarray(si_j.sorted_ids))
    v_t, c_t = transfers.g2p_all([_t(g) for g in gvs], GRES, FACE_BIAS, BMIN, H, si_t)
    v_j, c_j = jtr.g2p_all([jnp.asarray(g) for g in gvs], GRES, FACE_BIAS, BMIN, H, si_j)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)  # gradients carry 1/h = 10


@pytest.mark.parametrize("shared_sort", [False, True])
def test_fluid_levelset_matches_jax(shared_sort):
    px, pm, _, _ = _particles(8, n=150, zero_mass=5)
    gdx = H[0]
    si_t = transfers.make_sort_info(_t(px), _t(pm), GRES, BMIN, H) if shared_sort else None
    si_j = jtr.make_sort_info(jnp.asarray(px), jnp.asarray(pm), GRES, BMIN, H) if shared_sort else None
    got = levelset.compute_fluid_levelset(_t(px), GRES, BMIN, H, gdx, pm=_t(pm), sort_info=si_t)
    want = jls.compute_fluid_levelset(jnp.asarray(px), GRES, BMIN, H, gdx, pm=jnp.asarray(pm), sort_info=si_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got.max()) <= 3.0 * gdx + 1e-7 and float(got.min()) < 0  # clamped at the background


def test_fluid_volume_classes_match_jax():
    px, pm, _, _ = _particles(9, zero_mass=3)
    fine = tuple(0.5 * h for h in H)
    got = levelset.compute_fluid_volume_classes(_t(px), 0.05**3, GRES, BMIN, fine, pm=_t(pm))
    want = jls.compute_fluid_volume_classes(jnp.asarray(px), 0.05**3, GRES, BMIN, fine, pm=jnp.asarray(pm))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k])
