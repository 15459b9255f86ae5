"""The port's seven unit APIs against their JAX functions, on the CPU, as
the JAX package's own tests call them (``test_fieldops.py:52-91``,
``test_density.py:82``, ``test_scatter.py:91,137``,
``test_bucketed.py:143``, ``test_transfers.py``).

Tolerances, each relative to the largest entry of the JAX result:
* ``channels_first``: bitwise (a reshape);
* the gathers (``g2p_axis``, ``apply_displacement``),
  ``extrapolate_velocities`` and ``fold_scattered``: 1e-6;
* the scatters (``p2g_axis``, ``compute_fluid_volume``): the JAX side
  sums with ``jax.ops.segment_sum`` in place of its CPU route of
  ``segment_sum_sorted`` (differences of one running cumsum, whose
  rounding grows with the row count), as ``test_torch_flagship.py``
  does; both then add each segment's rows in row order, and agree to
  1e-6.
The port's ``compute_fluid_volume_classes`` is the parity split of its
``compute_fluid_volume`` within JAX's own tolerance for its pair
(``test_fluid_volume_classes_match_dense``: rtol 1e-4, atol 1e-9; the
two fold different channel sets, so the order of the sums differs: 1.5e-6
of the largest entry at one node here).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import extrapolate as j_extrapolate
from python_fluid_simulation_tpu.ops import levelset as j_levelset
from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu.ops import transfers as j_transfers
from python_fluid_simulation_tpu.solvers import density as j_density
from python_fluid_simulation_tpu_torch.ops import extrapolate, levelset, scatter, transfers
from python_fluid_simulation_tpu_torch.ops.indexing import split_parity
from python_fluid_simulation_tpu_torch.solvers import density

torch.set_num_threads(1)

REL = 1e-6
GRES = (16, 9, 7)
BMIN = (-0.3, 0.0, -0.2)
H = (0.05, 0.05, 0.05)
BIAS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))
FSH = [tuple(n + (1 if i == a else 0) for i, n in enumerate(GRES)) for a in range(3)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape, got.dtype, want.dtype)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


def _particles(k=3000, seed=5, margin=1e-4):
    """Positions over the whole domain (as ``test_bucketed.py``), random
    velocities, affine rows and masses, and a tenth of them zero-mass
    padding."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(BMIN[a] + margin, BMIN[a] + GRES[a] * H[a] - margin, k) for a in range(3)], -1)
    v = rng.normal(size=(k, 3))
    c = rng.normal(size=(k, 3, 3))
    m = (rng.random(k) + 0.5) * (rng.random(k) > 0.1)
    return tuple(a.astype(np.float32) for a in (x, v, c, m))


def test_channels_first_matches_jax():
    seg = np.random.default_rng(0).standard_normal((8 * 9 * 7, 5)).astype(np.float32)
    got = scatter.channels_first(_t(seg), (8, 9, 7))
    want = np.asarray(j_scatter.channels_first(jnp.asarray(seg), (8, 9, 7)))
    np.testing.assert_array_equal(got.numpy(), want)


FOLD_CASES = [
    # test_scatter.py:91: an arbitrary shift list, add
    ([(0, 0, 0), (1, 0, 0), (0, -1, 0), (1, 1, -1)], (6, 6, 6), (6, 6, 6), "add", 0.0),
    # test_scatter.py:137's three Cartesian cases, min with a fill and add
    (list(itertools.product(*[(-2, -1, 0, 1, 2)] * 3)), (8, 9, 7), (6, 7, 5), "min", 3.0),
    (list(itertools.product((-2, -1, 0), (-2, -1, 0), (-1, 0))), (8, 9, 7), (6, 7, 5), "add", 0.0),
    (list(itertools.product((-1, 0), (-1,), (-1, 0))), (8, 9, 7), (7, 6, 5), "add", 0.0),
]


@pytest.mark.parametrize("case", range(len(FOLD_CASES)))
def test_fold_scattered_matches_jax(case):
    shifts, ext, out_shape, comb, fill = FOLD_CASES[case]
    seg = np.random.default_rng(4 + case).standard_normal((len(shifts),) + ext).astype(np.float32)
    got = scatter.fold_scattered(_t(seg), shifts, out_shape, comb, fill)
    want = j_scatter.fold_scattered(jnp.asarray(seg), shifts, out_shape, comb, fill)
    _close(got, want)
    if case:  # a Cartesian set: the separable fold is the same function
        axis_shifts = [sorted({s[a] for s in shifts}) for a in range(3)]
        _close(got, scatter.fold_scattered_sep(_t(seg), axis_shifts, out_shape, comb, fill).numpy())


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_p2g_axis_matches_jax(axis, monkeypatch):
    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    x, v, c, m = _particles(seed=5 + axis)
    args = (axis, GRES, FSH[axis], BIAS[axis], BMIN, H)
    gm, gv = transfers.p2g_axis(_t(x), _t(m), _t(v), _t(c[:, axis]), *args)
    jm, jv = j_transfers.p2g_axis(*(jnp.asarray(a) for a in (x, m, v, c[:, axis])), *args)
    _close(gm, jm)
    _close(gv, jv)
    # mass is conserved (test_transfers.py::test_p2g_mass_conservation)
    np.testing.assert_allclose(float(gm.sum()), float(m.sum()), rtol=1e-5)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_g2p_axis_matches_jax(axis):
    x, _, _, _ = _particles(seed=6)
    # beyond the domain too: the clamp to gres - 1 reads the border
    x = np.concatenate([x, np.asarray([[BMIN[a] - 0.01 for a in range(3)],
                                       [BMIN[a] + GRES[a] * H[a] + 0.01 for a in range(3)]], np.float32)])
    gv = np.random.default_rng(7 + axis).normal(size=FSH[axis]).astype(np.float32)
    args = (axis, GRES, BIAS[axis], BMIN, H)
    pv, pc = transfers.g2p_axis(_t(x), _t(gv), *args)
    jv, jc = j_transfers.g2p_axis(jnp.asarray(x), jnp.asarray(gv), *args)
    _close(pv, jv)
    _close(pc, jc)


def test_compute_fluid_volume_matches_jax_and_its_parity_split(monkeypatch):
    """test_fieldops.py:62-91's inputs: in-domain particles, ones exactly
    on the domain bounds, and zero-mass padding."""
    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    rng = np.random.default_rng(3)
    gres = (6, 9, 7)
    bmin = (-0.2, 0.0, 0.1)
    fine_h = (0.025,) * 3
    dual = tuple(2 * n + 1 for n in gres)
    ext = np.asarray([n * 0.05 for n in gres])
    px = np.concatenate([np.asarray(bmin) + rng.random((400, 3)) * ext, [bmin], [np.asarray(bmin) + ext]])
    px = px.astype(np.float32)
    pm = (rng.random(px.shape[0]) > 0.1).astype(np.float32)
    pvol = 1.3e-5
    got = levelset.compute_fluid_volume(_t(px), pvol, dual, bmin, fine_h, pm=_t(pm))
    want = j_levelset.compute_fluid_volume(jnp.asarray(px), pvol, dual, bmin, fine_h, pm=jnp.asarray(pm))
    _close(got, want)
    classes = levelset.compute_fluid_volume_classes(_t(px), pvol, gres, bmin, fine_h, pm=_t(pm))
    split = split_parity(got, 3)
    assert set(classes) == set(split)
    for p in split:
        np.testing.assert_allclose(classes[p].numpy(), split[p].numpy(), rtol=1e-4, atol=1e-9)
    # a heavy clump is clamped at the fine cell volume (test_fieldops.py:55-58)
    clump = levelset.compute_fluid_volume(torch.full((500, 3), 0.5), 1e-3, (17, 17, 17), (0.0,) * 3, (0.0625,) * 3)
    assert float(clump.max()) <= 0.0625**3 + 1e-9


def test_extrapolate_velocities_matches_jax():
    rng = np.random.default_rng(11)
    vs = [rng.normal(size=s).astype(np.float32) for s in FSH]
    valids = [rng.random(s) > 0.7 for s in FSH]
    got_v, got_valid = extrapolate.extrapolate_velocities([_t(v) for v in vs], [_t(m) for m in valids], 2)
    want_v, want_valid = j_extrapolate.extrapolate_velocities(
        [jnp.asarray(v) for v in vs], [jnp.asarray(m) for m in valids], 2)
    assert len(got_v) == len(got_valid) == 3
    for a in range(3):
        _close(got_v[a], want_v[a])
        np.testing.assert_array_equal(got_valid[a].numpy(), np.asarray(want_valid[a]))


def test_apply_displacement_matches_jax():
    """test_bucketed.py:166-168's call, with particles past the domain's
    last face too: the gather clamps to the face array dims."""
    x, _, _, _ = _particles(seed=12)
    x = np.concatenate([x, np.asarray([[BMIN[a] + GRES[a] * H[a] + 0.02 for a in range(3)]], np.float32)])
    rng = np.random.default_rng(13)
    disp = [(rng.normal(size=s) * 0.01).astype(np.float32) for s in FSH]
    got = density.apply_displacement(_t(x), [_t(d) for d in disp], BMIN, H)
    want = j_density.apply_displacement(jnp.asarray(x), [jnp.asarray(d) for d in disp], BMIN, H)
    _close(got, want)
    # a zero field moves nothing (test_density.py:82)
    still = density.apply_displacement(_t(x), [torch.zeros(s) for s in FSH], BMIN, H)
    np.testing.assert_array_equal(still.numpy(), x)
