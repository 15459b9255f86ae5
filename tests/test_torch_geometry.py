"""The PyTorch port's geometry modules against the JAX package, on CPU.

indexing, sdf (evaluate / project) and fractions: the same numpy inputs
go through both packages.  These are elementwise ops on the same fp32
formulas, so most comparisons are exact or within a few ulp (atol 1e-6
on O(1) values).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from python_fluid_simulation_tpu.ops import fractions as jfr
from python_fluid_simulation_tpu.ops import indexing as jix
from python_fluid_simulation_tpu.ops import sdf as jsdf
from python_fluid_simulation_tpu.engine.scenes import buckling_rigid_bodies as jbodies
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_rigid_bodies
from python_fluid_simulation_tpu_torch.ops import fractions, indexing, sdf

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, -2, 0), (-3, 4, 7), (5, 0, -6)])
def test_shift_and_sample_match(offsets):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 6, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        indexing.shift(_t(a), offsets, -2.0).numpy(), np.asarray(jix.shift(jnp.asarray(a), offsets, -2.0))
    )
    target = (4, 8, 6)
    np.testing.assert_array_equal(
        indexing.sample(_t(a), offsets, target, 1.5).numpy(),
        np.asarray(jix.sample(jnp.asarray(a), offsets, target, 1.5)),
    )


def test_parity_split_merge_and_dual_sample():
    rng = np.random.default_rng(1)
    dual = rng.standard_normal((9, 11, 13)).astype(np.float32)
    cls_t = indexing.split_parity(_t(dual), 3)
    cls_j = jix.split_parity(jnp.asarray(dual), 3)
    assert set(cls_t) == set(cls_j)
    for k in cls_j:
        np.testing.assert_array_equal(cls_t[k].numpy(), np.asarray(cls_j[k]))
        assert cls_t[k].is_contiguous()
    np.testing.assert_array_equal(indexing.merge_parity(cls_t, dual.shape).numpy(), dual)
    shape = (4, 5, 7)
    for base in (indexing.P3_XFACE, indexing.P3_CENTER, indexing.P3_NODE):
        for off in ((0, 0, 0), (2, -1, 1), (-1, 1, -2)):
            np.testing.assert_array_equal(
                indexing.dual_sample(cls_t, base, off, shape, -1.0).numpy(),
                np.asarray(jix.dual_sample(cls_j, base, off, shape, -1.0)),
            )
            np.testing.assert_array_equal(
                indexing.dual_sample(_t(dual), base, off, shape, 0.0).numpy(),
                np.asarray(jix.dual_sample(jnp.asarray(dual), base, off, shape, 0.0)),
            )


def test_grid_positions_interior_and_face_parity():
    args = ((5, 4, 6), (-0.3, 0.0, -0.3), (0.1, 0.05, 0.2), (0.5, 0.0, 0.5))
    np.testing.assert_array_equal(
        indexing.grid_positions(*args, device="cpu").numpy(), np.asarray(jix.grid_positions(*args))
    )
    for hi in (None, (4, 3, 5)):
        np.testing.assert_array_equal(
            indexing.interior_mask((5, 4, 6), hi).numpy(), np.asarray(jix.interior_mask((5, 4, 6), hi))
        )
    for a in range(3):
        assert indexing.face_parity(a, 3) == jix.face_parity(a, 3)


def _tables():
    """Buckling funnel plus one body of every kind, flipped and not."""
    t_set, j_set = buckling_rigid_bodies(), jbodies()
    extra = [
        ("ball", "sphere", [0.2], dict(center=[0.1, 0.3, -0.1], velocity=[0.0, -1.0, 0.5])),
        ("bowl", "sphere", [0.6], dict(flip=True, center=[0.0, 0.4, 0.0])),
        ("post", "cylinder", [0.1, 0.5], dict(center=[-0.1, 0.2, 0.1], axis=[1, 0, 1], angle=30)),
        ("tube", "cylinder", [0.45, 1.2], dict(flip=True, center=[0.0, 0.5, 0.0])),
    ]
    for name, kind, params, kw in extra:
        t_set.add(name, kind, params, **kw)
        j_set.add(name, kind, params, **kw)
    return t_set.table(device="cpu"), j_set.table()


def test_rigid_body_table_matches():
    t_tab, j_tab = _tables()
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))


def test_sdf_evaluate_and_project_match():
    t_tab, j_tab = _tables()
    rng = np.random.default_rng(2)
    pts = rng.uniform([-0.4, -0.1, -0.4], [0.4, 1.1, 0.4], (4000, 3)).astype(np.float32)
    sd_t, vel_t = sdf.evaluate(t_tab, _t(pts))
    sd_j, vel_j = jsdf.evaluate(j_tab, jnp.asarray(pts))
    np.testing.assert_allclose(sd_t.numpy(), np.asarray(sd_j), atol=1e-6)
    np.testing.assert_allclose(vel_t.numpy(), np.asarray(vel_j), atol=1e-6)
    # one body kind at a time, so the JAX package's static dispatch and
    # the port's where-combined evaluation see the same table
    for i in range(t_tab.shape[0]):
        got = sdf.project(t_tab[i : i + 1], _t(pts)).numpy()
        want = np.asarray(jsdf.project(j_tab[i : i + 1], jnp.asarray(pts)))
        np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(
        sdf.project(t_tab, _t(pts)).numpy(), np.asarray(jsdf.project(j_tab, jnp.asarray(pts))), atol=1e-6
    )


@pytest.mark.parametrize("split", [False, True])
def test_solid_fractions_match(split):
    rng = np.random.default_rng(3)
    sphi = rng.standard_normal((13, 15, 11)).astype(np.float32)
    src_t = indexing.split_parity(_t(sphi), 3) if split else _t(sphi)
    src_j = jix.split_parity(jnp.asarray(sphi), 3) if split else jnp.asarray(sphi)
    for w_t, w_j in zip(fractions.compute_solid_frac_3d(src_t), jfr.compute_solid_frac_3d(src_j)):
        assert tuple(w_t.shape) == tuple(w_j.shape)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)


def test_edge_and_tri_fractions_match():
    rng = np.random.default_rng(4)
    v = [rng.standard_normal(500).astype(np.float32) for _ in range(3)]
    v[1][:50] = v[0][:50]  # equal endpoints: the zero-difference guard
    np.testing.assert_allclose(
        fractions.edge_in_fraction(_t(v[0]), _t(v[1])).numpy(),
        np.asarray(jfr.edge_in_fraction(jnp.asarray(v[0]), jnp.asarray(v[1]))),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        fractions.tri_in_fraction(*map(_t, v)).numpy(),
        np.asarray(jfr.tri_in_fraction(*map(jnp.asarray, v))),
        atol=1e-6,
    )
