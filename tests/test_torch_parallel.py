"""The PyTorch port's ``parallel/`` modules against the JAX package's, on
CPU.

The port runs on ``make_mesh(4, "cpu")`` / ``make_mesh2d((2, 2), "cpu")``
(four slots on one device), the JAX package on ``make_mesh(4)`` /
``make_mesh2d((2, 2))`` of the 8 virtual CPU devices, from the same
numpy inputs (``numpy.random.default_rng``).  Tolerances are the JAX
package's own parallel tests' (``tests/test_parallel.py``):

* ``halo_exchange``, widths 1 and 2, array axes 0 and 2, on both meshes:
  bitwise against the ``ppermute`` route (16x1 over the slots, :27);
* ``halo_exchange_rdma``'s plain version: bitwise against the Pallas
  kernel in interpret mode on 32x6x5 with ``check_vma=False`` (:517-543);
* ``psum_dot``: rtol 1e-5 (:84-85);
* ``sharded_pressure_matvec``: rtol 1e-5, atol 1e-5 (:68);
* the distributed cell PCG on a dividing extent (:285), a non-dividing
  one (:194) and the (2, 2) mesh (:428): x rtol 2e-3 / atol 2e-4
  (:234-235, :323-324, :468-469), iterations within 2 of the JAX
  distributed solve (:322, :467);
* the coupled viscosity solve through ``distributed_coupled_cg``, 1D and
  (2, 2): rtol 5e-3 / atol 5e-4, iterations within 3 (:275-281,
  :507-513);
* the solver options under a mesh against the JAX functions on the same
  system: the dt-scaled cell solve with ``precond="mg"`` (ignored under a
  mesh) and the unpreconditioned one at the cell tolerances, the
  unpreconditioned viscosity solve (from 'auto' with its MG flag set,
  also ignored) at the viscosity tolerances.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from python_fluid_simulation_tpu.ops.fractions import compute_solid_frac_3d as j_frac
from python_fluid_simulation_tpu.parallel import halo as jhalo
from python_fluid_simulation_tpu.parallel import mesh as jmesh
from python_fluid_simulation_tpu.solvers import pressure as jpr
from python_fluid_simulation_tpu.solvers import viscosity as jvis
from python_fluid_simulation_tpu_torch.parallel import halo, halo_rdma, mesh
from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)

SOLVE_TOL = dict(rtol=2e-3, atol=2e-4)
VISC_TOL = dict(rtol=5e-3, atol=5e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _shapes(n):
    return [tuple(k + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]


def _meshes(kind):
    if kind == "1d":
        return jmesh.make_mesh(4), mesh.make_mesh(4, "cpu")
    return jmesh.make_mesh2d((2, 2)), mesh.make_mesh2d((2, 2), "cpu")


def _port_apply(m, fn, a, spec):
    """fn over the slot blocks of global `a` (split by `spec`), gathered."""
    return mesh.gather_blocks(m, fn(mesh.split_blocks(m, _t(a), spec)), spec).numpy()


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("kind,axis_name,array_axis", [
    ("1d", "x", 0), ("1d", "x", 2), ("2d", "x", 0), ("2d", "z", 2),
])
def test_halo_exchange_matches_ppermute(kind, axis_name, array_axis, width):
    jm, pm = _meshes(kind)
    rng = np.random.default_rng(0)
    if kind == "1d":
        shape = (16, 1) if array_axis == 0 else (1, 1, 16)
        spec = ("x", None) if array_axis == 0 else (None, None, "x")
    else:
        shape, spec = (16, 1, 16), ("x", None, "z")
    x = rng.standard_normal(shape).astype(np.float32)
    want = shard_map(
        lambda a: jhalo.halo_exchange(a, axis_name, width, array_axis), mesh=jm, in_specs=P(*spec),
        out_specs=P(*spec),
    )(jnp.asarray(x))
    got = _port_apply(pm, lambda b: halo.halo_exchange(pm, b, axis_name, width, array_axis), x, spec)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_halo_exchange_roundtrip_values():
    """tests/test_parallel.py::test_halo_exchange_roundtrip on four slots:
    slot i owns rows [4i, 4i + 4), framed by rows 4i - 1 and 4i + 4."""
    pm = mesh.make_mesh(4, "cpu")
    x = torch.arange(16, dtype=torch.float32).reshape(16, 1)
    out = halo.halo_exchange(pm, mesh.split_blocks(pm, x), "x", 1)
    for i, o in enumerate(out):
        col = o[:, 0].tolist()
        assert col[0] == (4 * i - 1 if i > 0 else 0.0)
        assert col[1:5] == [4 * i + k for k in range(4)]
        assert col[5] == (4 * i + 4 if i < 3 else 0.0)


def test_rdma_plain_matches_pallas_interpret():
    from python_fluid_simulation_tpu.parallel.halo_rdma import halo_exchange_rdma as j_rdma

    jm, pm = _meshes("1d")
    x = np.random.default_rng(0).standard_normal((32, 6, 5)).astype(np.float32)
    want = shard_map(lambda a: j_rdma(a, "x"), mesh=jm, in_specs=P("x"), out_specs=P("x"), check_vma=False)(
        jnp.asarray(x))
    spec = ("x", None, None)
    launches = halo_rdma.halo_exchange_rdma.launches
    got = _port_apply(pm, lambda b: halo_rdma.halo_exchange_rdma(pm, b, "x"), x, spec)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the route halo_exchange takes at width 1 on axis 0 gives the same
    route = _port_apply(pm, lambda b: halo.halo_exchange(pm, b, "x", 1, 0), x, spec)
    np.testing.assert_array_equal(route, got)
    assert halo_rdma.halo_exchange_rdma.launches == launches  # CPU blocks launch nothing


def test_rdma_plain_on_2d_mesh_rings():
    """On a (2, 2) mesh the x exchange runs one ring a z position."""
    pm = mesh.make_mesh2d((2, 2), "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 3, 6)).astype(np.float32))
    spec = ("x", None, "z")
    got = mesh.gather_blocks(pm, halo_rdma.halo_exchange_rdma_plain(pm, mesh.split_blocks(pm, x, spec), "x"), spec)
    want = mesh.gather_blocks(pm, halo.halo_exchange(pm, mesh.split_blocks(pm, x, spec), "x", 1, 0), spec)
    assert torch.equal(got, want)
    assert pm.rings("x") == [[0, 2], [1, 3]] and pm.rings("z") == [[0, 1], [2, 3]]


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_psum_dot_matches_jax(kind):
    jm, pm = _meshes(kind)
    rng = np.random.default_rng(2)
    shape = (16, 4) if kind == "1d" else (16, 3, 8)
    spec = ("x", None) if kind == "1d" else ("x", None, "z")
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    names = tuple(jm.axis_names)
    want = shard_map(lambda x, y: jhalo.psum_dot(x, y, names), mesh=jm, in_specs=(P(*spec), P(*spec)),
                     out_specs=P())(jnp.asarray(a), jnp.asarray(b))
    got = halo.psum_dot(mesh.split_blocks(pm, _t(a), spec), mesh.split_blocks(pm, _t(b), spec))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(np.vdot(a.astype(np.float64), b)), rtol=1e-5)


def test_sharded_pressure_matvec_matches_jax():
    n = (16, 8, 8)
    rng = np.random.default_rng(0)
    sphi = rng.standard_normal(tuple(2 * k + 1 for k in n)).astype(np.float32)
    lphi = rng.standard_normal(n).astype(np.float32)
    w = [np.asarray(f) for f in j_frac(jnp.asarray(sphi))]
    p = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    jm, pm = _meshes("1d")
    want = np.asarray(jhalo.sharded_pressure_matvec(jm, tuple(jnp.asarray(f) for f in w), jnp.asarray(lphi))(
        jnp.asarray(p)))
    got = halo.sharded_pressure_matvec(pm, tuple(_t(f) for f in w), _t(lphi))(_t(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle = halo.sharded_pressure_matvec_interior_oracle(tuple(_t(f) for f in w), _t(lphi))(_t(p)).numpy()
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


def _cell_system(nn, seed, fluid):
    """test_parallel.py's distributed-PCG systems: no solid, a fluid box,
    random face velocities; (b, diag, coefs, pd) from the JAX package."""
    rng = np.random.default_rng(seed)
    dual = tuple(2 * k + 1 for k in nn)
    lphi = np.ones(nn, np.float32)
    lphi[fluid] = -1.0
    w = j_frac(jnp.ones(dual, jnp.float32))
    v = tuple(jnp.asarray(rng.standard_normal(s).astype(np.float32)) for s in _shapes(nn))
    b = jpr.pressure_rhs_3d(v, jnp.zeros(dual + (3,), jnp.float32), jnp.asarray(lphi), w, (0.1,) * 3)
    diag, coefs, pd = jpr.pressure_coefficients(w, jnp.asarray(lphi))
    return b, diag, coefs, pd


@pytest.mark.parametrize("case", ["dividing", "nondividing", "mesh2d"])
def test_distributed_cell_poisson_matches_jax(case):
    nn, seed, fluid, kind = {
        "dividing": ((16, 8, 8), 3, np.s_[2:-2, 2:-3, 2:-2], "1d"),
        "nondividing": ((11, 8, 7), 7, np.s_[2:-2, 2:-2, 2:-2], "1d"),
        "mesh2d": ((10, 8, 7), 5, np.s_[2:-2, 2:-3, 2:-2], "2d"),
    }[case]
    jm, pm = _meshes(kind)
    b, diag, coefs, pd = _cell_system(nn, seed, fluid)
    kw = dict(tol=1e-5, rel_tol=1e-5, max_iter=800)
    x_j, it_j, _ = jhalo.sharded_cell_poisson_cg(jm, b, diag, coefs, pd, **kw)
    x, it, res = halo.sharded_cell_poisson_cg(pm, _t(b), _t(diag), [(off, _t(c)) for off, c in coefs], _t(pd), **kw)
    assert tuple(x.shape) == nn and int(it) > 0
    assert abs(int(it) - int(it_j)) <= 2, (int(it), int(it_j))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), **SOLVE_TOL)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_distributed_coupled_cg_matches_jax(kind):
    nn = (10, 8, 7)  # non-dividing x extent (faces: 11), and z (7)
    jm, pm = _meshes(kind)
    rng = np.random.default_rng(11)
    dual = tuple(2 * k + 1 for k in nn)
    sphi = rng.standard_normal(dual).astype(np.float32) + 0.5
    lvol = np.abs(rng.standard_normal(dual)).astype(np.float32) * 1e-4
    v = [rng.standard_normal(s).astype(np.float32) for s in _shapes(nn)]
    kw = dict(tol=1e-6, rel_tol=1e-6, max_iter=400)
    want = jvis.viscosity_solve_3d(1.0 / 60, 1.0, 1000.0, tuple(jnp.asarray(a) for a in v), jnp.asarray(sphi),
                                   jnp.asarray(lvol), 0.1**3, mesh=jm, use_pallas="off", **kw)
    got = viscosity.viscosity_solve_3d(1.0 / 60, 1.0, 1000.0, tuple(_t(a) for a in v), _t(sphi), _t(lvol), 0.1**3,
                                       mesh=pm, **kw)
    assert int(got.stats.iters) > 0 and bool(got.stats.converged)
    assert abs(int(got.stats.iters) - int(want.stats.iters)) <= 3, (int(got.stats.iters), int(want.stats.iters))
    for a in range(3):
        np.testing.assert_allclose(got.v_faces[a].numpy(), np.asarray(want.v_faces[a]), **VISC_TOL)


def test_mesh_helpers():
    m = mesh.make_mesh(4)
    assert [d.type for d in m.devices] == ["cuda"] * 4 and m.shape == {"x": 4}  # slots default to the card
    m2 = mesh.make_mesh2d((2, 2))
    assert m2.axis_names == ("x", "z") and m2.size == 4 and m2.devices[3].type == "cuda"
    assert mesh.spatial_axes(m2) == [("x", 0), ("z", 2)] and mesh.grid_pspec(m2, 4) == ("x", None, "z", None)
    pm = mesh.make_mesh2d((2, 2), "cpu")
    a = torch.from_numpy(np.random.default_rng(4).standard_normal((6, 3, 4, 3)).astype(np.float32))
    blocks = mesh.split_blocks(pm, a)
    assert [tuple(b.shape) for b in blocks] == [(3, 3, 2, 3)] * 4 and all(b.is_contiguous() for b in blocks)
    assert torch.equal(blocks[1], a[:3, :, 2:]) and torch.equal(blocks[2], a[3:, :, :2])
    assert torch.equal(mesh.gather_blocks(pm, blocks), a)
    with pytest.raises(ValueError):
        mesh.split_blocks(pm, a[:5])
    with pytest.raises(ValueError):
        mesh.Mesh(["cpu"] * 3, ("x", "z"), (2, 2))


@pytest.mark.parametrize("case", ["dt_scaled_mg_ignored", "unpreconditioned"])
def test_cell_solve_options_under_a_mesh_match_jax(case):
    """``solve_cell_poisson(mesh=)`` takes the distributed solve whatever
    the preconditioner (JAX ``pressure.py:330``), with s b, s diag, s coef,
    s pd, and pd = 1 under ``jacobi_precond=False``; held against the JAX
    function on the same system at the distributed-PCG tolerances."""
    jm, pm = _meshes("1d")
    nn = (16, 8, 8)
    rng = np.random.default_rng(3)
    dual = tuple(2 * k + 1 for k in nn)
    lphi = np.ones(nn, np.float32)
    lphi[2:-2, 2:-3, 2:-2] = -1.0
    w = j_frac(jnp.ones(dual, jnp.float32))
    v = tuple(jnp.asarray(rng.standard_normal(s).astype(np.float32)) for s in _shapes(nn))
    b = jpr.pressure_rhs_3d(v, jnp.zeros(dual + (3,), jnp.float32), jnp.asarray(lphi), w, (0.1,) * 3)
    diag, coefs, pd = jpr.pressure_coefficients(w, jnp.asarray(lphi))
    opts = dict(dt_scale=1.0 / 60, jacobi_precond=True) if case == "dt_scaled_mg_ignored" else dict(jacobi_precond=False)
    kw = dict(tol=1e-5, rel_tol=1e-5, max_iter=800)
    x_j, st_j = jpr.solve_cell_poisson(b, w, jnp.asarray(lphi), mesh=jm, precond_kind="mg", **opts, **kw)
    s = opts.get("dt_scale")
    x, st = pressure.solve_cell_poisson(
        _t(b), (_t(diag), [(off, _t(c)) for off, c in coefs], _t(pd)), precond="mg", mesh=pm,
        jacobi_precond=opts["jacobi_precond"], dt_scale=None if s is None else torch.tensor(s, dtype=torch.float32), **kw)
    assert bool(st.converged) and int(st.iters) > 0
    assert abs(int(st.iters) - int(st_j.iters)) <= 2, (int(st.iters), int(st_j.iters))
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), **SOLVE_TOL)


def test_viscosity_unpreconditioned_under_a_mesh_matches_jax():
    nn = (10, 8, 7)
    jm, pm = _meshes("1d")
    rng = np.random.default_rng(11)
    dual = tuple(2 * k + 1 for k in nn)
    sphi = rng.standard_normal(dual).astype(np.float32) + 0.5
    lvol = np.abs(rng.standard_normal(dual)).astype(np.float32) * 1e-4
    v = [rng.standard_normal(s).astype(np.float32) for s in _shapes(nn)]
    kw = dict(tol=1e-6, rel_tol=1e-6, max_iter=400, jacobi_precond=False)
    want = jvis.viscosity_solve_3d(1.0 / 60, 1.0, 1000.0, tuple(jnp.asarray(a) for a in v), jnp.asarray(sphi),
                                   jnp.asarray(lvol), 0.1**3, mesh=jm, use_pallas="off", **kw)
    got = viscosity.viscosity_solve_3d(1.0 / 60, 1.0, 1000.0, tuple(_t(a) for a in v), _t(sphi), _t(lvol), 0.1**3,
                                       mesh=pm, precond_kind="auto", auto_use_mg=torch.tensor(True), **kw)
    assert abs(int(got.stats.iters) - int(want.stats.iters)) <= 3, (int(got.stats.iters), int(want.stats.iters))
    for a in range(3):
        np.testing.assert_allclose(got.v_faces[a].numpy(), np.asarray(want.v_faces[a]), **VISC_TOL)
