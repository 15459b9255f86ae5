"""The PyTorch port's solvers and the plain versions of its two CUDA
kernels against the JAX package, on CPU.

* cell-Poisson PCG (plain version of csrc/poisson_pcg.cu) vs the
  JAX Pallas kernel ``make_stencil_cg`` (interpret mode on CPU) and the
  JAX XLA route (``use_pallas="off"``): solution rtol 2e-3 / atol 2e-4,
  iterations within 2 — the tolerances of test_pallas.py's fused-CG
  test; dots associate in a different order, so counts may shift by one.
* coupled viscosity PCG (plain version of csrc/coupled_visc_pcg.cu) vs
  ``make_fused_coupled_cg_geom(interpret=True)``: matvec rtol 1e-5 /
  atol 1e-6 (same fp32 products, ~1 ulp), solve as above.
* pressure / density / viscosity solves vs the JAX functions on the
  same inputs; the pressure and density solves also with
  ``precond="mg"`` against the JAX package's MG-PCG route.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from python_fluid_simulation_tpu.ops.fractions import compute_solid_frac_3d as j_frac
from python_fluid_simulation_tpu.ops.indexing import split_parity as j_split
from python_fluid_simulation_tpu.solvers import density as jden
from python_fluid_simulation_tpu.solvers import pressure as jpr
from python_fluid_simulation_tpu.solvers import viscosity as jvis
from python_fluid_simulation_tpu_torch.config import GridConfig3D, PhysicsConfig, SimConfig, SolverConfig
from python_fluid_simulation_tpu_torch.engine.scenes import dam_break_scene
from python_fluid_simulation_tpu_torch.ops import cuda_cg, cuda_stencils
from python_fluid_simulation_tpu_torch.ops.fractions import compute_solid_frac_3d
from python_fluid_simulation_tpu_torch.ops.indexing import split_parity
from python_fluid_simulation_tpu_torch.solvers import density, pressure, viscosity

torch.set_num_threads(1)

SOLVE_TOL = dict(rtol=2e-3, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _shapes(n):
    return [tuple(k + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]


def _cell_system(seed=5, n=(8, 10, 12)):
    """test_pallas.py's fused-CG system: random solids, half-fluid cells."""
    rng = np.random.default_rng(seed)
    dual = tuple(2 * k + 1 for k in n)
    sphi = rng.standard_normal(dual).astype(np.float32)
    lphi = np.where(np.random.default_rng(seed + 1).random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    v = [rng.standard_normal(s).astype(np.float32) for s in _shapes(n)]
    return sphi, lphi, v


def test_cell_poisson_plain_matches_stencil_cg_and_xla():
    from python_fluid_simulation_tpu.ops.pallas_stencils import make_stencil_cg

    sphi, lphi, v = _cell_system()
    w_j = j_frac(jnp.asarray(sphi))
    sv = np.zeros(sphi.shape + (3,), np.float32)
    b = np.asarray(jpr.pressure_rhs_3d([jnp.asarray(x) for x in v], jnp.asarray(sv), jnp.asarray(lphi), w_j, (0.1,) * 3))
    w_t = compute_solid_frac_3d(_t(sphi))
    b_t = pressure.pressure_rhs_3d([_t(x) for x in v], _t(sv), _t(lphi), w_t, (0.1,) * 3)
    np.testing.assert_allclose(b_t.numpy(), b, atol=1e-5)

    diag_t, coefs_t, pd_t = pressure.pressure_coefficients(w_t, _t(lphi))
    diag_j, coefs_j, pd_j = jpr.pressure_coefficients(w_j, jnp.asarray(lphi))
    np.testing.assert_allclose(diag_t.numpy(), np.asarray(diag_j), atol=1e-6)
    np.testing.assert_allclose(pd_t.numpy(), np.asarray(pd_j), atol=1e-6)
    for (o_t, c_t), (o_j, c_j) in zip(coefs_t, coefs_j):
        assert o_t == tuple(o_j)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)
    assert tuple(o for o, _ in coefs_t) == cuda_stencils.OFFSETS

    kw = dict(tol=1e-5, rel_tol=1e-5, max_iter=500)
    x_t, it_t, res_t, res0_t, thr_t = cuda_stencils.cell_poisson_pcg(_t(b), diag_t, coefs_t, pd_t, **kw)
    assert bool(res_t < thr_t)
    x_k, it_k, _, res0_k = make_stencil_cg(diag_j, coefs_j, pd_j, **kw)(jnp.asarray(b))
    x_x, st_x = jpr.solve_cell_poisson(jnp.asarray(b), w_j, jnp.asarray(lphi), use_pallas="off", **kw)
    for x_ref, it_ref in ((x_k, it_k), (x_x, st_x.iters)):
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_ref), **SOLVE_TOL)
        assert abs(int(it_t) - int(it_ref)) <= 2, (int(it_t), int(it_ref))
    np.testing.assert_allclose(float(res0_t), float(res0_k), rtol=1e-5)


def test_cell_poisson_wrapper_routes_cpu_to_plain_and_checks_offsets():
    sphi, lphi, _ = _cell_system(seed=8)
    diag, coefs, pd = pressure.pressure_coefficients(compute_solid_frac_3d(_t(sphi)), _t(lphi))
    b = torch.from_numpy(np.random.default_rng(9).standard_normal(lphi.shape).astype(np.float32))
    b = torch.where(diag > 0, b, 0.0)
    kw = dict(tol=1e-6, rel_tol=1e-6, max_iter=300)
    before = cuda_stencils.cell_poisson_pcg.launches
    got = cuda_stencils.cell_poisson_pcg(b, diag, coefs, pd, **kw)
    want = cuda_stencils.cell_poisson_pcg_plain(b, diag, coefs, pd, **kw)
    assert cuda_stencils.cell_poisson_pcg.launches == before  # no kernel on the CPU
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError):
        cuda_stencils.cell_poisson_pcg(b.to("meta"), diag, coefs, pd, **kw)


def _geom_system(n, seed, physical):
    rng = np.random.default_rng(seed)
    dual = tuple(2 * k + 1 for k in n)
    if physical:  # fluid interior over a solid floor (test_pallas.py)
        ys = np.broadcast_to(np.arange(dual[1], dtype=np.float32)[None, :, None], dual)
        sphi = np.ascontiguousarray(ys - 2.5)
        vol = rng.uniform(0.2, 1.0, dual).astype(np.float32)
    else:
        sphi = rng.standard_normal(dual).astype(np.float32)
        vol = rng.random(dual).astype(np.float32)
    v = [rng.standard_normal(s).astype(np.float32) for s in _shapes(n)]
    return sphi, vol, v


def test_coupled_matvec_plain_matches_geom_kernel():
    from python_fluid_simulation_tpu.ops.pallas_cg import make_fused_coupled_cg_geom

    n = (9, 11, 10)
    sphi, vol, v = _geom_system(n, 21, physical=False)
    sphi_j, vol_j = j_split(jnp.asarray(sphi), 3), j_split(jnp.asarray(vol), 3)
    s_mu = np.float32(0.37)
    _, _, pdiags = jvis.viscosity_term_fields(jnp.float32(s_mu), sphi_j, vol_j, _shapes(n), False)
    solve = make_fused_coupled_cg_geom(
        sphi_j, vol_j, jnp.float32(s_mu), _shapes(n), pdiags,
        tol=0.0, rel_tol=0.0, max_iter=1, interpret=True,
    )
    lay = solve.layout
    q_pad, _ = solve.matvec_dq([lay.pad3(jnp.asarray(x)) for x in v])
    q_t = cuda_cg.coupled_matvec_plain(
        split_parity(_t(sphi), 3), split_parity(_t(vol), 3), torch.tensor(s_mu), tuple(_t(x) for x in v)
    )
    for a, s in enumerate(_shapes(n)):
        np.testing.assert_allclose(
            q_t[a].numpy(), np.asarray(q_pad[a][: s[0], : s[1], : s[2]]), rtol=1e-5, atol=1e-6
        )
    # the materialised-coefficient matvec of the port agrees too
    q_m = viscosity.viscosity_matvec_3d(
        tuple(_t(x) for x in v), torch.tensor(s_mu), split_parity(_t(sphi), 3), split_parity(_t(vol), 3)
    )
    for a in range(3):
        np.testing.assert_allclose(q_m[a].numpy(), q_t[a].numpy(), rtol=1e-5, atol=1e-6)


def test_coupled_pcg_plain_matches_geom_kernel_solve():
    from python_fluid_simulation_tpu.ops.pallas_cg import make_fused_coupled_cg_geom

    n = (10, 8, 12)
    sphi, vol, v = _geom_system(n, 31, physical=True)
    sphi_j, vol_j = j_split(jnp.asarray(sphi), 3), j_split(jnp.asarray(vol), 3)
    s_mu = np.float32(0.4)
    b_j = jvis.viscosity_rhs_3d([jnp.asarray(x) for x in v], jnp.float32(s_mu), sphi_j, vol_j, False)
    _, _, pdiags = jvis.viscosity_term_fields(jnp.float32(s_mu), sphi_j, vol_j, _shapes(n), False)
    kw = dict(tol=1e-5, rel_tol=1e-6, max_iter=400)
    solve = make_fused_coupled_cg_geom(sphi_j, vol_j, jnp.float32(s_mu), _shapes(n), pdiags, interpret=True, **kw)
    x_j, it_j, _, _, _ = solve(b_j, [jnp.asarray(x) for x in v])

    sphi_t, vol_t = split_parity(_t(sphi), 3), split_parity(_t(vol), 3)
    smu_t = torch.tensor(s_mu)
    b_t = viscosity.viscosity_rhs_3d(tuple(_t(x) for x in v), smu_t, sphi_t, vol_t)
    pd_t = viscosity.viscosity_diag_3d(smu_t, sphi_t, vol_t, _shapes(n))
    for a in range(3):
        np.testing.assert_allclose(b_t[a].numpy(), np.asarray(b_j[a]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(pd_t[a].numpy(), np.asarray(pdiags[a]), rtol=1e-6)
    x_t, it_t, res_t, _, thr_t, _ = cuda_cg.coupled_visc_pcg(
        b_t, tuple(_t(x) for x in v), pd_t, sphi_t, vol_t, smu_t, **kw
    )
    assert bool(res_t < thr_t) and int(it_t) > 3
    assert abs(int(it_t) - int(it_j)) <= 2, (int(it_t), int(it_j))
    for a in range(3):
        np.testing.assert_allclose(x_t[a].numpy(), np.asarray(x_j[a]), **SOLVE_TOL)


def test_coupled_plan_packs_the_kernel_layout():
    words = cuda_cg.plan_words((48, 80, 48))
    assert words.dtype == np.int32 and words.size == 3 * (1 + 7 + 21 + 7 + 14 * 13) + 30 + 10 + 10 + 3 + 4
    plan = cuda_cg.stencil_plan()
    assert [len(ax["terms"]) for ax in plan] == [14, 14, 14]
    assert [len(ax["diag"]) for ax in plan] == [7, 7, 7]
    n_face = 49 * 80 * 48 + 48 * 81 * 48 + 48 * 80 * 49
    assert words[-1] == n_face


def _fluid_state(seed=3):
    """Inputs for the three solves from a small dam break (test_golden.py's
    config) with random particle velocities, built by the port (its
    transfers are held against the JAX package in test_torch_transfers)
    and handed to both packages as numpy arrays."""
    from python_fluid_simulation_tpu_torch.engine.step import _FACE_BIAS, build_geom_cache
    from python_fluid_simulation_tpu_torch.ops.levelset import compute_fluid_levelset
    from python_fluid_simulation_tpu_torch.ops.transfers import p2g_all

    cfg = SimConfig(
        grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1.0 / 12),
        physics=PhysicsConfig(rho=1000.0, mu=0.5, dt=1.0 / 60.0),
        solver=SolverConfig(max_iter=400, pallas="off"),
        particle_dx=1.0 / 24, dt_mode="cfl", duration=10.0,
    )
    state = dam_break_scene(cfg, seed=seed, device="cpu")
    g = cfg.grid
    p = state.particles
    pv = torch.from_numpy((0.5 * np.random.default_rng(seed).standard_normal(tuple(p.x.shape))).astype(np.float32))
    geom = build_geom_cache(state.solid)
    lphi = compute_fluid_levelset(p.x, g.res, g.bound_min, g.cell_size, g.dx, pm=p.m)
    _, gv, lvol = p2g_all(
        p.x, p.m, pv, p.c, g.res, _shapes(g.res), _FACE_BIAS, g.bound_min, g.cell_size,
        volume=(cfg.particle_dx**3, g.dual_cell_size),
    )

    def np_(v):
        if isinstance(v, dict):
            return {k: x.numpy() for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return tuple(np_(x) for x in v)
        return v.numpy()

    return cfg, dict(
        px=np_(p.x), pm=np_(p.m), sphi_c=np_(geom.sphi_c), sv_c=np_(geom.sv_c),
        w_faces=np_(geom.w_faces), lphi=np_(lphi), gv=np_(gv), lvol=np_(lvol),
    )


@pytest.fixture(scope="module")
def fluid():
    return _fluid_state()


def _as(v, conv):
    """The numpy input structure as JAX (jnp.asarray) or torch (_t) arrays."""
    if isinstance(v, dict):
        return {k: conv(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(_as(x, conv) for x in v)
    return conv(v)


def test_pressure_solve_matches_jax(fluid):
    cfg, d = fluid
    kw = dict(tol=1e-3, rel_tol=1e-3, max_iter=400)
    names = ("gv", "sv_c", "lphi", "w_faces")
    want = jpr.pressure_solve_3d(*(_as(d[k], jnp.asarray) for k in names), cfg.grid.cell_size, use_pallas="off", **kw)
    got = pressure.pressure_solve_3d(*(_as(d[k], _t) for k in names), cfg.grid.cell_size, **kw)
    assert int(want.stats.iters) > 3 and bool(got.stats.converged)
    assert abs(int(got.stats.iters) - int(want.stats.iters)) <= 2
    np.testing.assert_allclose(got.pressure.numpy(), np.asarray(want.pressure), **SOLVE_TOL)
    for a in range(3):
        np.testing.assert_allclose(got.v_faces[a].numpy(), np.asarray(want.v_faces[a]), atol=1e-3)


@pytest.mark.parametrize("wz_bug", [False, True])
def test_density_solve_matches_jax(fluid, wz_bug):
    cfg, d = fluid
    g = cfg.grid
    dt = np.float32(cfg.physics.dt)
    kw = dict(tol=1e-3, rel_tol=1e-3, max_iter=400, wz_bug=wz_bug)
    names = ("px", "pm")
    geo = ("sphi_c", "lphi", "w_faces")
    want = jden.density_solve_3d(
        cfg.physics.rho, jnp.float32(dt), *(_as(d[k], jnp.asarray) for k in names), cfg.particle_dx**3,
        *(_as(d[k], jnp.asarray) for k in geo), g.bound_min, g.cell_size, use_pallas="off", **kw,
    )
    got = density.density_solve_3d(
        cfg.physics.rho, torch.tensor(dt), *(_as(d[k], _t) for k in names), cfg.particle_dx**3,
        *(_as(d[k], _t) for k in geo), g.bound_min, g.cell_size, **kw,
    )
    assert int(want.stats.iters) > 3
    assert abs(int(got.stats.iters) - int(want.stats.iters)) <= 2
    # displacements are O(1e-3 m): positions agree to a small multiple
    # of the solve tolerance times that scale
    np.testing.assert_allclose(got.px.numpy(), np.asarray(want.px), atol=2e-5)


def test_viscosity_solve_matches_jax(fluid):
    cfg, d = fluid
    dt = np.float32(cfg.physics.dt)
    kw = dict(tol=1e-3, rel_tol=1e-3, max_iter=400)
    ph = cfg.physics
    want = jvis.viscosity_solve_3d(
        jnp.float32(dt), ph.mu, ph.rho, *(_as(d[k], jnp.asarray) for k in ("gv", "sphi_c", "lvol")),
        cfg.grid.cell_vol, use_pallas="off", **kw,
    )
    got = viscosity.viscosity_solve_3d(
        torch.tensor(dt), ph.mu, ph.rho, *(_as(d[k], _t) for k in ("gv", "sphi_c", "lvol")), cfg.grid.cell_vol, **kw,
    )
    assert int(want.stats.iters) > 1
    assert abs(int(got.stats.iters) - int(want.stats.iters)) <= 2
    for a in range(3):
        np.testing.assert_allclose(got.v_faces[a].numpy(), np.asarray(want.v_faces[a]), **SOLVE_TOL)


def test_mg_pressure_solve_matches_jax(fluid):
    cfg, d = fluid
    kw = dict(tol=1e-3, rel_tol=1e-3, max_iter=400)
    names = ("gv", "sv_c", "lphi", "w_faces")
    want = jpr.pressure_solve_3d(
        *(_as(d[k], jnp.asarray) for k in names), cfg.grid.cell_size, use_pallas="off", precond_kind="mg", **kw
    )
    got = pressure.pressure_solve_3d(*(_as(d[k], _t) for k in names), cfg.grid.cell_size, precond="mg", **kw)
    jac = pressure.pressure_solve_3d(*(_as(d[k], _t) for k in names), cfg.grid.cell_size, **kw)
    assert int(want.stats.iters) > 1 and bool(got.stats.converged)
    assert abs(int(got.stats.iters) - int(want.stats.iters)) <= 2
    assert int(got.stats.iters) < int(jac.stats.iters)
    np.testing.assert_allclose(got.pressure.numpy(), np.asarray(want.pressure), **SOLVE_TOL)
    for a in range(3):
        np.testing.assert_allclose(got.v_faces[a].numpy(), np.asarray(want.v_faces[a]), atol=1e-3)


@pytest.mark.parametrize("wz_bug", [False, True])
def test_mg_density_solve_matches_jax(fluid, wz_bug):
    cfg, d = fluid
    g = cfg.grid
    dt = np.float32(cfg.physics.dt)
    kw = dict(tol=1e-3, rel_tol=1e-3, max_iter=400, wz_bug=wz_bug)
    names = ("px", "pm")
    geo = ("sphi_c", "lphi", "w_faces")
    want = jden.density_solve_3d(
        cfg.physics.rho, jnp.float32(dt), *(_as(d[k], jnp.asarray) for k in names), cfg.particle_dx**3,
        *(_as(d[k], jnp.asarray) for k in geo), g.bound_min, g.cell_size, use_pallas="off", precond_kind="mg", **kw,
    )
    got = density.density_solve_3d(
        cfg.physics.rho, torch.tensor(dt), *(_as(d[k], _t) for k in names), cfg.particle_dx**3,
        *(_as(d[k], _t) for k in geo), g.bound_min, g.cell_size, precond="mg", **kw,
    )
    assert int(want.stats.iters) > 1 and bool(got.stats.converged)
    assert abs(int(got.stats.iters) - int(want.stats.iters)) <= 2
    np.testing.assert_allclose(got.px.numpy(), np.asarray(want.px), atol=2e-5)
