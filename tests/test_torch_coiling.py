"""The coiling scene (``coiling_config``, BASELINE config 5) in the
PyTorch port against the JAX package, and the plain versions of the
slice's three kernels, on CPU.

* ``coiling_config(r)`` equals the JAX configuration field for field, and
  ``coiling_scene`` seeds exactly the JAX scene at res 24 and at the
  default res 256 (64x256x64 cells, 73,644 particles).
* 2 coarse coiling steps (res 24, 6x24x6 cells) against the JAX
  ``simulate`` in three runs: 'auto' from the scene (the Jacobi branch),
  ``viscosity_precond='mg'``, and 'auto' from a state with visc_mg = 2
  (the MG branch).  The solver tolerances are tests/test_step.py's MG
  coiling test's (tol = rel_tol = 1e-5, max_iter 500) so the viscosity
  solves do real work.  Iterations within 2, x atol 1e-5 m, v atol 1e-4
  m/s, APIC rows atol 1e-3 1/s (tests/test_torch_step.py's bounds), the
  carried visc_mg flag equal; no kernel wrapper counts a launch on CPU.
* the batched block V-cycle (``make_viscosity_mg_preconditioner``) on the
  viscosity system of a coarse coiling step (res 48, 12x48x12) against
  the JAX package's, with its XLA V-cycle and with its interpreted Pallas
  chains: rtol 1e-5 / atol 1e-6 (the cell V-cycle test's tolerance;
  levels >= 1 relax in the TPU chain's form x + r * inv, the XLA cycle
  in x + omega r / safe_diag); the stacked hierarchy bitwise.
* the batched level chains (plain) against ``pallas_mg.make_level_kernels
  (interpret=True)`` on a (3, X, Y, Z) level: max |difference| <= 1e-6 of
  max |value|, as the 3D chains.
* the geometry-recompute coupled matvec (plain), full and same-axis,
  against ``make_blocked_coupled_matvec_geom(interpret=True)``: rtol 1e-5
  / atol 1e-5 (tests/test_pallas.py's tolerance for that kernel).
* the fold (plain) against ``fold_scattered_sep_pallas(interpret=True)``
  over tests/test_scatter.py's shift families, E = N+2 and N+1: rtol 2e-6
  / atol 2e-6 (that test's tolerance; the sums combine in another order),
  mins bitwise; and against the JAX XLA fold for the level set's E = N.
* every new wrapper refuses a tensor on a device it has no route for
  (no silent fall-back to the plain version).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import pallas_mg
from python_fluid_simulation_tpu.ops.indexing import split_parity as j_split
from python_fluid_simulation_tpu.solvers import multigrid as jmg
from python_fluid_simulation_tpu.solvers import viscosity as jvisc
from python_fluid_simulation_tpu_torch.convert import state_from_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import coiling_config, coiling_scene
from python_fluid_simulation_tpu_torch.engine.step import simulate
from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_cg, cuda_fold, cuda_mg, cuda_scan, cuda_stencils
from python_fluid_simulation_tpu_torch.ops.indexing import split_parity
from python_fluid_simulation_tpu_torch.solvers import viscosity

torch.set_num_threads(1)

STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)
VCYCLE_TOL = dict(rtol=1e-5, atol=1e-6)
CHAIN_REL = 1e-6
MATVEC_TOL = dict(rtol=1e-5, atol=1e-5)
FOLD_TOL = dict(rtol=2e-6, atol=2e-6)
# solver settings of tests/test_step.py::test_coiling_with_mg_viscosity_matches_jacobi
TIGHT = dict(tol=1e-5, rel_tol=1e-5, max_iter=500)


def _launch_counts():
    return [f.launches for f in (
        cuda_stencils.cell_poisson_pcg, cuda_stencils.stencil_matvec, cuda_cg.coupled_visc_pcg,
        cuda_cg.coupled_matvec_geom, cuda_mg.vcycle_tail, cuda_binned.serial_reduce, cuda_scan.seg_scan_sorted,
        cuda_binned.place_live, cuda_binned.segment_broadcast, cuda_fold.fold,
    )]


@pytest.mark.parametrize("res", [24, 96, 256])
def test_coiling_config_matches_jax(res):
    from python_fluid_simulation_tpu.engine.scenes import coiling_config as j_cfg

    got, want = coiling_config(res), j_cfg(res)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.solver.viscosity_precond == ("jacobi" if res < 96 else "auto")
    if res == 256:
        assert got.grid.res == (64, 256, 64) and got.solver.precond == "mg" and got.solver.max_iter == 600


@pytest.mark.parametrize("res, n", [(24, 153), (256, 73644)])
def test_coiling_scene_matches_jax_exactly(res, n):
    from python_fluid_simulation_tpu.engine.scenes import coiling_scene as j_scene

    state = coiling_scene(coiling_config(res), device="cpu")
    want = j_scene(coiling_config(res))
    assert state.particles.x.shape == (n, 3)
    np.testing.assert_array_equal(state.particles.x.numpy(), np.asarray(want.particles.x))
    np.testing.assert_array_equal(state.particles.m.numpy(), np.asarray(want.particles.m))
    np.testing.assert_array_equal(state.solid.rb.numpy(), np.asarray(want.solid.rb))
    np.testing.assert_allclose(state.solid.phi.numpy(), np.asarray(want.solid.phi), atol=1e-6)


def _coarse_pair(viscosity_precond, visc_mg=0, res=24):
    """2 steps of the coarse coiling scene through both packages from the
    same start state (with the given carried visc_mg flag)."""
    from python_fluid_simulation_tpu.engine.scenes import coiling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import coiling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    def solver(c):
        return dataclasses.replace(c, solver=dataclasses.replace(c.solver, viscosity_precond=viscosity_precond, **TIGHT))

    j_state = j_scene(j_cfg(res))._replace(visc_mg=np.int32(visc_mg))
    j_final, j_metrics = j_simulate(j_state, solver(j_cfg(res)), 2)
    start = {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx, "visc_mg": np.int32(visc_mg),
    }
    state = state_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu")
    before = _launch_counts()
    final, metrics = simulate(state, solver(coiling_config(res)), 2)
    assert _launch_counts() == before  # CPU tensors launch no kernel
    return j_final, j_metrics, final, metrics


@pytest.mark.parametrize("viscosity_precond, visc_mg", [("auto", 0), ("mg", 0), ("auto", 2)])
def test_coarse_coiling_steps_match_jax(viscosity_precond, visc_mg):
    j_final, j_metrics, final, metrics = _coarse_pair(viscosity_precond, visc_mg)
    assert final.particles.x.shape == (153, 3)
    for solver in ("density", "viscosity", "pressure"):
        got = metrics[f"{solver}_iters"].numpy()
        want = np.asarray(j_metrics[f"{solver}_iters"])
        assert np.all(np.abs(got - want) <= 2), (solver, got, want)
        assert metrics[f"{solver}_converged"].all()
    assert metrics["viscosity_iters"][1] > 0  # the second step really solves
    for k, tol in STEP_TOL.items():
        np.testing.assert_allclose(getattr(final.particles, k).numpy(), np.asarray(getattr(j_final.particles, k)),
                                   atol=tol, err_msg=k)
    assert int(final.visc_mg) == int(j_final.visc_mg)
    assert int(final.visc_mg) == (2 if visc_mg == 2 else 0)


@pytest.fixture(scope="module")
def visc_system():
    """The viscosity system of the second step of a coarse coiling run
    (res 48) on the MG route: (b, x0, s_mu, sphi_c, vol_c, shapes)."""
    cfg = coiling_config(48)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_precond="mg"))
    got = []
    orig = viscosity._mg_solve

    def rec(*args, **kw):
        got.append(args)
        return orig(*args, **kw)

    viscosity._mg_solve = rec
    try:
        simulate(coiling_scene(cfg, device="cpu"), cfg, 2)
    finally:
        viscosity._mg_solve = orig
    return got[-1]


def _jax_terms(s_mu, sphi_c, vol_c, shapes):
    def j(c):
        return {k: jnp.asarray(v.numpy()) for k, v in c.items()}

    return jvisc.viscosity_term_fields(jnp.float32(float(s_mu)), j(sphi_c), j(vol_c), shapes)


def test_batched_vcycle_matches_jax(visc_system, monkeypatch):
    b, _, s_mu, sphi_c, vol_c, shapes = visc_system
    assert [tuple(s) for s in shapes] == [(13, 48, 12), (12, 49, 12), (12, 48, 13)]
    diags, same, _ = viscosity.viscosity_term_fields(s_mu, sphi_c, vol_c, shapes, same_axis_only=True)
    jd, jp, _ = _jax_terms(s_mu, sphi_c, vol_c, shapes)
    mg = viscosity.make_viscosity_mg_preconditioner(diags, same)
    # the stacked hierarchy: (3, X, Y, Z) levels, contiguous, padded rows inactive
    assert [tuple(lv.diag.shape) for lv in mg.levels] == [(3, 13, 49, 13), (3, 7, 25, 7), (3, 4, 13, 4)]
    for lv in mg.levels:
        assert lv.diag.is_contiguous() and all(c.is_contiguous() for _, c in lv.coefs)
    assert not bool((mg.levels[0].diag[0, :, 48, :] != 0).any())  # system 0 has 48 y planes
    rng = np.random.default_rng(5)
    for r in (tuple(x.numpy() for x in b), tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)):
        z_t = [z.numpy() for z in mg(tuple(torch.from_numpy(x) for x in r))]
        z_xla = jvisc.make_viscosity_mg_preconditioner(jd, jp)(tuple(jnp.asarray(x) for x in r))
        for a in range(3):
            np.testing.assert_allclose(z_t[a], np.asarray(z_xla[a]), **VCYCLE_TOL)
    make = pallas_mg.make_level_kernels
    monkeypatch.setattr(pallas_mg, "level_kernels_available", lambda s: True)
    monkeypatch.setattr(pallas_mg, "make_level_kernels", lambda d, c, **kw: make(d, c, **{**kw, "interpret": True}))
    z_fused = jvisc.make_viscosity_mg_preconditioner(jd, jp)(tuple(jnp.asarray(x) for x in r))
    for a in range(3):
        np.testing.assert_allclose(z_t[a], np.asarray(z_fused[a]), **VCYCLE_TOL)


def test_batched_hierarchy_matches_jax(visc_system):
    """The three per-axis hierarchies, padded and stacked, bitwise equal
    to the JAX package's batched levels."""
    _, _, s_mu, sphi_c, vol_c, shapes = visc_system
    diags, same, _ = viscosity.viscosity_term_fields(s_mu, sphi_c, vol_c, shapes, same_axis_only=True)
    jd, jp, _ = _jax_terms(s_mu, sphi_c, vol_c, shapes)
    for a in range(3):
        np.testing.assert_array_equal(diags[a].numpy(), np.asarray(jd[a]))
        want = [(v, c) for f, v, c in jp[a] if f == a]
        assert [v for _, v, _ in same[a]] == [v for v, _ in want]
        for (_, _, c), (_, w) in zip(same[a], want):
            np.testing.assert_array_equal(c.numpy(), np.asarray(w))
    t_levels = viscosity.make_viscosity_mg_preconditioner(diags, same).levels
    systems = [(jd[a], [(v, c) for f, v, c in jp[a] if f == a]) for a in range(3)]
    hiers = [jmg.build_hierarchy(d, _canon(c)) for d, c in systems]
    for k, lv in enumerate(t_levels):
        common = tuple(lv.diag.shape[1:])
        want = np.stack([np.asarray(jmg._pad_to(h[k].diag, common)) for h in hiers])
        np.testing.assert_array_equal(lv.diag.numpy(), want)
        for j, (off, c) in enumerate(lv.coefs):
            assert tuple(off) == tuple(hiers[0][k].coefs[j][0])
            np.testing.assert_array_equal(c.numpy(), np.stack([np.asarray(jmg._pad_to(h[k].coefs[j][1], common)) for h in hiers]))
        np.testing.assert_array_equal(
            lv.safe_diag.numpy(), np.stack([np.asarray(jmg._pad_to(h[k].safe_diag, common, 1.0)) for h in hiers]))


def _canon(coefs):
    """The JAX batched preconditioner's (+x, -x, +y, -y, +z, -z) order."""

    def key(item):
        off = item[0]
        axis = next(i for i, o in enumerate(off) if o)
        return (axis, 0 if off[axis] > 0 else 1)

    return sorted(coefs, key=key)


def _close_rel(got, want, rel):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (np.abs(got - want).max(), np.abs(want).max())


def test_batched_level_chains_plain_match_pallas_interpret(visc_system):
    _, _, s_mu, sphi_c, vol_c, shapes = visc_system
    diags, same, _ = viscosity.viscosity_term_fields(s_mu, sphi_c, vol_c, shapes, same_axis_only=True)
    mg = viscosity.make_viscosity_mg_preconditioner(diags, same)
    lv = mg.levels[1]
    assert lv.diag.shape == (3, 7, 25, 7)
    kw = dict(omega=0.8, n_smooth=2, coarse_iters=24)
    kj = pallas_mg.make_level_kernels(
        jnp.asarray(lv.diag.numpy()), [(o, jnp.asarray(c.numpy())) for o, c in lv.coefs], interpret=True, **kw)
    before = (cuda_mg.vcycle_tail.launches, cuda_mg.vcycle_tail.batched_launches)

    def chain(b, x0, iters, resid):
        return cuda_mg.level_chain_plain(lv.diag, lv.coefs, b, x0, iters=iters, omega=0.8, emit_resid=resid)

    rng = np.random.default_rng(11)
    b = rng.standard_normal(lv.diag.shape).astype(np.float32)
    x = rng.standard_normal(lv.diag.shape).astype(np.float32)
    xj, rj = kj.presmooth_resid(jnp.asarray(b))
    xt, rt = chain(torch.from_numpy(b), None, 2, True)
    _close_rel(xt.numpy(), xj, CHAIN_REL)
    _close_rel(rt.numpy(), rj, CHAIN_REL)
    _close_rel(chain(torch.from_numpy(b), torch.from_numpy(x), 2, False).numpy(),
               kj.postsmooth(jnp.asarray(x), jnp.asarray(b)), CHAIN_REL)
    _close_rel(chain(torch.from_numpy(b), None, 24, False).numpy(), kj.coarse_solve(jnp.asarray(b)), CHAIN_REL)
    # each system relaxes on its own: the stack equals the systems one by one
    for i in range(3):
        one = cuda_mg.level_chain_plain(lv.diag[i], [(o, c[i]) for o, c in lv.coefs], torch.from_numpy(b[i]), None,
                                        iters=24, omega=0.8, emit_resid=False)
        np.testing.assert_array_equal(chain(torch.from_numpy(b), None, 24, False)[i].numpy(), one.numpy())
    # the chains' wrapper is the V-cycle's tail: the CPU runs its plain
    # version, and a meta tensor is refused
    r0 = torch.from_numpy(rng.standard_normal(mg.tail.fine_shape).astype(np.float32))
    cuda_mg.vcycle_tail(mg.tail, r0, r0)
    assert (cuda_mg.vcycle_tail.launches, cuda_mg.vcycle_tail.batched_launches) == before
    with pytest.raises(ValueError):
        cuda_mg.vcycle_tail(mg.tail, r0.to("meta"), r0.to("meta"))


def _geom_case(seed, n=(8, 10, 12)):
    """tests/test_pallas.py's geometry: random sphi and vol on the dual
    lattice of an 8x10x12 grid."""
    dual = tuple(2 * k + 1 for k in n)
    rng = np.random.default_rng(seed)
    sphi = rng.standard_normal(dual).astype(np.float32)
    rng.standard_normal(n)  # test_pallas.py's unused lphi draw
    vol = rng.uniform(0.1, 1.0, dual).astype(np.float32)
    shapes = [tuple(k + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]
    v = tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)
    return sphi, vol, shapes, v


@pytest.mark.parametrize("same_axis_only", [False, True])
def test_coupled_matvec_geom_plain_matches_pallas_interpret(same_axis_only):
    from python_fluid_simulation_tpu.ops.pallas_cg import make_blocked_coupled_matvec_geom

    sphi, vol, shapes, v = _geom_case(23 if same_axis_only else 21)
    mv = make_blocked_coupled_matvec_geom(j_split(jnp.asarray(sphi), 3), j_split(jnp.asarray(vol), 3), 0.7, shapes,
                                          interpret=True, same_axis_only=same_axis_only)
    want = mv(tuple(jnp.asarray(x) for x in v))
    sphi_c, vol_c = split_parity(torch.from_numpy(sphi), 3), split_parity(torch.from_numpy(vol), 3)
    s_mu = torch.tensor(0.7)
    before = cuda_cg.coupled_matvec_geom.launches
    got = cuda_cg.coupled_matvec_geom(sphi_c, vol_c, s_mu, tuple(torch.from_numpy(x) for x in v),
                                      same_axis_only=same_axis_only)
    assert cuda_cg.coupled_matvec_geom.launches == before
    for a in range(3):
        np.testing.assert_allclose(got[a].numpy(), np.asarray(want[a]), **MATVEC_TOL)
    if not same_axis_only:  # the full operator is the Jacobi-PCG kernel's plain matvec
        full = cuda_cg.coupled_matvec_plain(sphi_c, vol_c, s_mu, tuple(torch.from_numpy(x) for x in v))
        for a in range(3):
            np.testing.assert_array_equal(got[a].numpy(), full[a].numpy())
    with pytest.raises(ValueError):
        cuda_cg.coupled_matvec_geom(sphi_c, vol_c, s_mu, tuple(torch.from_numpy(x).to("meta") for x in v))


FOLD_CASES = [
    # (out_shape, axis_shifts, combine, fill)   engine users (test_scatter.py)
    ((9, 10, 11), [(-1, 0)] * 3, "add", 0.0),  # p2g own axis
    ((9, 10, 11), [(-1, 0), (-2, -1, 0), (-2, -1, 0)], "add", 0.0),  # p2g x-axis
    ((9, 10, 11), [(-2, -1, 0)] * 3, "add", 0.0),  # density
    ((9, 10, 11), [(-2, -1, 0, 1, 2)] * 3, "min", 3.0),  # levelset
    ((10, 10, 11), [(-1, 0)] * 3, "add", 0.0),  # class N+1
]


@pytest.mark.parametrize("case", range(len(FOLD_CASES)))
def test_fold_plain_matches_pallas_interpret(case):
    from python_fluid_simulation_tpu.ops.pallas_fold import fold_scattered_sep_pallas
    from python_fluid_simulation_tpu.ops.scatter import fold_scattered_sep as j_fold

    out_shape, axis_shifts, combine, fill = FOLD_CASES[case]
    rng = np.random.default_rng(3 + case)
    n_ch = int(np.prod([len(s) for s in axis_shifts]))
    before = cuda_fold.fold.launches
    for ext_off in (2, 1, 0):
        seg = rng.standard_normal((n_ch,) + tuple(n + ext_off for n in out_shape)).astype(np.float32)
        got = cuda_fold.fold(torch.from_numpy(seg), axis_shifts, out_shape, combine, fill).numpy()
        if ext_off:
            want = np.asarray(fold_scattered_sep_pallas(jnp.asarray(seg), axis_shifts, out_shape, combine, fill,
                                                        interpret=True))
            np.testing.assert_allclose(got, want, **FOLD_TOL, err_msg=str((case, ext_off)))
            if combine == "min":
                np.testing.assert_array_equal(got, want)
        # the level set folds a table of the grid's own shape (E = N)
        want = np.asarray(j_fold(jnp.asarray(seg), axis_shifts, out_shape, combine, fill))
        np.testing.assert_allclose(got, want, **FOLD_TOL, err_msg=str((case, ext_off)))
    assert cuda_fold.fold.launches == before
    with pytest.raises(ValueError):
        cuda_fold.fold(torch.from_numpy(seg).to("meta"), axis_shifts, out_shape, combine, fill)
