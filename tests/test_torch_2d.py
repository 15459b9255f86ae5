"""The 2D engine of the PyTorch port against the JAX package, on the CPU.

* ``sdf2d``: tests/test_2d.py's bodies and points, and a rotated box and
  a circle over random points, evaluate and project within 1e-6;
* ``compute_solid_frac_2d`` and the three 2D solves on one state of
  tests/test_2d.py's dam break (dx 1/24, after 3 JAX steps, every input
  made by the JAX package): within 1e-5 of the largest entry, with equal
  iterations;
* ``step_2d``: 8 dam-break and 5 droplet steps against JAX
  ``simulate_2d`` from the same scene (the scenes bitwise equal):
  x 1e-5, v 1e-4, APIC rows 1e-3, iterations equal.  The JAX package's
  CPU route of ``segment_sum_sorted`` takes each segment's sum as a
  difference of one global cumsum, whose rounding noise moves ``gm > 0``
  masks; as in tests/test_torch_flagship.py, it is replaced inside this
  test by ``jax.ops.segment_sum``, whose sums run in row order as the
  port's do;
* ``make_step_2d`` and ``simulate_2d`` bitwise ``step_2d`` on the CPU;
* the 2D fold on the card is the 3D fold kernel over a unit leading axis
  (``ops/cuda_fold.py::lift_2d``): the lifted fold's plain version and
  tests/live_table_model.py's model of the kernel bitwise the 2D fold, on
  the 2D step's fold shapes, and the tile boxes inside the kernel's
  shared memory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu import config as j_config
from python_fluid_simulation_tpu.engine import step2d as j_step2d
from python_fluid_simulation_tpu.ops import fractions as j_fractions
from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu.ops import sdf2d as j_sdf2d
from python_fluid_simulation_tpu.solvers import density as j_density
from python_fluid_simulation_tpu.solvers import pressure as j_pressure
from python_fluid_simulation_tpu.solvers import viscosity as j_viscosity
from python_fluid_simulation_tpu_torch import config as t_config
from python_fluid_simulation_tpu_torch.engine import step2d
from python_fluid_simulation_tpu_torch.ops import sdf2d
from python_fluid_simulation_tpu_torch.ops.cuda_binned import scan_reduce_plain
from python_fluid_simulation_tpu_torch.ops.cuda_fold import fold_plain, lift_2d
from python_fluid_simulation_tpu_torch.ops.fractions import compute_solid_frac_2d
from python_fluid_simulation_tpu_torch.solvers.density import density_solve_2d
from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_solve_2d
from python_fluid_simulation_tpu_torch.solvers.viscosity import viscosity_matvec_2d, viscosity_solve_2d
from python_fluid_simulation_tpu_torch.state import Particles, SimState, SolidState

torch.set_num_threads(1)

STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)
REL = 1e-5  # a solve's output vs the JAX package's, over its largest entry


def _cfgs(droplet=False):
    """tests/test_2d.py's two configurations, in both packages."""
    kw = (dict(dx=1.0 / 20, mu=0.2, max_iter=400, pdx=1.0 / 40) if droplet
          else dict(dx=1.0 / 24, mu=0.5, max_iter=600, pdx=1.0 / 48))
    out = []
    for pkg, mk in ((j_config, j_step2d.SimConfig2D), (t_config, step2d.SimConfig2D)):
        out.append(mk(grid=pkg.GridConfig2D(bound_min=(0.0, 0.0), bound_size=(1.0, 1.0), dx=kw["dx"]),
                      physics=pkg.PhysicsConfig(mu=kw["mu"], dt=1.0 / 120.0),
                      solver=pkg.SolverConfig(max_iter=kw["max_iter"]), particle_dx=kw["pdx"]))
    return out


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _port_state(j_state):
    p, s = j_state.particles, j_state.solid
    t = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)  # noqa: E731
    return SimState(Particles(t(p.x), t(p.v), t(p.c), t(p.m)), SolidState(t(s.phi), t(s.v), t(s.rb)),
                    t(j_state.t), t(j_state.step_idx, torch.int32))


def _j_solves(j_cfg, x, v, c, m, sphi, sv):
    """The JAX package's step_2d up to the pressure solve from a state,
    with every input of the three solves: one jitted program."""
    g, ph, sol = j_cfg.grid, j_cfg.physics, j_cfg.solver
    kw = dict(tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter)
    dt = jnp.float32(ph.dt)
    w = j_fractions.compute_solid_frac_2d(sphi)
    px = x + v * dt
    lphi, lvol = j_step2d._levelsets_2d(px, j_cfg)
    dres = j_density.density_solve_2d(ph.rho, dt, px, m, j_cfg.particle_dx**2, sphi, lphi, lvol, w, g.bound_min,
                                      g.cell_size, **kw)
    lphi2, lvol2 = j_step2d._levelsets_2d(dres.px, j_cfg)
    gv = []
    for a in range(2):
        fshape = tuple(n + (1 if i == a else 0) for i, n in enumerate(g.res))
        gv.append(j_step2d.p2g_axis(dres.px, m, v, c[:, a, :], a, g.res, fshape, j_step2d._FACE_BIAS[a], g.bound_min,
                                    g.cell_size)[1])
    vres = j_viscosity.viscosity_solve_2d(dt, ph.mu, ph.rho, tuple(gv), sphi, lvol2, g.cell_vol, **kw)
    pres = j_pressure.pressure_solve_2d(vres.v_faces, sv, lphi2, w, g.cell_size, **kw)
    return dict(w=w, px=px, lphi=lphi, lvol=lvol, dres=dres, lphi2=lphi2, lvol2=lvol2, gv=tuple(gv), vres=vres,
                pres=pres)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX simulate_2d on both scenes with the exact segment sum: the
    scene, the final state and the metrics; and the solves' inputs and
    outputs from the dam break's final state."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    jax.clear_caches()
    out = {}
    try:
        for name, maker, steps in (("dam", j_step2d.dam_break_scene_2d, 8), ("droplet", j_step2d.droplet_scene_2d, 5)):
            j_cfg, _ = _cfgs(name == "droplet")
            _, s0 = maker(j_cfg)
            final, metrics = j_step2d.simulate_2d(s0, j_cfg, steps)
            out[name] = (s0, jax.device_get(final), _np(metrics))
        j_cfg, _ = _cfgs()
        js = out["dam"][1]
        args = (js.particles.x, js.particles.v, js.particles.c, js.particles.m, js.solid.phi, js.solid.v)
        out["solves"] = args, jax.device_get(jax.jit(lambda *a: _j_solves(j_cfg, *a))(*args))
    finally:
        mp.undo()
        jax.clear_caches()
    return out


def test_sdf2d_matches_jax():
    bodies = [("c", "sphere", [1.0], dict(center=[2.0, 0.0])), ("b", "box", [2.0, 2.0], dict(flip=True)),
              ("r", "box", [0.5, 0.3], dict(center=[-0.4, 0.6], angle=30.0, velocity=[0.5, -1.0])),
              ("s", "sphere", [0.3], dict(center=[0.2, -0.5], flip=True))]
    pts = np.concatenate([np.array([[2.0, 0.5], [0.0, 0.0], [3.5, 0.0], [1.5, 0.2], [0.1, 0.2], [0.2, -0.5]],
                                   np.float32),
                          np.random.default_rng(3).uniform(-2.5, 3.5, (400, 2)).astype(np.float32)])
    for k in (2, 4):  # tests/test_2d.py's pair, then all four
        j_rbs, t_rbs = j_sdf2d.RigidBodySet2D(), sdf2d.RigidBodySet2D()
        for name, kind, params, kw in bodies[:k]:
            j_rbs.add(name, kind, params, **kw)
            t_rbs.add(name, kind, params, **kw)
        j_rbs.set_velocity(1, [0.25, 0.5])
        t_rbs.set_velocity(1, [0.25, 0.5])
        rb = t_rbs.table(device="cpu")
        np.testing.assert_array_equal(rb.numpy(), np.asarray(j_rbs.table()))
        j_sd, j_vel = jax.jit(lambda p: j_sdf2d.evaluate_2d(j_rbs.table(), p))(jnp.asarray(pts))
        sd, vel = sdf2d.evaluate_2d(rb, torch.from_numpy(pts))
        np.testing.assert_allclose(sd.numpy(), np.asarray(j_sd), atol=1e-6)
        np.testing.assert_allclose(vel.numpy(), np.asarray(j_vel), atol=1e-6)
        j_proj = jax.jit(lambda p: j_sdf2d.project_2d(j_rbs.table(), p))(jnp.asarray(pts))
        np.testing.assert_allclose(sdf2d.project_2d(rb, torch.from_numpy(pts)).numpy(), np.asarray(j_proj), atol=1e-6)
        if k == 2:  # tests/test_2d.py's expectation
            np.testing.assert_allclose(sd.numpy()[:3], [-1.0, 1.0, -2.5], atol=1e-6)


def _close(got, want, name, rel=REL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, f"{name}: max |d| {err} > {rel} x {scale}"


def test_2d_fractions_and_solves_match_jax(jax_runs):
    """The solid fractions and the density, viscosity and pressure solves
    on the dam break's state after 8 steps, every input made by the JAX
    package."""
    _, cfg = _cfgs()
    (x, v, c, m, sphi, sv), j = jax_runs["solves"]
    g, ph, sol = cfg.grid, cfg.physics, cfg.solver
    kw = dict(tol=sol.tol, rel_tol=sol.rel_tol, max_iter=sol.max_iter)
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    dt = torch.tensor(np.float32(ph.dt))
    w = compute_solid_frac_2d(T(sphi))
    for a in range(2):
        np.testing.assert_allclose(w[a].numpy(), j["w"][a], atol=1e-6)
    w = [T(a) for a in j["w"]]

    td = density_solve_2d(ph.rho, dt, T(j["px"]), T(m), cfg.particle_dx**2, T(sphi), T(j["lphi"]), T(j["lvol"]), w,
                          g.bound_min, g.cell_size, **kw)
    assert int(td.stats.iters) == int(j["dres"].stats.iters) > 0
    _close(td.px.numpy(), j["dres"].px, "density positions")
    tv = viscosity_solve_2d(dt, ph.mu, ph.rho, tuple(T(a) for a in j["gv"]), T(sphi), T(j["lvol2"]), g.cell_vol,
                            **kw)
    assert int(tv.stats.iters) == int(j["vres"].stats.iters) > 0
    for a in range(2):
        _close(tv.v_faces[a].numpy(), j["vres"].v_faces[a], f"viscosity face {a}")
    tp = pressure_solve_2d(tuple(T(a) for a in j["vres"].v_faces), T(sv), T(j["lphi2"]), w, g.cell_size, **kw)
    assert int(tp.stats.iters) == int(j["pres"].stats.iters) > 0
    _close(tp.pressure.numpy(), j["pres"].pressure, "pressure")
    for a in range(2):
        _close(tp.v_faces[a].numpy(), j["pres"].v_faces[a], f"pressure face {a}")


def test_viscosity_2d_strict_fluid_at_zero():
    """The 2D fluid test is strict: sphi == 0 is solid (tests/test_2d.py's
    sign-convention case), so every row is inactive; the 3D test keeps it
    fluid."""
    n2 = (12, 12)
    dual = tuple(2 * k + 1 for k in n2)
    shapes = [tuple(n + (1 if i == a else 0) for i, n in enumerate(n2)) for a in range(2)]
    v = tuple(torch.ones(s) for s in shapes)
    out = viscosity_matvec_2d(v, 0.1, torch.zeros(dual), torch.ones(dual), strict_fluid=True)
    assert all(float(o.abs().max()) == 0.0 for o in out)
    assert any(float(o.abs().max()) > 0.0 for o in viscosity_matvec_2d(v, 0.1, torch.zeros(dual), torch.ones(dual)))


@pytest.mark.parametrize("scene", ["dam", "droplet"])
def test_step_2d_matches_jax_simulate_2d(jax_runs, scene):
    j_s0, j_final, j_metrics = jax_runs[scene]
    _, cfg = _cfgs(scene == "droplet")
    maker = step2d.droplet_scene_2d if scene == "droplet" else step2d.dam_break_scene_2d
    _, s0 = maker(cfg, device="cpu")
    for k in "xvcm":  # the scenes are bitwise the JAX scenes
        np.testing.assert_array_equal(getattr(s0.particles, k).numpy(), np.asarray(getattr(j_s0.particles, k)))
    for k in ("phi", "v", "rb"):
        np.testing.assert_allclose(getattr(s0.solid, k).numpy(), np.asarray(getattr(j_s0.solid, k)), atol=1e-6)
    final, metrics = step2d.simulate_2d(_port_state(j_s0), cfg, 8 if scene == "dam" else 5)
    assert set(metrics) == set(j_metrics)
    for k in ("density_iters", "viscosity_iters", "pressure_iters"):
        np.testing.assert_array_equal(metrics[k].numpy(), j_metrics[k], err_msg=k)
    np.testing.assert_allclose(metrics["dt"].numpy(), j_metrics["dt"], rtol=1e-6)
    for k, tol in STEP_TOL.items():
        np.testing.assert_allclose(getattr(final.particles, k).numpy(), np.asarray(getattr(j_final.particles, k)),
                                   atol=tol, err_msg=k)
    assert int(final.step_idx) == int(j_final.step_idx)


def test_make_step_2d_is_the_eager_step_on_cpu():
    _, cfg = _cfgs()
    _, s0 = step2d.dam_break_scene_2d(cfg, device="cpu")
    step = step2d.make_step_2d(cfg)
    a, ma = step(s0)
    b, mb = step2d.step_2d(s0, cfg)
    for k in "xvcm":
        assert torch.equal(getattr(a.particles, k), getattr(b.particles, k)), k
    assert all(torch.equal(ma[k], mb[k]) for k in mb)
    c, mc = step2d.simulate_2d(s0, cfg, 2)
    d, _ = step2d.step_2d(step(s0)[0], cfg)
    for k in "xvc":
        assert torch.equal(getattr(c.particles, k), getattr(d.particles, k)), k
    assert mc["pressure_iters"].shape == (2,) and int(c.step_idx) == 2


def test_simulate_2d_capture_keys_and_branch():
    """`simulate_2d`'s held replayer (checked on the CPU, where a replayer
    only allocates its input buffers): kept for an equal config and the
    same shapes, replaced otherwise, no geometry built, and one graph
    whatever the config's viscosity preconditioner, so no replay reads the
    state's 'auto' flag on the host."""
    _, cfg = _cfgs()
    _, s0 = step2d.dam_break_scene_2d(cfg, device="cpu")
    held = step2d.SimulateCapture(step2d.StepReplayer2D)
    rep = held.replayer_for(cfg, s0)
    assert isinstance(rep, step2d.StepReplayer2D) and rep.geom is None
    assert held.replayer_for(dataclasses.replace(cfg), s0) is rep
    auto = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_precond="auto"))
    rep_auto = held.replayer_for(auto, dataclasses.replace(s0, visc_mg=torch.tensor(2, dtype=torch.int32)))
    assert rep_auto is not rep and held.replayers == 2
    assert rep_auto.branch(torch.tensor(2, dtype=torch.int32)) is None
    held.clear()
    assert held.replayer is None


@pytest.mark.parametrize("shifts, combine, fill, grid", [
    ([(-1, 0)] * 2, "add", 0.0, (66, 66)),  # P2G and the volume at 64x64 (extended grid)
    ([(-2, -1, 0)] * 2, "add", 0.0, (66, 66)),  # the density scatter
    ([tuple(range(-2, 3))] * 2, "min", 0.125, (64, 64)),  # the level set, 25 shifts
    ([(-1, 0)] * 2, "add", 0.0, (258, 258)),  # the volume at 256x256
])
def test_2d_fold_lifts_to_the_3d_kernel(shifts, combine, fill, grid):
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import live_table_model as model

    gen = torch.Generator().manual_seed(len(shifts[0]) + grid[0])
    n_ch = len(shifts[0]) ** 2
    m = grid[0] * grid[1]
    ids = torch.sort(torch.randint(0, m, (m // 3,), generator=gen))[0]
    table = dataclasses.replace(scan_reduce_plain(torch.randn(ids.shape[0], n_ch, generator=gen), ids, m, combine,
                                                  fill), grid_shape=grid)
    out = tuple(n - 2 for n in grid) if combine == "add" else grid
    want = fold_plain(table, shifts, out, combine, fill)
    seg3, shifts3, out3 = lift_2d(table, shifts, out)
    assert seg3.slot is table.slot and seg3.shape == (n_ch, 1) + grid
    got = [fold_plain(seg3, shifts3, out3, combine, fill), model.fold_live_model(seg3, shifts3, out3, combine, fill),
           fold_plain(lift_2d(table.dense(), shifts, out)[0], shifts3, out3, combine, fill)]
    for g in got:
        assert torch.equal(g.reshape(out).view(torch.int32), want.view(torch.int32))
    _, box, smem = model.fold_boxes(seg3.grid_shape, shifts3, out3)
    assert box[0] == 1 and smem <= model.SMEM_CAP
