"""Moving solids in the port (``SimConfig.moving_solid``) against the JAX
package, on CPU.

* ``ops/sdf.py::advance_rigid_bodies`` equals JAX's bit for bit on a
  seeded table, with dt a float or a 0-dim tensor.
* ``moving_box_config`` equals JAX's field for field, and
  ``moving_box_scene`` seeds exactly the JAX scene (as
  ``test_flagship_scene_matches_jax_exactly`` holds the buckling scene).
* 3 steps of the port's ``simulate`` on ``moving_box_config(dx=1/8)``
  (8^3 cells, a sinking box over a pool) against JAX ``simulate`` from
  the same state: x atol 1e-5 m, v atol 1e-4 m/s, APIC rows atol 1e-3
  1/s (the step tests' bounds), the rigid-body table atol 1e-6, the same
  iterations.
* the port's copy of JAX ``tests/test_step.py::
  test_moving_solid_matches_host_driven_stepping``: stepping with
  ``moving_solid`` equals the host-driven loop that advances the body and
  re-evaluates the solid between static-geometry steps, and the body
  moves.
* the moving box under a mesh: 2 steps of ``moving_box_config(1/16)``
  (16^3 cells, 4,356 particles, the geometry rebuilt on the mesh every
  step) on the port's ``make_mesh(2, "cpu")``, sharded and bucketed,
  against JAX's bucketed ``step_3d(mesh=)`` over 2 of the 8 CPU devices
  (jitted through ``make_step``: its eager call cannot place the odd dual
  lattice over 2 slots; one JAX program, ~15-25 s to compile, holds both
  layouts, which differ from it by rounding) from the same particles,
  with ``ops/scatter.py::
  segment_sum_sorted`` replaced inside the test by the exact
  ``jax.ops.segment_sum`` (as ``tests/test_torch_mesh_step.py`` does):
  particles matched by (unique) mass within |dx| < 2e-4 m and |dv| <
  2e-3 m/s, the rigid bodies within 1e-6, no particle lost; and the
  port's ``make_step(mesh=)`` bitwise its ``step_3d(mesh=)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu_torch.convert import state_from_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import moving_box_config, moving_box_scene
from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu_torch.engine.step import make_step, simulate, step_3d
from python_fluid_simulation_tpu_torch.ops import sdf as sdf3d
from python_fluid_simulation_tpu_torch.ops.indexing import grid_positions
from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh
from python_fluid_simulation_tpu_torch.state import SimState, SolidState

torch.set_num_threads(1)

STEPS = 3
MESH_STEPS = 2
MESH_DX = 1.0 / 16
DX_BAR, DV_BAR = 2e-4, 2e-3  # tests/test_torch_mesh_step.py's (the JAX package's sharded-vs-single bars)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_advance_rigid_bodies_matches_jax_exactly(as_tensor):
    from python_fluid_simulation_tpu.ops.sdf import advance_rigid_bodies as j_advance

    rb = np.random.default_rng(3).standard_normal((4, 10, 4)).astype(np.float32)
    dt = np.float32(0.0123)
    want = np.asarray(j_advance(jnp.asarray(rb), jnp.float32(dt)))
    got = sdf3d.advance_rigid_bodies(torch.from_numpy(rb), torch.tensor(dt) if as_tensor else float(dt))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, rb)  # the translations moved
    empty = torch.zeros((0, 10, 4))
    assert sdf3d.advance_rigid_bodies(empty, float(dt)).shape == (0, 10, 4)


def test_moving_box_scene_matches_jax_exactly():
    from python_fluid_simulation_tpu.engine.scenes import moving_box_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import moving_box_scene as j_scene

    for dx in (1.0 / 16, 1.0 / 8):
        assert dataclasses.asdict(moving_box_config(dx=dx)) == dataclasses.asdict(j_cfg(dx=dx))
    cfg = moving_box_config()
    assert cfg.moving_solid and cfg.grid.res == (16, 16, 16)
    state = moving_box_scene(cfg, device="cpu")
    want = j_scene(j_cfg())
    assert state.particles.x.shape[0] > 1000
    np.testing.assert_array_equal(state.particles.x.numpy(), np.asarray(want.particles.x))
    np.testing.assert_array_equal(state.particles.m.numpy(), np.asarray(want.particles.m))
    np.testing.assert_array_equal(state.solid.rb.numpy(), np.asarray(want.solid.rb))
    np.testing.assert_allclose(state.solid.phi.numpy(), np.asarray(want.solid.phi), atol=1e-6)
    np.testing.assert_array_equal(state.solid.v.numpy(), np.asarray(want.solid.v))


def test_moving_box_simulate_matches_jax():
    from python_fluid_simulation_tpu.engine.scenes import moving_box_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import moving_box_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    j_state = j_scene(j_cfg(dx=1.0 / 8))
    j_final, j_metrics = j_simulate(j_state, j_cfg(dx=1.0 / 8), STEPS)
    start = {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx,
    }
    state = state_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu")
    final, metrics = simulate(state, moving_box_config(dx=1.0 / 8), STEPS)
    for k in ("density_iters", "viscosity_iters", "pressure_iters"):
        np.testing.assert_array_equal(metrics[k].numpy(), np.asarray(j_metrics[k]), err_msg=k)
    assert int(metrics["pressure_iters"][-1]) > 0
    np.testing.assert_allclose(final.particles.x.numpy(), np.asarray(j_final.particles.x), atol=1e-5)
    np.testing.assert_allclose(final.particles.v.numpy(), np.asarray(j_final.particles.v), atol=1e-4)
    np.testing.assert_allclose(final.particles.c.numpy(), np.asarray(j_final.particles.c), atol=1e-3)
    np.testing.assert_allclose(final.solid.rb.numpy(), np.asarray(j_final.solid.rb), atol=1e-6)
    np.testing.assert_allclose(final.solid.phi.numpy(), np.asarray(j_final.solid.phi), atol=1e-6)
    assert float(final.t) == pytest.approx(float(j_final.t), rel=1e-6)


def test_moving_solid_matches_host_driven_stepping():
    """cfg.moving_solid=True (the body advanced and the geometry rebuilt
    inside each step) equals the host-driven loop that advances the body
    and re-evaluates the solid state between static-geometry steps, and
    the body moves (JAX ``tests/test_step.py``'s test of the same name,
    on the port)."""
    cfg = moving_box_config(dx=1.0 / 8)
    state0 = moving_box_scene(cfg, device="cpu")
    out, _ = simulate(state0, cfg, STEPS)

    # host-driven equivalent: advance rb + re-evaluate the solid before
    # each static-geometry step, with the step's own CFL dt
    cfg_static = dataclasses.replace(cfg, moving_solid=False)
    g = cfg.grid
    cur = state0
    for _ in range(STEPS):
        vmax = float(np.max(np.linalg.norm(cur.particles.v.numpy(), axis=-1)))
        dt = min(cfg.physics.dt, g.dx / max(vmax, 1e-10), max(cfg.duration - float(cur.t), 1e-6))
        rb = sdf3d.advance_rigid_bodies(cur.solid.rb, dt)
        phi, vel = sdf3d.evaluate(rb, grid_positions(g.dual_res, g.bound_min, g.dual_cell_size, (0.0,) * 3))
        cur = SimState(particles=cur.particles, solid=SolidState(phi=phi, v=vel, rb=rb), t=cur.t,
                       step_idx=cur.step_idx)
        cur, _ = step_3d(cur, cfg_static)

    np.testing.assert_allclose(out.particles.x.numpy(), cur.particles.x.numpy(), atol=1e-5)
    # the body moved by sum(v dt) and the fluid felt it
    y0 = float(state0.solid.rb[1, 2, 3])
    y1 = float(out.solid.rb[1, 2, 3])
    assert y1 < y0 - 1e-3, (y0, y1)
    assert np.all(np.isfinite(out.particles.x.numpy()))


def _numpy_state(s):
    return {k: np.asarray(v) for k, v in {
        "x": s.particles.x, "v": s.particles.v, "c": s.particles.c, "m": s.particles.m,
        "phi": s.solid.phi, "sv": s.solid.v, "rb": s.solid.rb, "t": s.t, "step_idx": s.step_idx}.items()}


@pytest.fixture(scope="module")
def jax_mesh_run():
    """JAX's moving box on ``make_mesh(2)``, bucketed: the start state
    (unique masses m (1 + 1e-4 i)), its particles bucketed, and the state
    after `MESH_STEPS` steps, as numpy, with the exact segment sum; the
    particles it lost."""
    from python_fluid_simulation_tpu.engine.scenes import moving_box_config as j_cfg_of
    from python_fluid_simulation_tpu.engine.scenes import moving_box_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import make_step as j_make_step
    from python_fluid_simulation_tpu.parallel import mesh as j_mesh
    from python_fluid_simulation_tpu.parallel import particles as j_part

    j_cfg = j_cfg_of(dx=MESH_DX)
    g = j_cfg.grid
    j_state = j_scene(j_cfg)
    n = j_state.particles.x.shape[0]
    m = np.asarray(j_state.particles.m) * (1.0 + 1e-4 * np.arange(n, dtype=np.float32))
    j_state = j_state._replace(particles=j_state.particles._replace(m=jnp.asarray(m)), visc_mg=jnp.int32(0),
                               t=jnp.float32(j_state.t), step_idx=jnp.int32(j_state.step_idx))
    jm = j_mesh.make_mesh(2)
    j_state = j_mesh.shard_state(j_state, jm)
    # the scalars replicated over the mesh, as the step returns them: the
    # second step reuses the first one's program
    rep = NamedSharding(jm, PartitionSpec())
    j_state = j_state._replace(**{k: jax.device_put(getattr(j_state, k), rep) for k in ("visc_mg", "t", "step_idx")})
    start = _numpy_state(jax.device_get(j_state))
    spec = j_part.make_bucket_spec(2, g.res[0], n, positions=np.asarray(j_state.particles.x), bound_min=g.bound_min,
                                   cell_size=g.cell_size)
    s = j_state._replace(particles=j_part.bucket_particles(j_state.particles, jm, spec, g.bound_min, g.cell_size))
    bucketed_start = _numpy_state(jax.device_get(s))
    lost = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_scatter, "segment_sum_sorted", lambda vals, ids, num_segments, widen=False:
                   jax.ops.segment_sum(vals, ids, num_segments=num_segments, indices_are_sorted=True))
        jax.clear_caches()  # no step traced before the patch may be reused
        try:
            step = j_make_step(j_cfg, mesh=jm, bucketed=True)
            for _ in range(MESH_STEPS):
                s, metrics = step(s)
                lost += int(metrics["bucket_lost"])
        finally:
            jax.clear_caches()
    return {False: start, True: bucketed_start}, _numpy_state(jax.device_get(s)), lost


def _by_mass(d):
    live = d["m"] > 0
    order = np.argsort(d["m"][live])
    return {k: d[k][live][order] for k in ("x", "v", "m")}


@pytest.mark.parametrize("bucketed", [False, True], ids=["sharded", "bucketed"])
def test_moving_box_under_a_mesh_matches_jax(jax_mesh_run, bucketed):
    starts, want, j_lost = jax_mesh_run
    start = starts[bucketed]
    cfg = moving_box_config(dx=MESH_DX)
    mesh = make_mesh(2, "cpu")
    state = state_from_numpy(start, device="cpu")
    stepped = make_step(cfg, mesh=mesh, bucketed=bucketed)
    s, via_step, lost = state, state, 0
    for _ in range(MESH_STEPS):
        s, m = step_3d(s, cfg, mesh=mesh, bucketed=bucketed)
        via_step, m_step = stepped(via_step)
        lost += int(m.get("bucket_lost", torch.zeros(()))) + j_lost
        for k in ("x", "v", "c", "m"):
            assert torch.equal(getattr(via_step.particles, k), getattr(s.particles, k)), k
        assert torch.equal(via_step.solid.rb, s.solid.rb)
        assert all(torch.equal(m[k], m_step[k]) for k in m)
    assert lost == 0
    got, ref = _by_mass(_numpy_state(s)), _by_mass(want)
    np.testing.assert_array_equal(got["m"], ref["m"])  # the same particle set
    assert float(np.abs(got["x"] - ref["x"]).max()) < DX_BAR
    assert float(np.abs(got["v"] - ref["v"]).max()) < DV_BAR
    np.testing.assert_allclose(s.solid.rb.numpy(), want["rb"], atol=1e-6)
    assert float(s.solid.rb[1, 2, 3]) < float(start["rb"][1, 2, 3]) - 1e-3  # the box sank
    assert float(s.t) == pytest.approx(float(want["t"]), rel=1e-6)
