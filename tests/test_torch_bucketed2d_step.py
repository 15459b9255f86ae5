"""The bucketed step on an (x, z) mesh, ``step_3d(mesh=make_mesh2d(...),
bucketed=True)``, on the CPU.

* One step on tests/test_torch_bucketed.py's scene (the dam break at dx
  1/16, 16^3 cells, masses made unique) on ``make_mesh2d((4, 2), "cpu")``
  (slabs 4 x 8) against JAX ``make_step(cfg, mesh=make_mesh2d((4, 2)),
  bucketed=True)`` from the same bucketed state: the same particle set,
  matched by mass, |dx| < 2e-4 m, |dv| < 2e-3 m/s (the JAX package's
  sharded-vs-single bars), ``bucket_lost`` 0 on both sides, every solve
  converged; and the same bucketing of the scene, bitwise.
* On slabs of odd widths (3 and 5 cells, as coiling_config(504)'s 63 x
  63 on (2, 2)): two bucketed dam-break steps against the port's
  unsharded steps from the same particles, at the same bars.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.parallel import mesh as j_mesh
from python_fluid_simulation_tpu.parallel import particles2d as j_p2d
from python_fluid_simulation_tpu_torch.config import GridConfig3D, PhysicsConfig, SimConfig, SolverConfig
from python_fluid_simulation_tpu_torch.engine.scenes import dam_break_scene
from python_fluid_simulation_tpu_torch.engine.step import simulate, step_3d
from python_fluid_simulation_tpu_torch.parallel import particles2d as p2d
from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh2d, shard_state
from python_fluid_simulation_tpu_torch.state import Particles

torch.set_num_threads(1)

DX_BAR, DV_BAR = 2e-4, 2e-3


def _matched(x, v, m):
    """(x, v, m) of the live rows, ordered by (unique) mass."""
    live = m > 0
    order = np.argsort(m[live])
    return x[live][order], v[live][order], m[live][order]


def test_bucketed_2d_step_matches_jax_bucketed_make_step():
    from python_fluid_simulation_tpu.config import GridConfig3D as JGrid
    from python_fluid_simulation_tpu.config import PhysicsConfig as JPhysics
    from python_fluid_simulation_tpu.config import SimConfig as JSimConfig
    from python_fluid_simulation_tpu.config import SolverConfig as JSolver
    from python_fluid_simulation_tpu.engine.scenes import dam_break_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import make_step as j_make_step
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy

    j_cfg = JSimConfig(grid=JGrid(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1.0 / 16),
                       physics=JPhysics(mu=0.2, dt=1.0 / 60.0), solver=JSolver(max_iter=200), particle_dx=1.0 / 32)
    cfg = SimConfig.from_json(j_cfg.to_json())
    state = j_scene(j_cfg)
    n = state.particles.x.shape[0]
    pm = np.asarray(state.particles.m) * (1.0 + 1e-4 * np.arange(n, dtype=np.float32))
    g = j_cfg.grid
    jm, tm = j_mesh.make_mesh2d((4, 2)), make_mesh2d((4, 2), "cpu")
    spec = p2d.make_bucket_spec_2d((4, 2), g.res[0], g.res[2], n, positions=np.asarray(state.particles.x),
                                   bound_min=g.bound_min, cell_size=g.cell_size)
    assert (spec.slab_wx, spec.slab_wz) == (4, 8)
    jp = j_p2d.bucket_particles_2d(state.particles._replace(m=jnp.asarray(pm)), jm, j_p2d.BucketSpec2D(*spec),
                                   g.bound_min, g.cell_size)
    out_j, m_j = j_make_step(j_cfg, mesh=jm, bucketed=True)(state._replace(particles=jp))
    assert int(m_j["bucket_lost"]) == 0
    jp = jax.device_get(jp)
    tp = p2d.bucket_particles_2d(Particles(*(torch.from_numpy(np.array(a)) for a in (
        state.particles.x, state.particles.v, state.particles.c, pm))), tm, spec, g.bound_min, g.cell_size)
    for k in "xvcm":
        assert np.array_equal(getattr(tp, k).numpy(), np.asarray(getattr(jp, k))), k
    start = {"x": jp.x, "v": jp.v, "c": jp.c, "m": jp.m, "phi": state.solid.phi, "sv": state.solid.v,
             "rb": state.solid.rb, "t": state.t, "step_idx": state.step_idx}
    out, m = step_3d(state_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu"), cfg, mesh=tm,
                     bucketed=True)
    assert int(m["bucket_lost"]) == 0 and m["bucket_lost"].dtype == torch.int32
    for k in ("density", "viscosity", "pressure"):
        assert bool(m[f"{k}_converged"]) and bool(m_j[f"{k}_converged"]), k
    xb, vb, mb = _matched(out.particles.x.numpy(), out.particles.v.numpy(), out.particles.m.numpy())
    xj, vj, mj = _matched(*(np.asarray(getattr(out_j.particles, k)) for k in "xvm"))
    assert mb.shape == (n,)
    np.testing.assert_array_equal(mb, mj)  # the same particle set
    dx, dv = float(np.abs(xb - xj).max()), float(np.abs(vb - vj).max())
    assert dx < DX_BAR and dv < DV_BAR, (dx, dv)


@pytest.mark.parametrize("shape, res", [((5, 3), 15), ((3, 5), 15)])
def test_bucketed_2d_steps_on_odd_slabs_match_the_unsharded_steps(shape, res):
    """Slabs 3 x 5 and 5 x 3 cells: two bucketed dam-break steps (masses
    made unique) through ``simulate(mesh=, bucketed=True)`` against the
    port's unsharded steps from the same particles, with nothing lost."""
    cfg = SimConfig(grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1.0 / res),
                    physics=PhysicsConfig(mu=0.2, dt=1.0 / 60.0), solver=SolverConfig(max_iter=200),
                    particle_dx=0.5 / res)
    state = dam_break_scene(cfg, device="cpu")
    n = state.particles.x.shape[0]
    pm = state.particles.m * (1.0 + 1e-4 * torch.arange(n, dtype=torch.float32))
    state = dataclasses.replace(state, particles=dataclasses.replace(state.particles, m=pm))
    g, tm = cfg.grid, make_mesh2d(shape, "cpu")
    spec = p2d.make_bucket_spec_2d(shape, g.res[0], g.res[2], n, positions=state.particles.x, bound_min=g.bound_min,
                                   cell_size=g.cell_size)
    assert spec.slab_wx % 2 == 1 and spec.slab_wz % 2 == 1
    sharded = shard_state(state, tm)
    b = dataclasses.replace(sharded, particles=p2d.bucket_particles_2d(sharded.particles, tm, spec, g.bound_min,
                                                                       g.cell_size))
    u = state
    for _ in range(2):
        b, m = simulate(b, cfg, 1, mesh=tm, bucketed=True)
        u, _ = step_3d(u, cfg)
        assert int(m["bucket_lost"][0]) == 0
        assert all(bool(m[f"{k}_converged"][0]) for k in ("density", "viscosity", "pressure"))
        xb, vb, mb = _matched(b.particles.x.numpy(), b.particles.v.numpy(), b.particles.m.numpy())
        xu, vu, mu = _matched(u.particles.x.numpy(), u.particles.v.numpy(), u.particles.m.numpy())
        np.testing.assert_array_equal(mb, mu)  # the same particle set
        for name, got, want, bar in (("x", xb, xu, DX_BAR), ("v", vb, vu, DV_BAR)):
            err = float(np.abs(got - want).max())
            assert err < bar, (name, err)
