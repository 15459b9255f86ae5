"""The PyTorch port's sharded step, ``step_3d(mesh=)``, on CPU.

The scene is the JAX package's multichip dry run's (``__graft_entry__.py
:113-115``): the dam break at dx = 1/32 (32^3 cells, 10,648 particles),
mu 0.5, CFL dt.  Two steps of the port's ``simulate(mesh=)`` on
``make_mesh(4, "cpu")`` and ``make_mesh2d((2, 2), "cpu")`` (all three
solves distributed) are held against:

* two steps of the JAX package's unsharded ``simulate`` from the same
  state, with ``ops/scatter.py::segment_sum_sorted`` replaced inside the
  test by the exact ``jax.ops.segment_sum`` (as
  ``tests/test_torch_flagship.py`` does);
* two steps of the port's unsharded ``simulate``.

Both at the JAX package's sharded-vs-single bars, |dx| < 2e-4 and
|dv| < 2e-3 (``__graft_entry__.py:158-159``,
``tests/test_parallel.py:184-190``).  On a 3-slot mesh
``shard_state`` pads the particles as the JAX package's does (bitwise),
and the padding particles stay inert: the real particles meet the same
bars and the padding keeps zero mass.  The learned modes run under a
mesh, and bucketing on an (x, z) mesh, each against the port's
unsharded step at the same bars.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu_torch.config import GridConfig3D, PhysicsConfig, SimConfig, SolverConfig
from python_fluid_simulation_tpu_torch.convert import state_from_numpy
from python_fluid_simulation_tpu_torch.engine.step import simulate, step_3d
from python_fluid_simulation_tpu_torch.parallel.halo_rdma import halo_exchange_rdma
from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, make_mesh2d, shard_state

torch.set_num_threads(1)

DX_BAR, DV_BAR = 2e-4, 2e-3
STEPS = 2


def _cfg():
    dx = 1.0 / 32
    return SimConfig(
        grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=dx),
        physics=PhysicsConfig(rho=1000.0, mu=0.5, dt=1.0 / 120.0),
        solver=SolverConfig(max_iter=300),
        particle_dx=dx / 2,
        dt_mode="cfl",
    )


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


def _numpy_state(j_state):
    return {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx,
    }


@pytest.fixture(scope="module")
def runs():
    """The JAX unsharded run (exact sums), the port's start state and its
    unsharded run."""
    from __graft_entry__ import _coarse_cfg
    from python_fluid_simulation_tpu.engine.scenes import dam_break_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    mp = pytest.MonkeyPatch()
    mp.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    jax.clear_caches()  # no step traced before the patch may be reused
    try:
        j_state = j_scene(_coarse_cfg(dx=1.0 / 32))
        j_final, j_metrics = j_simulate(j_state, _coarse_cfg(dx=1.0 / 32), STEPS)
        j_final = jax.device_get(j_final)
    finally:
        jax.clear_caches()
        mp.undo()
    start = state_from_numpy({k: np.asarray(v) for k, v in _numpy_state(j_state).items()}, device="cpu")
    final, metrics = simulate(start, _cfg(), STEPS)
    return dict(j_final=j_final, j_metrics=j_metrics, start=start, final=final, metrics=metrics)


@pytest.fixture(scope="module")
def sharded(runs):
    out = {}
    for kind, mesh in (("1d", make_mesh(4, "cpu")), ("2d", make_mesh2d((2, 2), "cpu"))):
        out[kind] = simulate(shard_state(runs["start"], mesh), _cfg(), STEPS, mesh=mesh)
    return out


def _errs(a, b, n):
    return (float((a.particles.x[:n] - b.particles.x[:n]).abs().max()),
            float((a.particles.v[:n] - b.particles.v[:n]).abs().max()))


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_sharded_step_matches_jax_unsharded(runs, sharded, kind):
    final, metrics = sharded[kind]
    n = runs["start"].particles.x.shape[0]
    assert final.particles.x.shape[0] == n  # 10,648 divides four slots: no padding
    j = runs["j_final"]
    dx = float(np.abs(final.particles.x.numpy() - np.asarray(j.particles.x)).max())
    dv = float(np.abs(final.particles.v.numpy() - np.asarray(j.particles.v)).max())
    assert dx < DX_BAR and dv < DV_BAR, (dx, dv)
    for solver in ("density", "viscosity", "pressure"):
        assert metrics[f"{solver}_converged"].all()
    assert int(metrics["density_iters"].sum()) > 0 and int(metrics["viscosity_iters"][-1]) > 0


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_sharded_step_matches_port_unsharded(runs, sharded, kind):
    final, metrics = sharded[kind]
    n = runs["start"].particles.x.shape[0]
    dx, dv = _errs(final, runs["final"], n)
    assert dx < DX_BAR and dv < DV_BAR, (dx, dv)
    for solver in ("density", "viscosity", "pressure"):
        got, want = metrics[f"{solver}_iters"].numpy(), runs["metrics"][f"{solver}_iters"].numpy()
        assert np.all(np.abs(got - want) <= 2), (solver, got, want)


def test_shard_state_pads_as_jax(runs):
    from python_fluid_simulation_tpu.engine.scenes import dam_break_scene as j_scene
    from python_fluid_simulation_tpu.parallel.mesh import make_mesh as j_make_mesh
    from python_fluid_simulation_tpu.parallel.mesh import shard_state as j_shard_state
    from __graft_entry__ import _coarse_cfg

    want = j_shard_state(j_scene(_coarse_cfg(dx=1.0 / 32)), j_make_mesh(3))
    got = shard_state(runs["start"], make_mesh(3, "cpu"))
    assert got.particles.x.shape[0] == 10650  # 10,648 + 2
    for k in ("x", "v", "c", "m"):
        np.testing.assert_array_equal(getattr(got.particles, k).numpy(), np.asarray(getattr(want.particles, k)))


def test_padding_particles_stay_inert(runs):
    mesh = make_mesh(3, "cpu")  # 10,648 particles pad to 10,650; 32 x-planes pad to 33
    n = runs["start"].particles.x.shape[0]
    final, metrics = simulate(shard_state(runs["start"], mesh), _cfg(), STEPS, mesh=mesh)
    dx, dv = _errs(final, runs["final"], n)
    assert dx < DX_BAR and dv < DV_BAR, (dx, dv)
    assert torch.equal(final.particles.m[n:], torch.zeros(2))
    assert torch.isfinite(final.particles.x[n:]).all() and torch.isfinite(final.particles.v[n:]).all()
    assert metrics["density_converged"].all() and metrics["pressure_converged"].all()


def test_cpu_mesh_launches_no_kernel(runs):
    launches = halo_exchange_rdma.launches
    step_3d(shard_state(runs["start"], make_mesh(2, "cpu")), _cfg(), mesh=make_mesh(2, "cpu"))
    assert halo_exchange_rdma.launches == launches


@pytest.mark.parametrize("mode", ["unet", "unet_warm"])
def test_learned_modes_under_a_mesh_raise(runs, mode):
    """The learned modes under a mesh raise nothing: one step of each
    (from the port's state after two steps) on a 2-slot mesh and on (2, 2) (a width-4 network, seeded Flax weights
    through ``convert.py``) within MESH_DX / MESH_DV of the port's
    unsharded step of that mode, every solve converged.
    (tests/test_torch_mesh_learned.py holds them against JAX.)"""
    from python_fluid_simulation_tpu_torch.convert import random_flax_unet_params, unet_state_dict_from_flax
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    net = UNet3D(width=4).eval()
    net.load_state_dict(unet_state_dict_from_flax(random_flax_unet_params(4, seed=1)))
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_mode=mode))
    start = runs["final"]  # after two steps: the viscosity solve has work
    ref, _ = step_3d(start, cfg, unet=net)
    n = start.particles.x.shape[0]
    for mesh in (make_mesh(2, "cpu"), make_mesh2d((2, 2), "cpu")):
        out, m = step_3d(shard_state(start, mesh), cfg, unet=net, mesh=mesh)
        assert all(bool(m[f"{k}_converged"]) for k in ("density", "viscosity", "pressure"))
        assert (int(m["viscosity_iters"]) == 0) == (mode == "unet")
        dx, dv = _errs(out, ref, n)
        assert dx < DX_BAR and dv < DV_BAR, (mesh, dx, dv)


def test_bucketed_raises(runs):
    """Bucketed residency runs on an (x, z) mesh (one step, masses made
    unique, against the port's unsharded step by mass, nothing lost); it
    still needs a mesh, and the mesh's slot 0 must hold the state."""
    from python_fluid_simulation_tpu_torch.parallel import particles2d as p2d

    start = runs["start"]
    n = start.particles.x.shape[0]
    pm = start.particles.m * (1.0 + 1e-6 * torch.arange(n, dtype=torch.float32))
    start = dataclasses.replace(start, particles=dataclasses.replace(start.particles, m=pm))
    mesh, g = make_mesh2d((2, 2), "cpu"), _cfg().grid
    spec = p2d.make_bucket_spec_2d((2, 2), g.res[0], g.res[2], n, positions=start.particles.x, bound_min=g.bound_min,
                                   cell_size=g.cell_size)
    sharded = shard_state(start, mesh)
    b = dataclasses.replace(sharded, particles=p2d.bucket_particles_2d(sharded.particles, mesh, spec, g.bound_min,
                                                                       g.cell_size))
    out, m = step_3d(b, _cfg(), mesh=mesh, bucketed=True)
    ref, _ = step_3d(start, _cfg())
    assert int(m["bucket_lost"]) == 0
    live = out.particles.m > 0
    ob, ou = torch.argsort(out.particles.m[live]), torch.argsort(ref.particles.m)
    assert torch.equal(out.particles.m[live][ob], ref.particles.m[ou])
    for k, bar in (("x", DX_BAR), ("v", DV_BAR)):
        err = float((getattr(out.particles, k)[live][ob] - getattr(ref.particles, k)[ou]).abs().max())
        assert err < bar, (k, err)
    with pytest.raises(ValueError, match="needs a mesh"):
        step_3d(runs["start"], _cfg(), bucketed=True)
    with pytest.raises(ValueError, match="slot 0"):
        step_3d(runs["start"], _cfg(), mesh=make_mesh(2))  # the mesh's slots are on the card
