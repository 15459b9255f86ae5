"""The frozen reference against the JAX package, the port's origin, with
no code of either package on this side: two steps of the coarse
buckling scene (dx 0.05: 12x20x12 cells, 1,424 particles) from the JAX
scene's start state, with Jacobi and with multigrid cell solves,
against the JAX package's own two steps stored in
``data/jax_buckling_dx005.npz``.

The data holds the JAX scene's start state (``start_*``), the two
configurations as JSON (``<precond>_config``) and, for each, the
particles after two steps and each step's dt and iterations.  It was
written on the CPU by the JAX package's
``engine.step.simulate(buckling_scene(cfg), cfg, 2)`` for
``cfg = buckling_config(dx=0.05)`` with ``solver.precond`` set to
'jacobi' and to 'mg'.

The reference builds its own solid level set from the stored body
table and seeds the particles with its own copy of the seeding.  The
tolerances are those the port's own tests hold it to against JAX
(``tests/test_torch_step.py``): x 1e-5 m, v 1e-4 m/s, APIC rows 1e-3
1/s, iterations within 2, dt to 1e-6."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.inputs import BodyTable
from portbench.reference import config as rconfig
from portbench.reference import state as rstate
from portbench.reference.engine.step import build_geom_cache, step_3d

DATA = Path(__file__).resolve().parent / "data" / "jax_buckling_dx005.npz"
TOL = {"x": 1e-5, "v": 1e-4, "c": 1e-3}
ITERS = ("density_iters", "viscosity_iters", "pressure_iters")


@pytest.fixture(scope="module")
def jax_run():
    with np.load(DATA) as data:
        return {k: data[k] for k in data.files}


def _start(jax_run, cfg):
    solid = rstate.make_solid_state(cfg, BodyTable(jax_run["start_rb"]), device="cpu")
    p = rstate.Particles(*(torch.from_numpy(jax_run[f"start_{k}"]) for k in ("x", "v", "c", "m")))
    return rstate.SimState(particles=p, solid=solid, t=torch.from_numpy(jax_run["start_t"]),
                           step_idx=torch.from_numpy(jax_run["start_step_idx"]),
                           visc_mg=torch.zeros((), dtype=torch.int32))


def test_solids_and_seeding_match_jax(jax_run):
    cfg = rconfig.SimConfig.from_json(str(jax_run["jacobi_config"]))
    solid = rstate.make_solid_state(cfg, BodyTable(jax_run["start_rb"]), device="cpu")
    np.testing.assert_allclose(solid.phi.numpy(), jax_run["start_phi"], atol=1e-6)
    pos = rstate.seed_particle_box(center=[0.0, 0.65, 0.0], size=[0.3, 0.3, 0.3], dx=cfg.particle_dx,
                                   rb_table=jax_run["start_rb"], seed=0)
    np.testing.assert_array_equal(pos.astype(np.float32), jax_run["start_x"])


@pytest.mark.parametrize("precond", ["jacobi", "mg"])
def test_two_reference_steps_match_jax(jax_run, precond):
    torch.set_num_threads(1)
    cfg = rconfig.SimConfig.from_json(str(jax_run[f"{precond}_config"]))
    assert cfg.solver.precond == precond
    state = _start(jax_run, cfg)
    geom = build_geom_cache(state.solid)
    for i in range(2):
        state, m = step_3d(state, cfg, geom=geom)
        assert abs(float(m["dt"]) - float(jax_run[f"{precond}_dt"][i])) <= 1e-6 * float(jax_run[f"{precond}_dt"][i])
        for k in ITERS:
            assert abs(int(m[k]) - int(jax_run[f"{precond}_{k}"][i])) <= 2, (k, i)
    assert int(jax_run[f"{precond}_viscosity_iters"][1]) > 0  # the second step really solves
    for k, tol in TOL.items():
        got = getattr(state.particles, k).numpy()
        np.testing.assert_allclose(got, jax_run[f"{precond}_{k}"], atol=tol, rtol=0, err_msg=k)
