"""One flagship step (the 48x80x48 buckling funnel, 89,648 particles) of
the PyTorch port against one step of the JAX ``simulate``, from the same
scene state, on CPU.

The JAX package's CPU route of ``ops/scatter.py::segment_sum_sorted``
takes each segment's sum as a difference of one global cumsum, which is
off by rounding noise that grows with the particle count (a face can get
a tiny nonzero mass where the exact sum is 0, and the step's ``gm > 0``
masks then differ).  This test replaces it, inside the test only, by
``jax.ops.segment_sum``, whose sums run in row order as the port's do.

Bounds: iterations equal; x atol 1e-5 m, v atol 1e-4 m/s, APIC rows atol
1e-3 1/s — the coarse tests' bounds (tests/test_torch_step.py).  After
one step the measured differences are x 1.2e-7, v 3.3e-7 and rows 9.1e-5
(entries up to ~2), so the rows bound holds with a factor of ~10.
"""

import jax
import numpy as np
import torch

from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu_torch.convert import state_from_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config
from python_fluid_simulation_tpu_torch.engine.step import simulate

torch.set_num_threads(1)

STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


def test_flagship_step_matches_exact_sum_jax(monkeypatch):
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    jax.clear_caches()  # no step traced before the patch may be reused
    try:
        j_state = j_scene(j_cfg())
        j_final, j_metrics = j_simulate(j_state, j_cfg(), 1)
        j_final = jax.device_get(j_final)
    finally:
        jax.clear_caches()
    start = {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx,
    }
    state = state_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu")
    final, metrics = simulate(state, buckling_config(), 1)
    assert final.particles.x.shape == (89648, 3)
    for solver in ("density", "viscosity", "pressure"):
        np.testing.assert_array_equal(metrics[f"{solver}_iters"].numpy(), np.asarray(j_metrics[f"{solver}_iters"]))
        assert metrics[f"{solver}_converged"].all()
    for k, tol in STEP_TOL.items():
        np.testing.assert_allclose(getattr(final.particles, k).numpy(), np.asarray(getattr(j_final.particles, k)),
                                   atol=tol, err_msg=k)
