"""A guard on the port's CPU steps against one fault class: a Python scalar
divided by a tensor.

PyTorch evaluates ``c / t`` (``Tensor.__rdiv__`` / ``__rtruediv__``) as
``t.reciprocal() * c``: two roundings, one ulp off the quotient on about
a quarter of inputs, where the JAX package's ``c / t`` divides once.  The
CFL step size was written that way once (ROADMAP queue 3 item 7); it is
now ``torch.div(c, t)``.  A numerator of 1 is the reciprocal itself, one
rounding.  Here a coarse 3D step, a 64x64 2D step and a coarse sharded
step run on the CPU under a ``TorchFunctionMode`` that records every
scalar-over-tensor division: none may have a numerator other than 1.
"""

import pytest
import torch
from torch.overrides import TorchFunctionMode

from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
from python_fluid_simulation_tpu_torch.engine.step import simulate
from python_fluid_simulation_tpu_torch.engine.step2d import SimConfig2D, dam_break_scene_2d, simulate_2d
from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, shard_state

torch.set_num_threads(1)

RDIV = ("__rdiv__", "__rtruediv__")


class ScalarOverTensor(TorchFunctionMode):
    """Records the numerator of every ``scalar / tensor`` and counts the
    calls it sees."""

    def __init__(self):
        super().__init__()
        self.numerators, self.calls = [], 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls += 1
        if getattr(func, "__name__", "") in RDIV:
            self.numerators.append(args[1])
        return func(*args, **(kwargs or {}))


def _two_roundings(numerators):
    return [n for n in numerators if not (isinstance(n, (int, float)) and n == 1)]


def test_the_guard_sees_a_scalar_over_a_tensor():
    t = torch.full((3,), 3.0)
    with ScalarOverTensor() as mode:
        _ = 1 / t + 1.0 / t
        _ = torch.div(0.05, t)  # one rounding: not recorded
        _ = 0.05 / t
    assert mode.numerators == [1, 1.0, 0.05]
    assert _two_roundings(mode.numerators) == [0.05]


@pytest.mark.parametrize("case", ["3d", "2d", "sharded"])
def test_steps_divide_no_scalar_by_a_tensor(case):
    if case == "2d":
        cfg, state = dam_break_scene_2d(SimConfig2D(), device="cpu")  # 64x64 cells
        with ScalarOverTensor() as mode:
            _, metrics = simulate_2d(state, cfg, 1)
    else:
        cfg = buckling_config(dx=0.05)  # 12x20x12 cells, 1,424 particles
        state = buckling_scene(cfg, device="cpu")
        mesh = make_mesh(4, "cpu") if case == "sharded" else None
        if mesh is not None:
            state = shard_state(state, mesh)
        with ScalarOverTensor() as mode:
            _, metrics = simulate(state, cfg, 2, mesh=mesh)
        assert int(metrics["viscosity_iters"][1]) > 0  # the second step solves
    assert mode.calls > 1000
    assert _two_roundings(mode.numerators) == []
