"""solve_ms_per_step: the solvers layer's device milliseconds a step,
read from the program's own phase stamps
(``python_fluid_simulation_tpu_torch/utils/timers.py``): the density,
viscosity and pressure phases (each solve with its wrapper's set-up),
over the blocks timed without the profiler just before the traced ones
(``stamps.py``).  Nothing where the program has no stamps."""

from portbench.stamps import per_step, untraced


def read(ctx):
    blocks = untraced(ctx)
    return None if blocks is None else 1e-6 * per_step(blocks, lambda b: b.solve_ns)
