"""grid_ms_per_step: the particles and grids layer's device milliseconds
a step, read from the program's own phase stamps
(``python_fluid_simulation_tpu_torch/utils/timers.py``: one one-thread
kernel node at each phase boundary of the replayed step, accumulating
``%globaltimer`` nanoseconds on the card): dt, advect, levelset, p2g,
extrapolate, boundary, g2p and finish, over the blocks timed without the
profiler just before the traced ones (``stamps.py``).  Nothing where the
program has no stamps."""

from portbench.stamps import per_step, untraced


def read(ctx):
    blocks = untraced(ctx)
    return None if blocks is None else 1e-6 * per_step(blocks, lambda b: b.grid_ns)
