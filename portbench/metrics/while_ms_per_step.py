"""while_ms_per_step: the WHILE nodes' device milliseconds a step (the
generic CG loops of the multigrid cell solves), from the program's
stamps just before and just after each node
(``python_fluid_simulation_tpu_torch/utils/timers.py``: loop counters),
every iteration included, over the blocks timed without the profiler
just before the traced ones (``stamps.py``).  Nothing where the program
has no stamps or the graph no WHILE node."""

from portbench.stamps import per_step, untraced


def read(ctx):
    blocks = untraced(ctx)
    if blocks is None or not any(b.loops for b in blocks):
        return None
    return 1e-6 * per_step(blocks, lambda b: b.while_ns)
