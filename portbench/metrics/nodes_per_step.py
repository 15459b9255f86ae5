"""nodes_per_step: CUDA graph nodes executed a step, the phase stamps
excluded: the replayed graphs' top-level nodes (counted on the host at
each replay) plus each WHILE body's nodes times its iterations (counted
on the device by the stamp after the node,
``python_fluid_simulation_tpu_torch/utils/timers.py``), over the blocks
timed without the profiler just before the traced ones (``stamps.py``).
Nothing where the program has no such counter."""

from portbench.stamps import per_step, untraced


def read(ctx):
    blocks = untraced(ctx)
    return None if blocks is None else per_step(blocks, lambda b: b.nodes)
