"""The blocks the phase-clock readers read (``metrics/grid_ms_per_step.py``,
``solve_ms_per_step.py``, ``while_ms_per_step.py``, ``nodes_per_step.py``).

The port records each ``simulate`` call in a ring
(``python_fluid_simulation_tpu_torch/utils/timers.py::RECORDER``): its
steps, whether a profiler was recording, and its phase clocks.  A traced
run times ``TRACE_BLOCKS`` blocks without the profiler, then as many under
it; the readers take the first half, so the profiler's cost is left out
(as in ``step_mfu``).  Nothing where the program keeps no such ring."""


def untraced(ctx):
    """Each of the blocks timed without the profiler just before the
    ring's first profiled call, as many as the ring holds profiled calls,
    as the port's counters (``CallRecord.counters()``); None where the
    context has no steps, the program no ring, the ring no profiled call,
    where those blocks are not all unprofiled calls on one CUDA card of
    ``ctx['steps']`` steps in all, or where one of them replayed a graph
    with an unstamped loop."""
    steps = ctx.get("steps")
    if not steps:
        return None
    try:
        from python_fluid_simulation_tpu_torch.utils.timers import RECORDER
    except ImportError:
        return None
    ring = list(RECORDER.ring)
    first = next((i for i, r in enumerate(ring) if r.profiled), None)
    if first is None:
        return None
    n = sum(r.profiled for r in ring)
    calls = ring[first - n:first] if first >= n else []
    if (not calls or any(r.profiled for r in calls) or len({r.device for r in calls}) != 1
            or calls[0].device.type != "cuda" or sum(r.steps for r in calls) != steps):
        return None
    blocks = [r.counters() for r in calls]
    return None if any(b.uncounted for b in blocks) else blocks


def per_step(blocks, of):
    """``of(counters)`` summed over the blocks, over their steps."""
    return sum(of(b) for b in blocks) / sum(b.steps for b in blocks)
