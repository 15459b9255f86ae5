"""step_mfu: the whole step's share of the card's roofline.  The least
time of a step is max(the step's floor bytes / peak memory rate, its
floor operations / peak float32 rate) (``counts/step_model.py``, with the
traced steps' mean iterations and the reference's live cells of the two
cell systems), over the seconds a step of the same number of blocks
timed on the host clock just before the profiler starts, so that the
profiler's own cost is left out.  Bytes bound it in every cell measured
so far."""

from portbench.counts.peaks import least_seconds, peak_of
from portbench.counts.step_model import step_floor


def read(ctx):
    peak = peak_of(ctx.get("device_name"))
    iters, step_s = ctx.get("iters"), ctx.get("untraced_step_s")
    if peak is None or not iters or not step_s:
        return None
    mean = {k: sum(it[k] for it in iters) / len(iters) for k in iters[0]}
    live = ctx.get("live") or None
    if ctx["cell_precond"] == "jacobi" and not live:
        return None
    floor = step_floor(ctx["res"], ctx["particles"], mean, ctx["cell_precond"], live)
    least, _ = least_seconds(floor["bytes"], floor["flops"], peak)
    return 100.0 * least / step_s
