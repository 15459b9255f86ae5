"""device_idle_pct: the share of the traced window in which no kernel,
copy or fill ran on the card, 100 * (1 - busy / window).  Busy is the
union of the profiler's device intervals over the traced blocks, plus,
where the captured graph holds WHILE nodes (the generic CG loops), the
gap after each node's test kernel, in which the body's iterations that
the profiler does not show run (``harness.py::traced_window``)"""


def read(ctx):
    window, busy = ctx.get("window_s"), ctx.get("busy_s")
    if not window or busy is None or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
