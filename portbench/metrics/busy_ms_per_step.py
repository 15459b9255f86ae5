"""busy_ms_per_step: the device's busy milliseconds a step over the
traced blocks, ``busy_s`` (the busy time ``device_idle_pct`` reads) over
the traced steps.  Idle time is left out, so it reads the same whichever
of its two speeds the replay runs at: the steady reading of the device's
work a step, which a change to the kernels moves.  Where the graph holds
WHILE nodes it includes the gaps after their test kernels, an upper
estimate of the bodies' device time."""


def read(ctx):
    busy, steps = ctx.get("busy_s"), ctx.get("steps")
    if not busy or not steps:
        return None
    return 1e3 * busy / steps
