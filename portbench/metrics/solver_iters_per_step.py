"""solver_iters_per_step: the step's own density + viscosity + pressure
iterations, the mean a step over the traced window: an exact count."""


def read(ctx):
    iters = ctx.get("iters")
    if not iters:
        return None
    return sum(it["density_iters"] + it["viscosity_iters"] + it["pressure_iters"] for it in iters) / len(iters)
