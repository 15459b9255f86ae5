"""pcg_roofline: the whole-solve PCG kernels' share of their
roofline.  The least time is the sum over the traced steps' launches of
max(bytes / peak memory rate, operations / peak float32 rate) of what
these inputs need (``counts/pcg.py``: the cell Jacobi-PCG on the
reference's live cells with the step's iterations, the coupled viscosity
PCG with its iterations), over the kernels' device time in the trace, by
name.  Only the kernels the cell launches count: a cell whose cell
solves are multigrid launches the coupled kernel alone."""

from portbench.counts.pcg import coupled_pcg, poisson_pcg
from portbench.counts.peaks import least_seconds, peak_of

CELL_KERNEL = "poisson_pcg_kernel"
COUPLED_KERNEL = "coupled_visc_pcg_kernel"


def _device_seconds(kernels, key):
    return sum(v["seconds"] for name, v in kernels.items() if key in name), \
        sum(v["launches"] for name, v in kernels.items() if key in name)


def read(ctx):
    peak = peak_of(ctx.get("device_name"))
    kernels, iters = ctx.get("kernels") or {}, ctx.get("iters")
    if peak is None or not iters:
        return None
    cell_s, cell_n = _device_seconds(kernels, CELL_KERNEL)
    coup_s, coup_n = _device_seconds(kernels, COUPLED_KERNEL)
    live = ctx.get("live") or {}
    least = 0.0
    if cell_n:
        if cell_n != 2 * len(iters) or not {"density_live", "pressure_live"} <= set(live):
            return None
        for it in iters:
            for name in ("density", "pressure"):
                least += least_seconds(*poisson_pcg(ctx["res"], live[f"{name}_live"], it[f"{name}_iters"]), peak)[0]
    if coup_n:
        if coup_n != len(iters):
            return None
        for it in iters:
            least += least_seconds(*coupled_pcg(ctx["res"], it["viscosity_iters"]), peak)[0]
    spent = cell_s + coup_s
    if not spent:
        return None
    return 100.0 * least / spent
