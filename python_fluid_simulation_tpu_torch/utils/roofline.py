"""Device-memory roofline model for one engine step.

Counterpart of ``python_fluid_simulation_tpu.utils.roofline``, with the
same byte model (`step_bytes_model` counts exactly what the JAX
package's counts, so both packages model the same bytes) and the H100's
peak in place of the TPU generations'.  It answers "is N ms a step
good?" by comparing the bytes the algorithm must move a step with the
card's memory rate: a LOWER BOUND on a step's traffic from the grid and
particle sizes and the measured CG iteration counts, and a measured ms
a step turned into achieved GB/s and a utilisation.

Model assumptions (all fp32 = 4 B; K = particles, Nc = prod(res) cells,
Nf = 3 Nc face sites): each cell-Poisson PCG iteration streams the
7-point coefficients and touches its vectors, ~(7 + 2) Nc; each coupled
viscosity PCG iteration ~(15 + 2) Nf; the transfers are each a sort
(~4 passes over K * 8 B) plus their channel rows and dense grids; the
static geometry is built outside the step and not counted.  A floor,
not an exact count: utilisations are meaningful to ~+-30%.

The measured count that ``roofline(measured_bytes_per_step=)`` takes
comes from `step_bytes` (``utils/step_bytes.py``, re-exported here), the
counterpart of JAX's ``hlo_bytes_per_step``: where JAX asks XLA's cost
analysis of the compiled program (a while-loop body counted once), the
port counts the bytes of every aten op and hand kernel of eager steps,
every solver iteration included.
"""

from __future__ import annotations

from python_fluid_simulation_tpu_torch.utils.step_bytes import step_bytes  # noqa: F401

# Published device-memory peak (GB/s) by device kind, as
# ``torch.cuda.get_device_name`` names it: the H100 SXM part (NVIDIA's
# data sheet), the figure the port's kernel bounds use.
_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def chip_peak_gbps(device_kind: str | None) -> float | None:
    """The card's peak memory rate in GB/s; None for a kind not listed."""
    if not device_kind:
        return None
    return _PEAK_GBPS.get(device_kind.strip())


def step_bytes_model(
    res,
    particles: int,
    iters: dict,
    unet: bool = False,
) -> dict:
    """Modeled HBM bytes of one step.  ``iters`` carries the per-solver
    CG iteration counts (e.g. the bench's cg_iters_last_step)."""
    B = 4
    nc = 1
    for n in res:
        nc *= int(n)
    nf = 3 * nc
    k = int(particles)

    # fractional counts: callers pass the mean of a run's per-step series
    p_it = float(iters.get("pressure_iters", 0))
    d_it = float(iters.get("density_iters", 0))
    v_it = float(iters.get("viscosity_iters", 0))

    # implicit solves
    poisson = (p_it + d_it) * (7 + 2) * nc * B
    viscosity = v_it * (15 + 2) * nf * B
    # solve setup: coefficient-field builds (pressure+density 7 fields
    # each from lphi/w; viscosity 45 face-shaped fields from dual classes)
    setup = (2 * 8 * nc + 45 * nf + 2 * 8 * nc) * B

    # particle transfers; the channel widths are the JAX package's (its
    # rows padded to 128 lanes), kept so both packages model the same bytes
    sort_pass = 4 * k * 8  # argsort passes over (id, perm)
    p2g = sort_pass + k * 128 * B * 3 + 16 * nc * B  # 108-ch payload+table
    g2p = k * 128 * B * 3 + 64 * nc * B  # 54-ch broadcast + corner tables
    levelset = 2 * (sort_pass + k * 128 * B * 10 + 2 * nc * B)  # 125-ch min
    density_tr = sort_pass + k * 64 * B * 3 + 16 * nc * B  # scatter+bcast
    misc = 20 * nf * B  # extrapolate (2 iters), boundary condition, apply

    total = poisson + viscosity + setup + p2g + g2p + levelset + density_tr + misc
    return {
        "bytes_per_step": int(total),
        "breakdown_mb": {
            "poisson_cg": round(poisson / 1e6, 1),
            "viscosity_cg": round(viscosity / 1e6, 1),
            "solve_setup": round(setup / 1e6, 1),
            "p2g": round(p2g / 1e6, 1),
            "g2p": round(g2p / 1e6, 1),
            "levelset": round(levelset / 1e6, 1),
            "density_transfers": round(density_tr / 1e6, 1),
            "misc_field_ops": round(misc / 1e6, 1),
        },
    }


def roofline(
    res, particles, iters, ms_per_step, device_kind=None,
    measured_bytes_per_step=None,
) -> dict:
    """Memory roofline of one step at ``ms_per_step``.

    ``modeled_gb_per_step`` is the algorithm's lower bound (the model
    above).  ``measured_bytes_per_step``, when given (bytes a step from a
    profile), is what the utilisation is computed from, with
    ``impl_overhead_x`` its ratio to the model.  With a known
    ``device_kind`` (`chip_peak_gbps`) the result also holds the peak,
    the utilisation ``hbm_util`` and the model's floor in ms a step.
    """
    m = step_bytes_model(res, particles, iters)
    out = {
        "modeled_gb_per_step": round(m["bytes_per_step"] / 1e9, 3),
        "breakdown_mb": m["breakdown_mb"],
    }
    bytes_for_util = m["bytes_per_step"]
    if measured_bytes_per_step:
        out["measured_gb_per_step"] = round(
            measured_bytes_per_step / 1e9, 3
        )
        out["impl_overhead_x"] = round(
            measured_bytes_per_step / max(1, m["bytes_per_step"]), 2
        )
        bytes_for_util = measured_bytes_per_step
    gbps = bytes_for_util / (ms_per_step * 1e-3) / 1e9
    out["achieved_gbps"] = round(gbps, 1)
    peak = chip_peak_gbps(device_kind)
    if peak:
        out["peak_gbps"] = peak
        out["hbm_util"] = round(gbps / peak, 3)
        out["floor_ms_per_step"] = round(
            m["bytes_per_step"] / (peak * 1e9) * 1e3, 2
        )
    return out
