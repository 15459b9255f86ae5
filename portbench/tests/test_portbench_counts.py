"""The frozen counts against the port's own: the whole step's floor under
the port's exact byte count of a coarse step, and the PCG kernels'
counts equal to the byte formulas the port's wrappers carry."""

import dataclasses

import pytest
import torch

from portbench.counts import pcg, step_model
from portbench.counts.peaks import least_seconds, peak_of
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene, scaled_buckling_config
from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, simulate
from python_fluid_simulation_tpu_torch.utils.step_bytes import step_bytes

from test_portbench_reference import reference_step_of

ITERS = ("density_iters", "viscosity_iters", "pressure_iters")


def _mg(cfg):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, precond="mg"))


@pytest.mark.parametrize("label", ["jacobi", "mg"])
def test_step_floor_lies_under_the_ports_byte_count(label):
    torch.set_num_threads(1)
    cfg = buckling_config(dx=0.05) if label == "jacobi" else _mg(scaled_buckling_config(24))
    state, _ = simulate(buckling_scene(cfg, device="cpu"), cfg, 3)
    counted = step_bytes(state, cfg, 1, geom=build_geom_cache(state.solid))
    iters = {k: int(counted.metrics[0][k]) for k in ITERS}
    assert iters["viscosity_iters"] > 0
    _, probe = reference_step_of(state, cfg)
    floor = step_model.step_floor(cfg.grid.res, state.particles.x.shape[0], iters, cfg.solver.precond,
                                  probe or None)
    assert 0 < floor["bytes"] < counted.bytes_per_step


def test_pcg_counts_equal_the_wrappers_formulas():
    from python_fluid_simulation_tpu_torch.ops.cuda_cg import coupled_visc_pcg_bytes
    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import poisson_pcg_bytes, poisson_live_cells_plain
    from python_fluid_simulation_tpu_torch.ops.indexing import split_parity
    from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_coefficients

    res = (12, 20, 12)
    g = torch.Generator().manual_seed(0)
    lphi = torch.rand(res, generator=g) - 0.6
    w = [torch.rand(tuple(n + (1 if i == a else 0) for i, n in enumerate(res)), generator=g) for a in range(3)]
    diag, coefs, _ = pressure_coefficients(w, lphi)
    b = torch.where(lphi < 0, torch.rand(res, generator=g), 0.0)
    live = int(poisson_live_cells_plain(b, None, diag, coefs).numel())
    assert pcg.poisson_pcg(res, live, 17)[0] == poisson_pcg_bytes(b, None, diag, coefs, 17)
    dual = tuple(2 * n + 1 for n in res)
    sphi_c = split_parity(torch.rand(dual, generator=g), 3)
    vol_c = split_parity(torch.rand(dual, generator=g), 3)
    faces = tuple(torch.zeros(tuple(n + (1 if i == a else 0) for i, n in enumerate(res))) for a in range(3))
    assert pcg.coupled_pcg(res, 23)[0] == coupled_visc_pcg_bytes(faces, sphi_c, vol_c, 23)
    assert pcg.face_count(res) == sum(f.numel() for f in faces)


def test_least_time_names_its_limiter():
    h100 = peak_of("NVIDIA H100 80GB HBM3")
    assert least_seconds(3.35e12, 0.0, h100) == (1.0, "bytes")
    assert least_seconds(0.0, 67e12, h100) == (1.0, "flops")
    assert peak_of("cpu") is None
