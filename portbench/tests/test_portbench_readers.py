"""The per-layer readers: each finds nothing to read in an empty trace
and returns nothing, and each reads its share from the context a traced
run hands it."""

import pytest
from _tiny import BENCH

from portbench import catalog

READERS = sorted(p.stem for p in (BENCH / "metrics").glob("*.py"))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert catalog.load_metric(name)({}) is None


def test_busy_ms_per_step_is_busy_time_over_the_traced_steps():
    read = catalog.load_metric("busy_ms_per_step")
    assert read({"busy_s": 0.426, "steps": 30}) == pytest.approx(14.2)
    assert read({"busy_s": 0.0, "steps": 30}) is None


def test_step_mfu_divides_by_the_untraced_seconds_a_step():
    read = catalog.load_metric("step_mfu")
    ctx = {"device_name": "NVIDIA H100 80GB HBM3", "res": (48, 80, 48), "particles": 89648,
           "cell_precond": "mg", "iters": [{"density_iters": 8, "viscosity_iters": 20, "pressure_iters": 10}],
           "untraced_step_s": 0.014, "window_s": 1.0}
    fast = read(ctx)
    assert 0 < fast < 100
    assert read(dict(ctx, untraced_step_s=0.028)) == pytest.approx(fast / 2)
    assert read(dict(ctx, window_s=2.0)) == fast
