"""The fluid level set on a borrowed home-cell sort (``ops/levelset.py::
compute_fluid_levelset(sort_info=)``) with particles beyond the grid, on CPU.

A particle beyond the last x (or y) plane sorts after every home cell
inside the grid (the shared sort's key is the extended grid's) but clips
onto the last plane, so in the borrowed order its clipped id can fall
below the previous row's.  The segment reduce needs non-decreasing ids:
on the card the live placement kernel reads them as tile boundaries and
faulted (an illegal address) on the moving box whose heavier particles
the density projection pushed past x = 1.  Held here: the ids that reach
the reduce are non-decreasing, and the level set is bitwise the one from
its own sort, with particles beyond the grid on each side of x and y, and
with none (the borrowed order unchanged).
"""

import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu_torch.ops import levelset
from python_fluid_simulation_tpu_torch.ops.transfers import make_sort_info

RES = (6, 7, 8)
H = (1.0 / 6, 1.0 / 7, 1.0 / 8)


def _particles(outside, seed=0):
    """Positions in the unit box, some beyond it (`outside`: (axis, side)
    pairs), the rest inside; masses > 0 with a few padding rows at 0."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (400, 3)).astype(np.float32)
    for j, (axis, side) in enumerate(outside):
        rows = slice(40 * j, 40 * j + 20)
        x[rows, axis] = 1.0 + rng.uniform(0.0, 0.4, 20) if side > 0 else -rng.uniform(0.0, 0.4, 20)
    m = np.ones(400, np.float32)
    m[-5:] = 0.0
    return torch.from_numpy(x), torch.from_numpy(m)


@pytest.mark.parametrize("outside", [(), ((0, 1),), ((0, -1), (1, 1)), ((0, 1), (1, -1), (1, 1), (2, 1))],
                         ids=["inside", "x_high", "x_low_y_high", "x_y_z"])
def test_borrowed_sort_gives_sorted_ids_and_the_same_levelset(outside, monkeypatch):
    px, pm = _particles(outside)
    seen = []
    reduce = levelset.segment_reduce_cf

    def record(vals, sorted_ids, *args):
        seen.append(sorted_ids)
        return reduce(vals, sorted_ids, *args)

    monkeypatch.setattr(levelset, "segment_reduce_cf", record)
    si = make_sort_info(px, pm, RES, (0.0, 0.0, 0.0), H)
    got = levelset.compute_fluid_levelset(px, RES, (0.0, 0.0, 0.0), H, H[0], pm=pm, sort_info=si)
    want = levelset.compute_fluid_levelset(px, RES, (0.0, 0.0, 0.0), H, H[0], pm=pm)
    assert len(seen) == 2
    for ids in seen:
        assert bool((ids[1:] >= ids[:-1]).all())
    assert torch.equal(got, want)
    if outside:  # the borrowed order itself is not sorted by the clipped key
        gi = torch.clamp(torch.floor(si.px_sorted / torch.tensor(H)).to(torch.int64), min=0)
        gi = torch.minimum(gi, torch.tensor(RES) - 1)
        key = (gi[:, 0] * RES[1] + gi[:, 1]) * RES[2] + gi[:, 2]
        live = pm[si.order] > 0
        assert bool((key[live][1:] < key[live][:-1]).any()) == any(a < 2 for a, _ in outside)
