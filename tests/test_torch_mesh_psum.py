"""The pieces of the captured step over several cards that the CPU can
hold, all without JAX programs:

* the cross-card sum's plain version (``parallel/halo_rdma.py::
  mesh_psum_plain``, which ``mesh_psum`` takes on CPU partials): on 2, 4
  and 8 slots over two "devices" (``cpu`` and ``cpu:0`` are two devices
  to a mesh), for single fields and for 3-field tuples, every replica
  bitwise ``halo.psum_dot``'s slot-order sum; ``halo.psum_dots`` gives
  one replica a device, on a mesh of one device the same bits;
* a torch model of the halo push's device counters (``csrc/
  halo_rdma.cu``, steps 0 and 6: every block reads the slot's epoch and
  block sum at its start, the last block to finish writes the new ones
  back): over exchanges with changing grids, blocks starting and
  finishing in seeded random orders, every block of an exchange reads
  the same epoch and receive target, and they are the host sequence the
  port kept before the counters moved to the device (the epoch one more
  an exchange, the target the running block sum, both mod 2^32), across
  the wrap too;
* the CLI's ``--mesh N`` layout (``run.py::mesh_layout``) from the device
  count it is given.
"""

import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu_torch import run as cli
from python_fluid_simulation_tpu_torch.parallel import halo, halo_rdma
from python_fluid_simulation_tpu_torch.parallel.mesh import Mesh, make_mesh

M32 = 0xFFFFFFFF


def _two_device_mesh(slots):
    """`slots` slots alternating between the devices 'cpu' and 'cpu:0'."""
    return Mesh(["cpu" if s % 2 == 0 else "cpu:0" for s in range(slots)], ("x",), (slots,))


def _blocks(rng, slots, fields):
    shape = (5, 3, 4)

    def one():
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return [tuple(one() for _ in range(fields)) if fields > 1 else one() for _ in range(slots)]


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("fields", [1, 3])
@pytest.mark.parametrize("slots", [2, 4, 8])
def test_plain_cross_card_sum_is_psum_dot_bitwise(slots, fields):
    rng = np.random.default_rng(slots * 10 + fields)
    mesh = _two_device_mesh(slots)
    a, b, c = (_blocks(rng, slots, fields) for _ in range(3))
    parts = [(halo._partial(a[s], b[s]), halo._partial(a[s], c[s]), halo._partial(b[s], b[s]))
             for s in range(slots)]
    got = halo_rdma.mesh_psum(mesh, parts)
    want = [halo.psum_dot(a, b), halo.psum_dot(a, c), halo.psum_dot(b, b)]
    assert halo_rdma.replica_devices(mesh) == [torch.device("cpu"), torch.device("cpu", 0)]
    for reps, w in zip(got, want):
        assert len(reps) == 2
        assert all(torch.equal(_bits(r), _bits(w)) for r in reps)
    # psum_dots: the same replicas; on one device, one replica of the same bits
    two = halo.psum_dots(mesh, (a, b), (b, b))
    one = halo.psum_dots(make_mesh(slots, "cpu"), (a, b), (b, b))
    for reps, single, w in zip(two, one, (want[0], want[2])):
        assert len(single) == 1 and torch.equal(_bits(single[0]), _bits(w))
        assert all(torch.equal(_bits(r), _bits(w)) for r in reps)


def _push_counters_model(counters, grids, rng):
    """One slot's device counters (epoch, block sum, finished blocks) over
    push launches of the given grids, each launch's blocks starting and
    finishing in a random order (a block starts before it finishes):
    returns the (epoch, receive target) every block of each launch read."""
    reads_by_launch = []
    for grid in grids:
        events = [(b, "start") for b in range(grid)] + [(b, "finish") for b in range(grid)]
        order = rng.permutation(len(events))
        started, pending = set(), [events[i] for i in order]
        reads = {}
        while pending:  # the random order, a finish held back until its block has started
            for i, (b, what) in enumerate(pending):
                if what == "start" or b in started:
                    break
            b, what = pending.pop(i)
            if what == "start":  # step 0: thread 0 reads the slot's counters
                started.add(b)
                reads[b] = (int((counters[0] + 1) & M32), int((counters[1] + grid) & M32))
            else:  # step 6: the last block to finish writes them back
                finished = int(counters[2])
                counters[2] = finished + 1
                if finished == grid - 1:
                    counters[0], counters[1] = reads[b]
                    counters[2] = 0
        reads_by_launch.append([reads[b] for b in range(grid)])
    return reads_by_launch


@pytest.mark.parametrize("start", [(0, 0), (M32 - 1, M32 - 300)], ids=["from_zero", "across_the_wrap"])
def test_push_device_counters_follow_the_host_sequence(start):
    rng = np.random.default_rng(7)
    grids = [int(g) for g in rng.integers(1, 40, size=60)]
    counters = torch.tensor([start[0], start[1], 0], dtype=torch.int64)
    reads = _push_counters_model(counters, grids, rng)
    epoch, blocks = start
    for grid, launch in zip(grids, reads):
        epoch, blocks = (epoch + 1) & M32, (blocks + grid) & M32  # the host's sequence
        assert set(launch) == {(epoch, blocks)}
    assert counters.tolist() == [epoch, blocks, 0]


@pytest.mark.parametrize("n, device, count, devices", [
    (4, "cuda", 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (2, "cuda", 8, ["cuda:0", "cuda:1"]),
    (4, "cuda", 1, None),
    (4, "cpu", 4, None),
])
def test_cli_mesh_layout_from_the_device_count(n, device, count, devices):
    kw, layout = cli.mesh_layout(n, device, count)
    if devices is None:
        assert kw == dict(device=device) and layout == f"{n} slots of {device}"
    else:
        assert kw == dict(devices=devices) and layout == f"{n} cards (cuda:0..cuda:{n - 1})"
        mesh = make_mesh(n, **kw)
        assert [str(d) for d in mesh.devices] == devices and halo_rdma.halo_route(mesh, "x") == "push"
