"""The halo exchange's pull route (``parallel/halo_rdma.py``,
``csrc/halo_pull.cu``) and its route choice, on the CPU.

The index model (``tests/halo_pull_model.py``: the launch plan, each
launch's pointer table read back through the tensors it addresses, the
vector width and the flat index -> source map) is held bitwise against
``halo_exchange_rdma_plain`` on 2, 4 and 8 slots and the (2, 2) mesh,
with n = 1, planes of 48 floats (16-byte vectors) and of 30 and 90
floats (scalars, the latter 4-D blocks), and on the outputs of one
exchange fed to the next (views into one buffer).  The route is a
function of the mesh's devices alone: one launch a device where every
ring sits on one device, the push where a ring spans devices; CPU blocks
launch nothing on either wrapper.  The JAX comparison of the plain
version is ``tests/test_torch_parallel.py::
test_rdma_plain_matches_pallas_interpret``.
"""

import numpy as np
import pytest
import torch

from halo_pull_model import pull_model
from python_fluid_simulation_tpu_torch.parallel import halo_rdma
from python_fluid_simulation_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh2d

torch.set_num_threads(1)

MESHES = {
    "1d_2": lambda d: make_mesh(2, d), "1d_4": lambda d: make_mesh(4, d), "1d_8": lambda d: make_mesh(8, d),
    "2d_2x2": lambda d: make_mesh2d((2, 2), d),
}
SHAPES = {"n1": (1, 8, 6), "plane48": (4, 8, 6), "plane30": (3, 6, 5), "4d": (2, 6, 5, 3)}


def _blocks(mesh, shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=torch.float32) for _ in range(mesh.size)]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", list(MESHES))
def test_pull_model_is_the_plain_exchange(kind, shape):
    mesh = MESHES[kind]("cpu")
    blocks = _blocks(mesh, SHAPES[shape], seed=len(kind) + len(shape))
    plane = int(np.prod(SHAPES[shape][1:]))
    for axis in mesh.axis_names:
        got, widths = pull_model(mesh, blocks, axis)
        want = halo_rdma.halo_exchange_rdma_plain(mesh, blocks, axis)
        assert widths == [4 if plane % 4 == 0 else 1]  # one launch: every slot on the one device
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous()
            assert torch.equal(g, w)
        # the outputs, views into one buffer, as the next exchange's blocks
        again, _ = pull_model(mesh, got, axis)
        for g, w in zip(again, halo_rdma.halo_exchange_rdma_plain(mesh, want, axis)):
            assert torch.equal(g, w)


def test_vector_width_needs_a_plane_of_fours_and_aligned_pointers():
    table = [4096, 0, 8192, 12288]
    assert halo_rdma.vector_floats(48, table) == 4
    assert halo_rdma.vector_floats(30, table) == 1
    assert halo_rdma.vector_floats(48, [p + 4 for p in table]) == 1
    assert halo_rdma.vector_floats(48, [4096, 0, 8200, 12288]) == 1


def test_route_is_a_function_of_the_mesh_devices():
    one = make_mesh(4, "cuda")
    assert halo_rdma.halo_route(one, "x") == "pull"
    plan = halo_rdma.pull_plan(one, "x")
    assert [(d, e) for d, e in plan] == [(torch.device("cuda", 0), [(0, -1, 1), (1, 0, 2), (2, 1, 3), (3, 2, -1)])]
    # (2, 2): both x rings in one launch
    plan = halo_rdma.pull_plan(make_mesh2d((2, 2), "cuda"), "x")
    assert len(plan) == 1 and plan[0][1] == [(0, -1, 2), (2, 0, -1), (1, -1, 3), (3, 1, -1)]
    assert halo_rdma.halo_route(make_mesh(4, "cpu"), "x") == "pull"
    # a ring over two cards pushes
    two = Mesh(["cuda:0", "cuda:1"], ("x",), (2,))
    assert halo_rdma.halo_route(two, "x") == "push"
    # x rings span the cards, z rings do not: one pull launch a card along z
    grid = Mesh(["cuda:0", "cuda:0", "cuda:1", "cuda:1"], ("x", "z"), (2, 2))
    assert halo_rdma.halo_route(grid, "x") == "push" and halo_rdma.halo_route(grid, "z") == "pull"
    assert [(d.index, e) for d, e in halo_rdma.pull_plan(grid, "z")] == [(0, [(0, -1, 1), (1, 0, -1)]),
                                                                         (1, [(2, -1, 3), (3, 2, -1)])]


@pytest.mark.parametrize("wrapper", ["halo_exchange_rdma", "halo_exchange_push"])
def test_cpu_blocks_launch_nothing(wrapper):
    mesh = make_mesh(4, "cpu")
    blocks = _blocks(mesh, (3, 4, 5), seed=9)
    before = (halo_rdma.halo_exchange_rdma.launches, halo_rdma.halo_exchange_push.launches, dict(mesh._push))
    got = getattr(halo_rdma, wrapper)(mesh, blocks, "x")
    for g, w in zip(got, halo_rdma.halo_exchange_rdma_plain(mesh, blocks, "x")):
        assert torch.equal(g, w)
    # no launch counted, and no push counters made (they live in device memory)
    assert (halo_rdma.halo_exchange_rdma.launches, halo_rdma.halo_exchange_push.launches, dict(mesh._push)) == before
