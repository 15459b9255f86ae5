"""The port's placements (``parallel/mesh.py``: `particle_sharding`,
`grid_sharding`, `replicated`) against the JAX package's
``NamedSharding`` objects on the 8 virtual CPU devices of tests/conftest.py,
and the pieces of a mesh over several cards that run without one.

* ``devices_indices_map``: the slices each slot holds equal JAX's for
  ``make_mesh(2 / 4 / 8)`` and ``make_mesh2d((2, 2) / (4, 2))`` (slot s is
  ``jax_mesh.devices.flat[s]``), on particle arrays of the padded
  flagship count and on cell, face and vector grid shapes that divide
  the mesh;
* ``shard_state``: each slot's block of the port's particles
  (`particle_sharding`'s split) equals the data of JAX
  ``shard_state(...).particles.*.addressable_shards`` on that slot's
  device, with and without padding;
* split then gather round-trips bitwise;
* ``indexing.P3_XYEDGE`` / ``P3_XZEDGE`` / ``P3_YZEDGE`` equal JAX's;
* a mesh over cards (``devices=``) keeps JAX's slot order, its halos
  route to the push, and its peer pairs are the rings' neighbours and
  slot 0's card; a launch refuses tensors of two devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from python_fluid_simulation_tpu.ops import indexing as j_indexing
from python_fluid_simulation_tpu.parallel import mesh as j_mesh
from python_fluid_simulation_tpu_torch.convert import state_to_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
from python_fluid_simulation_tpu_torch.ops import _cuda_build, indexing
from python_fluid_simulation_tpu_torch.parallel import halo_rdma, mesh

torch.set_num_threads(1)

MESHES = ["1d_2", "1d_4", "1d_8", "2d_2x2", "2d_4x2"]
FLAGSHIP_PARTICLES = 89_648  # buckling_config()'s count, a multiple of 8 (so padded as it is)
GRID_SHAPES = {
    "cells": (48, 80, 48),  # the flagship's cell grid
    "y_faces": (48, 81, 48),  # its y-face array: x and z as the cells
    "vector": (16, 9, 8, 3),  # a 4D field, the component axis whole
}


def _meshes(name):
    """(the JAX mesh, the port's mesh on the CPU) of a name."""
    kind, size = name.split("_")
    if kind == "1d":
        return j_mesh.make_mesh(int(size)), mesh.make_mesh(int(size), "cpu")
    shape = tuple(int(k) for k in size.split("x"))
    return j_mesh.make_mesh2d(shape), mesh.make_mesh2d(shape, "cpu")


def _placements(jm, tm, kind, ndim):
    if kind == "particle":
        return j_mesh.particle_sharding(jm), mesh.particle_sharding(tm)
    if kind == "grid":
        return j_mesh.grid_sharding(jm, ndim), mesh.grid_sharding(tm, ndim)
    return j_mesh.replicated(jm), mesh.replicated(tm)


def _slices(index, shape):
    """(start, stop) an axis, normalised against the array's extents."""
    return tuple(sl.indices(n)[:2] for sl, n in zip(index, shape))


CASES = [("particle", (FLAGSHIP_PARTICLES,)), ("particle", (FLAGSHIP_PARTICLES, 3, 3))]
CASES += [("grid", s) for s in GRID_SHAPES.values()]
CASES += [("replicated", GRID_SHAPES["cells"])]


@pytest.mark.parametrize("shape_case", CASES, ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}")
@pytest.mark.parametrize("mesh_name", MESHES)
def test_devices_indices_map_matches_jax(mesh_name, shape_case):
    kind, shape = shape_case
    jm, tm = _meshes(mesh_name)
    js, ts = _placements(jm, tm, kind, len(shape))
    assert isinstance(js, NamedSharding)
    want = js.devices_indices_map(shape)
    got = ts.devices_indices_map(shape)
    assert sorted(got) == list(range(tm.size))
    for s, dev in enumerate(jm.devices.flat):
        assert len(got[s]) == len(shape)
        assert _slices(got[s], shape) == _slices(want[dev], shape), (s, got[s], want[dev])


def _jax_state(d):
    from python_fluid_simulation_tpu.state import Particles, SimState, SolidState

    return SimState(Particles(*(jnp.asarray(d[k]) for k in "xvcm")),
                    SolidState(*(jnp.asarray(d[k]) for k in ("phi", "sv", "rb"))),
                    jnp.asarray(d["t"]), jnp.asarray(d["step_idx"]), jnp.asarray(d["visc_mg"]))


@pytest.fixture(scope="module")
def scene():
    """The flagship scene at dx 0.05 (1,424 particles) as numpy arrays."""
    return state_to_numpy(buckling_scene(buckling_config(dx=0.05), seed=0, device="cpu"))


@pytest.mark.parametrize("rows", ["whole", "cut_to_pad"])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_shard_state_blocks_match_jax(scene, mesh_name, rows):
    """Slot s's block of every particle array is the data of the JAX
    shard on ``jax_mesh.devices.flat[s]``; cut to 1,421 rows, both pad
    to a multiple of the slots the same way."""
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy

    d = dict(scene)
    if rows == "cut_to_pad":
        for k in "xvcm":
            d[k] = d[k][:1421]
    jm, tm = _meshes(mesh_name)
    j_state = j_mesh.shard_state(_jax_state(d), jm)
    t_state = mesh.shard_state(state_from_numpy(d, device="cpu"), tm)
    placement = mesh.particle_sharding(tm)
    for k in "xvcm":
        j_arr, t_arr = getattr(j_state.particles, k), getattr(t_state.particles, k)
        assert tuple(t_arr.shape) == tuple(j_arr.shape)
        blocks = placement.split(t_arr)
        shards = {sh.device: np.asarray(sh.data) for sh in j_arr.addressable_shards}
        for s, dev in enumerate(jm.devices.flat):
            got, want = blocks[s].numpy(), shards[dev]
            assert got.shape == want.shape and np.array_equal(got.view(np.int32), want.view(np.int32)), (k, s)
            assert blocks[s].device == tm.devices[s] and blocks[s].is_contiguous()


@pytest.mark.parametrize("kind", ["particle", "grid", "replicated"])
@pytest.mark.parametrize("mesh_name", MESHES)
def test_split_then_gather_is_bitwise(mesh_name, kind):
    _, tm = _meshes(mesh_name)
    rng = np.random.default_rng(3)
    shape = (FLAGSHIP_PARTICLES, 3) if kind == "particle" else GRID_SHAPES["vector"]
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    placement = _placements(*_meshes(mesh_name), kind, len(shape))[1]
    blocks = placement.split(a)
    assert len(blocks) == tm.size
    back = placement.gather(blocks)
    assert back.shape == a.shape and torch.equal(back.view(torch.int32), a.view(torch.int32))
    if kind == "grid":
        assert torch.equal(mesh.gather_blocks(tm, mesh.split_blocks(tm, a)), a)
    if kind == "replicated":
        assert all(torch.equal(b, a) for b in blocks)


def test_grid_split_refuses_an_extent_that_does_not_divide():
    _, tm = _meshes("2d_2x2")
    with pytest.raises(ValueError, match="does not divide"):
        mesh.grid_sharding(tm, 3).devices_indices_map((49, 80, 48))
    with pytest.raises(ValueError, match="does not divide"):
        mesh.particle_sharding(tm).split(torch.zeros(1421))


def test_p3_edge_parities_match_jax():
    for name in ("P3_XYEDGE", "P3_XZEDGE", "P3_YZEDGE"):
        assert getattr(indexing, name) == getattr(j_indexing, name)


@pytest.mark.parametrize("shape", [(4,), (2, 2), (4, 2)])
def test_a_mesh_over_cards_keeps_jax_slot_order_and_pushes(shape):
    """Slot s of ``make_mesh(n, devices=)`` / ``make_mesh2d(shape,
    devices=)`` is device s, as JAX's slot s is ``jax.devices()[s]``; its
    x halos take the push, with peer access between each ring's
    neighbours both ways and from every card towards slot 0's."""
    n = int(np.prod(shape))
    cards = [torch.device("cuda", i) for i in range(n)]
    if len(shape) == 1:
        jm, tm = j_mesh.make_mesh(n), mesh.make_mesh(n, devices=cards)
    else:
        jm, tm = j_mesh.make_mesh2d(shape), mesh.make_mesh2d(shape, devices=cards)
    assert [d.id for d in jm.devices.flat] == list(range(n))
    assert list(tm.devices) == cards
    assert halo_rdma.halo_route(tm, "x") == "push"
    assert halo_rdma.halo_route(mesh.make_mesh(n, "cuda:0") if len(shape) == 1
                                else mesh.make_mesh2d(shape, "cuda:0"), "x") == "pull"
    pairs = set(halo_rdma.peer_pairs(tm, "x"))
    want = {(d, cards[0]) for d in cards[1:]}
    for ring in tm.rings("x"):
        for a, b in zip(ring, ring[1:]):
            want |= {(cards[a], cards[b]), (cards[b], cards[a])}
    assert pairs == want
    with pytest.raises(ValueError):
        mesh.make_mesh(n, "cuda:0", devices=cards)
    with pytest.raises(ValueError, match="requested"):
        mesh.cuda_devices(torch.cuda.device_count() + 1)


def test_a_launch_refuses_tensors_of_two_devices():
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="inputs on cpu and meta"):
        _cuda_build.launch_device("fold", cpu, meta)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _cuda_build.launch_device("fold", cpu, None, cpu)
