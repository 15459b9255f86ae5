"""A model of ``csrc/halo_pull.cu``'s index logic over CPU tensors: the
launch plan (``parallel/halo_rdma.py::pull_plan``, one launch a device),
each launch's pointer table (``pull_table``) read back as the tensors its
addresses point into, the vector width (``vector_floats``) and the flat
index -> source map of every output vector:

    e <  plane               the left neighbour's top plane (0 at a ring's start)
    e <  (n + 1) * plane     the slot's own x[e - plane]
    otherwise                the right neighbour's bottom plane (0 at a ring's end)

in units of the vector.  tests/test_torch_halo_pull.py holds it bitwise
against ``halo_exchange_rdma_plain``.  The model imports no JAX.
"""

import math

import torch

from python_fluid_simulation_tpu_torch.parallel import halo_rdma


def _at(ptr: int, count: int, tensors):
    """The `count` floats at address `ptr`, a flat view of the one tensor
    of `tensors` that holds all of them."""
    for t in tensors:
        base = t.data_ptr()
        if base <= ptr < base + t.numel() * 4:
            off = ptr - base
            assert off % 4 == 0 and off // 4 + count <= t.numel(), (ptr, count)
            return t.view(-1)[off // 4: off // 4 + count]
    raise AssertionError(f"address {ptr:#x} is in no tensor of the exchange")


def pull_model(mesh, blocks, axis_name: str = "x"):
    """The pull route's outputs, one (slots, n + 2, ...) buffer a device
    filled through its table; also the vector width of each launch."""
    shape = tuple(blocks[0].shape)
    n, plane = shape[0], math.prod(shape[1:])
    outs, widths = [None] * len(blocks), []
    for _, entries in halo_rdma.pull_plan(mesh, axis_name):
        buf = torch.empty((len(entries), n + 2) + shape[1:], dtype=torch.float32)
        table = halo_rdma.pull_table(entries, blocks, buf, n, plane)
        vec = halo_rdma.vector_floats(plane, table)
        widths.append(vec)
        known = list(blocks) + [buf]
        pv = plane // vec
        e = torch.arange((n + 2) * pv)
        first, last = e < pv, e >= (n + 1) * pv
        mid = ~first & ~last
        for i in range(len(entries)):  # blockIdx.y
            x_p, lo_p, hi_p, out_p = table[4 * i: 4 * i + 4]
            x = _at(x_p, n * plane, known).view(-1, vec)
            out = _at(out_p, (n + 2) * plane, known).view(-1, vec)
            v = torch.zeros(((n + 2) * pv, vec))
            if lo_p:
                v[first] = _at(lo_p, plane, known).view(-1, vec)[e[first]]
            v[mid] = x[e[mid] - pv]
            if hi_p:
                v[last] = _at(hi_p, plane, known).view(-1, vec)[e[last] - (n + 1) * pv]
            out.copy_(v)
        for (s, _, _), view in zip(entries, buf.unbind(0)):
            outs[s] = view
    return outs, widths
