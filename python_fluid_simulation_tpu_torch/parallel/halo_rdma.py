"""Width-1 halo exchange along array axis 0: the CUDA kernels' wrappers and
their plain version.

Counterpart of ``python_fluid_simulation_tpu.parallel.halo_rdma``.
Semantics are those of ``halo.halo_exchange(mesh, blocks, axis, 1, 0)``:
each slot's output is (n + 2, ...), row 0 the left neighbour's top
plane, the last row the right neighbour's bottom plane, zeros at the
domain's ends.

The route comes from the mesh's devices alone (`halo_route`):

* **pull** (every ring along the axis on one device: every mesh of
  `make_mesh` / `make_mesh2d`, whose slots share one card):
  ``csrc/halo_pull.cu``, one launch a device an exchange on the caller's
  current stream, covering every ring of that device.  Each output is written whole: the interior from the slot's
  own block, each frame plane read straight from the neighbour's block,
  which stream order has completed.  The outputs of a device are one
  (slots, n + 2, ...) allocation, handed back as per-slot views.
* **push** (a ring spans devices, as on a mesh over several cards;
  `halo_exchange_push`): ``csrc/halo_rdma.cu``, one launch a slot, each
  on its own card and stream, the pushes to a neighbour on another card
  peer stores over NVLink, the counters system-scope atomics on slot 0's
  card (`peer_pairs`: every such pair gets peer access at the first
  exchange, and a pair without it raises); the streams
  wait on an event of the caller's stream, every launch of the exchange
  is enqueued before any completion event (so no launch queues behind
  another slot's), then the caller's stream waits on every slot's event,
  so the allocator cannot reuse a buffer while a slot still writes it.
  The kernels push their edge planes through the table of the ring's
  output pointers (all allocated before the first launch) and count on
  the mesh's semaphore buffer (``parallel/mesh.py::Mesh``); only push
  exchanges advance the mesh's epoch.  Exchanges on one mesh are ordered
  through the caller's stream: call them from one stream, as every
  caller here does.

Under CUDA graph capture (the sharded step's captured loops) the pull
records its launch once: the table holds the addresses the recording
saw, which are the loop's carried buffers and the body pool's, fixed for
every replay, and ``halo_exchange_rdma.launches`` counts recordings, not
replays (a replayed step's launches follow from its iterations).  The
push takes a host epoch a replay would repeat stale, and raises under
capture (ROADMAP queue 1 item 7, "More than one card": its captured
form is not ported).

On CPU blocks either wrapper runs the plain version (slices, ``.to()``,
``torch.cat``).
"""

from __future__ import annotations

import collections
import math
from typing import List, Sequence

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops import cuda_halo


def halo_exchange_rdma_plain(mesh, blocks: Sequence[torch.Tensor], axis_name: str = "x") -> List[torch.Tensor]:
    """Plain PyTorch version: each slot's block framed by its ring
    neighbours' edge planes (zeros at the ends)."""
    out = [None] * len(blocks)
    for ring in mesh.rings(axis_name):
        for pos, s in enumerate(ring):
            b = blocks[s]
            lo = (blocks[ring[pos - 1]][-1:].to(b.device) if pos > 0 else torch.zeros_like(b[:1]))
            hi = (blocks[ring[pos + 1]][:1].to(b.device) if pos < len(ring) - 1 else torch.zeros_like(b[:1]))
            out[s] = torch.cat([lo, b, hi], dim=0)
    return out


def halo_route(mesh, axis_name: str) -> str:
    """The route of an exchange along `axis_name`: "pull" where every ring
    sits on one device, else "push"."""
    return "pull" if all(len({mesh.devices[s] for s in ring}) == 1 for ring in mesh.rings(axis_name)) else "push"


def pull_plan(mesh, axis_name: str):
    """The pull route's launches, one a device: [(device, [(slot, left,
    right), ...])], the entries by ring and position, left / right the
    ring neighbours' slots, -1 at the ring's ends."""
    by_device = {}
    for ring in mesh.rings(axis_name):
        for pos, s in enumerate(ring):
            left = ring[pos - 1] if pos > 0 else -1
            right = ring[pos + 1] if pos < len(ring) - 1 else -1
            by_device.setdefault(mesh.devices[s], []).append((s, left, right))
    return list(by_device.items())


def peer_pairs(mesh, axis_name: str):
    """The (device, peer) pairs of distinct devices whose kernels a push
    exchange along `axis_name` lets write the peer's memory: each ring's
    neighbours both ways (each pushes a plane into the other's output),
    and every slot's device towards slot 0's, which holds the counters."""
    pairs = set()
    for ring in mesh.rings(axis_name):
        for a, b in zip(ring, ring[1:]):
            pairs |= {(mesh.devices[a], mesh.devices[b]), (mesh.devices[b], mesh.devices[a])}
    pairs |= {(d, mesh.devices[0]) for d in mesh.devices}
    return sorted(((a, b) for a, b in pairs if a != b), key=str)


def _plan(mesh, axis_name: str):
    """(route, pull plan) of an axis, made once a mesh; the push route's
    peer access is opened here, once."""
    plan = mesh.halo_plans.get(axis_name)
    if plan is None:
        route = halo_route(mesh, axis_name)
        if route == "push":
            for dev, peer in peer_pairs(mesh, axis_name):
                cuda_halo.enable_peer_access(dev, peer)
        plan = mesh.halo_plans[axis_name] = (route, pull_plan(mesh, axis_name) if route == "pull" else None)
    return plan


def pull_table(entries, blocks: Sequence[torch.Tensor], out: torch.Tensor, n: int, plane: int) -> List[int]:
    """One pull launch's table, four addresses an entry, flat: for entry i
    its block, the left neighbour's top plane (row n - 1; 0 at a ring's
    start), the right neighbour's bottom plane (row 0; 0 at a ring's end)
    and its output, out[i] of the (len(entries), n + 2, ...) buffer."""
    base, size, top = out.data_ptr(), (n + 2) * plane * 4, (n - 1) * plane * 4
    table = []
    for i, (s, left, right) in enumerate(entries):
        table += (blocks[s].data_ptr(), blocks[left].data_ptr() + top if left >= 0 else 0,
                  blocks[right].data_ptr() if right >= 0 else 0, base + i * size)
    return table


def vector_floats(plane: int, table: Sequence[int]) -> int:
    """Floats a pull thread moves at once: 4 (16-byte vectors) where the
    plane is a multiple of 4 floats and every address of the table is
    16-byte aligned, else 1."""
    bits = 0
    for p in table:
        bits |= p
    return 4 if plane % 4 == 0 and bits % 16 == 0 else 1


def _check_blocks(name, mesh, blocks):
    if len(blocks) != mesh.size:
        raise ValueError(f"{name}: {len(blocks)} blocks for {mesh.size} slots")
    shape = tuple(blocks[0].shape)
    for s, (b, dev) in enumerate(zip(blocks, mesh.devices)):
        if (b.device != dev or b.dtype != torch.float32 or tuple(b.shape) != shape or not b.is_contiguous()):
            raise ValueError(
                f"{name}: slot {s} needs a contiguous float32 {shape} block on {dev}, "
                f"got {b.dtype} {tuple(b.shape)} on {b.device}"
            )
    if len(shape) < 2 or shape[0] < 1:
        raise ValueError(f"{name}: blocks of ndim >= 2 with at least one row, got {shape}")
    return shape


def halo_exchange_rdma(mesh, blocks: Sequence[torch.Tensor], axis_name: str = "x") -> List[torch.Tensor]:
    """Exchange one plane along array axis 0 with both ring neighbours of
    every slot along mesh axis ``axis_name``.  ``blocks``: one a slot, in
    slot order, all of one shape (n, ...) with ndim >= 2.  CUDA blocks
    launch the pull kernel once a device, or take `halo_exchange_push`
    where a ring spans devices (or raise); CPU blocks run the plain
    version."""
    if all(b.device.type == "cpu" for b in blocks):
        return halo_exchange_rdma_plain(mesh, blocks, axis_name)
    route, plan = _plan(mesh, axis_name)
    if route == "push":
        return halo_exchange_push(mesh, blocks, axis_name)
    shape = _check_blocks("halo_exchange_rdma", mesh, blocks)
    n, plane = shape[0], math.prod(shape[1:])
    outs = [None] * len(blocks)
    for dev, entries in plan:
        if len(entries) > cuda_halo.MAX_PULL_SLOTS:
            raise ValueError(f"halo_exchange_rdma: at most {cuda_halo.MAX_PULL_SLOTS} slots a device")
        buf = torch.empty((len(entries), n + 2) + shape[1:], dtype=torch.float32, device=dev)
        table = pull_table(entries, blocks, buf, n, plane)
        cuda_halo.pull(table, n, plane, vector_floats(plane, table), buf)
        halo_exchange_rdma.launches += 1
        for (s, _, _), view in zip(entries, buf.unbind(0)):
            outs[s] = view
    return outs


halo_exchange_rdma.launches = 0  # one a device an exchange (the pull route), as recorded: not a graph's replays


def halo_exchange_push(mesh, blocks: Sequence[torch.Tensor], axis_name: str = "x") -> List[torch.Tensor]:
    """`halo_exchange_rdma` by remote push, one launch a slot on its own
    card and stream: the route of rings that span devices, and callable
    on any mesh of CUDA blocks (the slots of one device push through
    plain device pointers).  CPU blocks run the plain version."""
    if all(b.device.type == "cpu" for b in blocks):
        return halo_exchange_rdma_plain(mesh, blocks, axis_name)
    if torch.cuda.is_current_stream_capturing():
        raise NotImplementedError(
            "halo_exchange_push under CUDA graph capture: its epoch is a host counter that a replay would repeat "
            "stale (ROADMAP queue 1 item 7, \"More than one card\": its captured form is not ported)")
    shape = _check_blocks("halo_exchange_push", mesh, blocks)
    _plan(mesh, axis_name)  # the pairs' peer access, once a mesh and axis
    rings = mesh.rings(axis_name)
    if len(rings[0]) > cuda_halo.MAX_RING:
        raise ValueError(f"halo_exchange_push: at most {cuda_halo.MAX_RING} slots along {axis_name!r}")
    n, plane = shape[0], math.prod(shape[1:])
    # everything the launches touch exists before the first of them: no
    # allocation (which may synchronise the device) between two launches
    # that spin on each other
    outs = [torch.empty((n + 2,) + shape[1:], dtype=torch.float32, device=b.device) for b in blocks]
    streams = mesh.slot_streams()
    ready, done = mesh.halo_events()
    sem = mesh.halo_semaphores()
    # one grid for every launch (the counters count blocks), sized for the
    # device that holds the most of the exchange's spinning launches
    per_device = collections.Counter(mesh.devices)
    grid = min(cuda_halo.grid_size(n * plane, k, dev) for dev, k in per_device.items())
    epoch, recv_target = mesh.next_exchange(grid)
    tables = [np.array([outs[s].data_ptr() for s in ring], dtype=np.uint64) for ring in rings]
    err_ptr = sem.data_ptr() + 4 * 3 * mesh.size
    for dev, ev in ready.items():
        ev.record(torch.cuda.current_stream(dev))
    for s, st in enumerate(streams):
        st.wait_event(ready[mesh.devices[s]])
    for r, (ring, table) in enumerate(zip(rings, tables)):
        sem_ptr = sem.data_ptr() + 4 * 3 * len(ring) * r
        for pos, s in enumerate(ring):
            cuda_halo.launch(blocks[s], outs[s], table, sem_ptr, err_ptr, pos, n, plane, epoch, recv_target, grid,
                             streams[s])
            halo_exchange_push.launches += 1
    for s, st in enumerate(streams):
        done[s].record(st)
    for s, dev in enumerate(mesh.devices):
        torch.cuda.current_stream(dev).wait_event(done[s])
    return outs


halo_exchange_push.launches = 0  # one a slot an exchange (the push route)
