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
  on its own card and stream (`slot_launches`), the pushes to a neighbour
  on another card peer stores over NVLink, the counters system-scope
  atomics on slot 0's card (`peer_pairs`: every such pair gets peer
  access at the first exchange, and a pair without it raises); every
  launch of the exchange is enqueued before any completion event (so no
  launch queues behind another slot's), and the caller's stream waits on
  every slot's, so the allocator cannot reuse a buffer while a slot
  still writes it.  The kernels push their edge planes through the table
  of the ring's output pointers (all allocated before the first launch)
  and count on the axis's semaphore buffer (``parallel/mesh.py::
  Mesh.push_state``); each slot keeps its epoch and block sum along the
  axis in device memory and its launch advances them, so an exchange
  recorded into a CUDA graph (a WHILE body of the distributed solves)
  runs with a fresh epoch every time.  Exchanges on one mesh are ordered
  through the caller's stream: call them from one stream, as every
  caller here does.

Under CUDA graph capture (the sharded step's captured loops) each route
records its launches once: the tables hold the addresses the recording
saw, which are the loop's carried buffers and the body pool's, fixed for
every replay, and the counters count recordings, not replays (a replayed
step's launches follow from its iterations).

`mesh_psum` is the cross-card sum of the distributed solves' dots
(``csrc/mesh_psum.cu``, one launch a slot on its slot's stream): every
card gets the slot-order sum of every slot's partials, bit for bit
`mesh_psum_plain`'s (the sum on slot 0's device, copied to every card).

On CPU blocks every wrapper runs its plain version (slices, ``.to()``,
``torch.cat``, fp32 adds in slot order).
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import List, Sequence

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops import cuda_halo
from python_fluid_simulation_tpu_torch.utils.step_bytes import counted_bytes


def halo_bytes(slots: int, n: int, plane: int) -> int:
    """An exchange's traffic (row 15) over `slots` blocks of n planes of
    `plane` floats: every block read once, every framed (n + 2)-plane
    output written once."""
    return slots * (2 * n + 2) * plane * 4


def exchange_bytes(blocks) -> int:
    """`halo_bytes` of an exchange of these blocks."""
    return halo_bytes(len(blocks), blocks[0].shape[0], math.prod(blocks[0].shape[1:]))


def psum_bytes(slots: int, dots: int) -> int:
    """A cross-card sum's traffic: every slot's partials stored into every
    slot's buffer and read back once, and the arrival counters."""
    return slots * (2 * slots * dots * 4 + slots * 4 + 2 * dots * 4)


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


def peer_pairs(mesh, axis_name: str = None):
    """The (device, peer) pairs of distinct devices whose kernels a push
    exchange along `axis_name` lets write the peer's memory: each ring's
    neighbours both ways (each pushes a plane into the other's output),
    and every slot's device towards slot 0's, which holds the counters;
    without an axis, the cross-card sum's: every pair both ways (each
    slot stores its partials into every slot's buffer)."""
    if axis_name is None:
        pairs = {(a, b) for a in mesh.devices for b in mesh.devices}
    else:
        pairs = set()
        for ring in mesh.rings(axis_name):
            for a, b in zip(ring, ring[1:]):
                pairs |= {(mesh.devices[a], mesh.devices[b]), (mesh.devices[b], mesh.devices[a])}
        pairs |= {(d, mesh.devices[0]) for d in mesh.devices}
    return sorted(((a, b) for a, b in pairs if a != b), key=str)


def _open_peers(mesh, pairs):
    """Peer access for every pair not yet opened for this mesh."""
    for dev, peer in pairs:
        if (dev, peer) not in mesh.open_peers:
            cuda_halo.enable_peer_access(dev, peer)
            mesh.open_peers.add((dev, peer))


def _plan(mesh, axis_name: str):
    """(route, pull plan) of an axis, made once a mesh; the push route's
    peer access is opened here, once."""
    plan = mesh.halo_plans.get(axis_name)
    if plan is None:
        route = halo_route(mesh, axis_name)
        if route == "push":
            _open_peers(mesh, peer_pairs(mesh, axis_name))
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


@counted_bytes(lambda out, blocks, **_: exchange_bytes(blocks))
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


@contextlib.contextmanager
def slot_launches(mesh):
    """Yield one stream a slot to launch on: its device's current stream
    where the slot is the only one of its device (every slot of a mesh
    over the cards), else a stream of the slot's own (`Mesh.slot_streams`,
    one set for each set of the devices' current streams: a side stream
    joins the capture of the stream it forks from, so the top level of a
    graph and the WHILE bodies each get streams of their own), which
    starts after its device's current stream has done the caller's work
    so far and which every device's current stream waits for on leaving
    (`Mesh.halo_events`).  The caller enqueues every launch inside."""
    current = {d: torch.cuda.current_stream(d) for d in dict.fromkeys(mesh.devices)}
    if len(current) == mesh.size:
        yield [current[d] for d in mesh.devices]
        return
    streams = mesh.slot_streams(tuple(st.cuda_stream for st in current.values()))
    ready, done = mesh.halo_events()
    for dev, ev in ready.items():
        ev.record(current[dev])
    for s, st in enumerate(streams):
        st.wait_event(ready[mesh.devices[s]])
    yield streams
    for s, st in enumerate(streams):
        done[s].record(st)
    for s, dev in enumerate(mesh.devices):
        current[dev].wait_event(done[s])


@counted_bytes(lambda out, blocks, **_: exchange_bytes(blocks))
def halo_exchange_push(mesh, blocks: Sequence[torch.Tensor], axis_name: str = "x") -> List[torch.Tensor]:
    """`halo_exchange_rdma` by remote push, one launch a slot on its own
    card and stream: the route of rings that span devices, and callable
    on any mesh of CUDA blocks (the slots of one device push through
    plain device pointers).  CPU blocks run the plain version."""
    if all(b.device.type == "cpu" for b in blocks):
        return halo_exchange_rdma_plain(mesh, blocks, axis_name)
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
    sem, counters = mesh.push_state(axis_name)
    # one grid for every launch (the counters count blocks), sized for the
    # device that holds the most of the exchange's spinning launches
    per_device = collections.Counter(mesh.devices)
    grid = min(cuda_halo.grid_size(n * plane, k, dev) for dev, k in per_device.items())
    tables = [np.array([outs[s].data_ptr() for s in ring], dtype=np.uint64) for ring in rings]
    err_ptr = sem.data_ptr() + 4 * 3 * mesh.size
    with slot_launches(mesh) as streams:
        for r, (ring, table) in enumerate(zip(rings, tables)):
            sem_ptr = sem.data_ptr() + 4 * 3 * len(ring) * r
            for pos, s in enumerate(ring):
                cuda_halo.launch(blocks[s], outs[s], table, sem_ptr, err_ptr, counters[s], pos, n, plane, grid,
                                 streams[s])
                halo_exchange_push.launches += 1
    return outs


halo_exchange_push.launches = 0  # one a slot an exchange (the push route), as recorded


def mesh_psum_plain(mesh, parts) -> List[tuple]:
    """Plain PyTorch version of `mesh_psum`: each dot's partials summed
    on slot 0's device in slot order, ((p0 + p1) + p2) + ..., then copied
    to every distinct device of the mesh (its replicas, in the order of
    `replica_devices`)."""
    devices = replica_devices(mesh)
    totals = []
    for j in range(len(parts[0])):
        total = parts[0][j]
        for s in range(1, len(parts)):
            total = total + parts[s][j].to(total.device)
        totals.append(total)
    return [tuple(t.to(d) for d in devices) for t in totals]


def replica_devices(mesh) -> List[torch.device]:
    """The mesh's distinct devices in the order of their first slots: one
    replica of every scalar the distributed solves carry each."""
    return list(dict.fromkeys(mesh.devices))


@counted_bytes(lambda out, parts, **_: psum_bytes(len(parts), len(parts[0])))
def mesh_psum(mesh, parts) -> List[tuple]:
    """The distributed dots of a mesh whose slots span devices: parts[s]
    is slot s's tuple of 1 to 3 fp32 0-dim partials (on its device); for
    each dot, its replicas, one a distinct device (`replica_devices`),
    each the slot-order sum of the slots' partials, the same bits.  CUDA
    partials launch ``csrc/mesh_psum.cu`` once a slot on the slot's
    stream (the replica of a device is its first slot's total), with no
    fallback; CPU partials take `mesh_psum_plain`."""
    if len(parts) != mesh.size or len({len(p) for p in parts}) != 1:
        raise ValueError(f"mesh_psum: {len(parts)} slots' partials of {sorted({len(p) for p in parts})} dots for "
                         f"{mesh.size} slots")
    if all(t.device.type == "cpu" for p in parts for t in p):
        return mesh_psum_plain(mesh, parts)
    dots = len(parts[0])
    if dots > cuda_halo.MAX_PSUM_DOTS or mesh.size > cuda_halo.MAX_PSUM_SLOTS:
        raise ValueError(f"mesh_psum: at most {cuda_halo.MAX_PSUM_DOTS} dots over {cuda_halo.MAX_PSUM_SLOTS} slots")
    for s, (p, dev) in enumerate(zip(parts, mesh.devices)):
        if any(t.device != dev or t.dtype != torch.float32 or t.dim() != 0 for t in p):
            raise ValueError(f"mesh_psum: slot {s} needs 0-dim float32 partials on {dev}")
    _open_peers(mesh, peer_pairs(mesh))
    recv, state = mesh.psum_state()
    recv_table = np.array([b.data_ptr() for b in recv], dtype=np.uint64)
    arrive_table = np.array([t.data_ptr() for t in state], dtype=np.uint64)
    outs = [tuple(torch.empty((), dtype=torch.float32, device=dev) for _ in range(dots)) for dev in mesh.devices]
    with slot_launches(mesh) as streams:
        for s in range(mesh.size):
            cuda_halo.psum(recv_table, arrive_table, parts[s], outs[s], state[s], s, streams[s])
            mesh_psum.launches += 1
    first = {}
    for s, dev in enumerate(mesh.devices):
        first.setdefault(dev, s)
    return [tuple(outs[first[dev]][j] for dev in replica_devices(mesh)) for j in range(dots)]


mesh_psum.launches = 0  # one a slot a call, as recorded
