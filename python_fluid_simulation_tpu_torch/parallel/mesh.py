"""Device meshes for spatial domain decomposition.

Counterpart of ``python_fluid_simulation_tpu.parallel.mesh``.  The JAX
package is single-controller: one process drives a ``jax.sharding.Mesh``
through ``shard_map``.  The port keeps that model: a `Mesh` is one
process's ordered list of device *slots* over named axes (``"x"``, or
``"x"`` and ``"z"``), and each slot owns one block of every sharded
grid field, on its device.  A slot may repeat a device, so one card
holds several slots: ``make_mesh(4)`` puts four slabs on the current
card (the CPU tests put four on ``cpu``).  A mesh over several cards, as
JAX's ``make_mesh(n)`` takes the first n of ``jax.devices()``, is
``make_mesh(n, devices=cuda_devices(n))`` (or ``make_mesh2d(shape,
devices=...)``, or `Mesh` itself): slot i on ``cuda:i``.  A halo
exchange whose rings each sit on one device is one launch a device on
the caller's stream; where a ring spans devices each slot pushes on its
own card and stream, over NVLink (``parallel/halo_rdma.py``).

Grid arrays decompose along array axis 0 over mesh axis "x" and, on a 2D
mesh, along array axis 2 over "z"; trailing axes stay whole; particles
along their rows over every slot.  The three placements
(`particle_sharding`, `grid_sharding`, `replicated`: JAX's
``NamedSharding`` objects of the same names) say which slices each slot holds
(`Placement.devices_indices_map`) and cut a global array into its slot
blocks on the slots' devices (`Placement.split`; `split_blocks`,
`gather_blocks` for grid fields).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from python_fluid_simulation_tpu_torch.state import Particles, SimState

GRID_AXIS = "x"  # mesh axis of the 1D decomposition
GRID_AXIS_Z = "z"  # second mesh axis of the 2D (x, z) decomposition


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """Ordered device slots over named axes.

    ``devices`` lists the slots in row-major order of ``extents`` (slot
    (i, k) of an (x, z) mesh is ``devices[i * sz + k]``); ``shape`` maps
    each axis name to its extent, as JAX's ``Mesh.shape`` does.

    The mesh kernels' per-mesh state lives here and is made at first use
    (outside any CUDA graph capture): each axis's route and pull launches
    (``halo_plans``); where a device holds several slots, one stream a
    slot and the events that order those streams against the caller's
    (the push and the cross-card sum);
    for the push route each axis's semaphore buffer (3 counters a slot and
    an error word) and each slot's own counters along it (the epoch and
    the block sum the kernels count to, in device memory: they grow with
    every exchange, so no counter is ever reset, and a replayed launch
    advances them as an eager one does); for the cross-card sum each
    slot's receive buffer and counters.  Two meshes share none of it.
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str], extents: Sequence[int]):
        self.devices: Tuple[torch.device, ...] = tuple(_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(e) for e in extents)))
        if len(self.axis_names) not in (1, 2) or len(extents) != len(self.axis_names):
            raise ValueError(f"a mesh has 1 or 2 named axes, got {axis_names} {extents}")
        if math.prod(self.shape.values()) != len(self.devices) or not self.devices:
            raise ValueError(f"{len(self.devices)} slots do not fill a {tuple(extents)} mesh")
        self.size = len(self.devices)
        self.halo_plans = {}  # axis name -> (route, pull launches): parallel/halo_rdma.py
        self.open_peers = set()  # (device, peer) pairs given peer access for this mesh's kernels
        self._streams = {}
        self._events = None
        self._push = {}
        self._psum = None

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"

    def rings(self, axis_name: str) -> List[List[int]]:
        """The slots along one mesh axis: a list of rings (lists of slot
        indices in axis order), one for each position on the other axis."""
        if axis_name not in self.shape:
            raise ValueError(f"{axis_name!r} is not an axis of {self}")
        if len(self.axis_names) == 1:
            return [list(range(self.size))]
        sx, sz = self.shape[self.axis_names[0]], self.shape[self.axis_names[1]]
        if axis_name == self.axis_names[0]:
            return [[i * sz + k for i in range(sx)] for k in range(sz)]
        return [[i * sz + k for k in range(sz)] for i in range(sx)]

    # -- the push route's per-mesh state (CUDA slots only)

    def slot_streams(self, key=None) -> List[torch.cuda.Stream]:
        """One stream a slot, never shared by two slots of this mesh: one
        set for each ``key`` (the caller's current streams)."""
        if key not in self._streams:
            streams = [torch.cuda.Stream(device=d) for d in self.devices]
            if len({s.cuda_stream for s in streams}) != len(streams):
                raise RuntimeError(f"{self}: two slots were handed the same stream")
            self._streams[key] = streams
        return self._streams[key]

    def halo_events(self):
        """({device: event}, [event a slot]): the caller's streams are
        recorded into the first before the slots start, each slot's
        stream into the second when it is done."""
        if self._events is None:
            self._events = ({d: torch.cuda.Event() for d in set(self.devices)},
                            [torch.cuda.Event() for _ in self.devices])
        return self._events

    def _fresh(self, what: str):
        """Refuse to make device state under capture (a graph would own
        its memory and zero it on every replay)."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{self}: its {what} are made at first use outside a CUDA graph capture: run the "
                               "exchange (or the step) once eagerly first")

    def push_state(self, axis_name: str):
        """(sem, counters) of the push route along `axis_name`, zero at
        first use: sem int32 (3 * size + 1,) on slot 0's device, per slot
        (by ring, then position in the ring) the arrival count and the
        receive counts from the left and from the right, then the error
        word a timed-out wait writes; counters one int32 (3,) a slot on
        its device, the slot's epoch, block sum and finished blocks."""
        if axis_name not in self._push:
            self._fresh("push counters")
            self._push[axis_name] = (torch.zeros(3 * self.size + 1, dtype=torch.int32, device=self.devices[0]),
                                     [torch.zeros(3, dtype=torch.int32, device=d) for d in self.devices])
        return self._push[axis_name]

    def psum_state(self):
        """(recv, state) of the cross-card sum, zero at first use: one
        float32 (2 * 3 * size,) receive buffer a slot (two halves of up
        to three dots by slot) and one int32 (3,) a slot (its arrival
        count, its epoch and its error word), each on its slot's
        device."""
        if self._psum is None:
            self._fresh("cross-card sum buffers")
            self._psum = ([torch.zeros(6 * self.size, dtype=torch.float32, device=d) for d in self.devices],
                          [torch.zeros(3, dtype=torch.int32, device=d) for d in self.devices])
        return self._psum


def cuda_devices(n: int) -> List[torch.device]:
    """The first ``n`` CUDA devices, ``cuda:0`` to ``cuda:n-1`` (JAX's
    ``jax.devices()[:n]``); raises where the process sees fewer."""
    have = torch.cuda.device_count()
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def _slots(n: int, device, devices) -> list:
    if devices is None:
        return [device or "cuda"] * n
    if device is not None or len(devices) != n:
        raise ValueError(f"give either one device or {n} devices, one a slot; got {device!r} and {devices!r}")
    return list(devices)


def make_mesh(n_devices: Optional[int] = None, device=None, axis: str = GRID_AXIS, devices=None) -> Mesh:
    """1D mesh of ``n_devices`` slots (x-slab decomposition), every slot
    on ``device`` (by default ``cuda``, the current card), or slot i on
    ``devices[i]``: ``make_mesh(4, devices=cuda_devices(4))`` is JAX's
    ``make_mesh(4)`` over four cards.  Without ``n_devices``: as many
    slots as CUDA devices (or as ``devices`` lists)."""
    n = n_devices or (len(devices) if devices is not None else torch.cuda.device_count())
    return Mesh(_slots(n, device, devices), (axis,), (n,))


def make_mesh2d(shape: Tuple[int, int], device=None, devices=None) -> Mesh:
    """2D (x, z) mesh, every slot on ``device`` (default ``cuda``), or
    slot (i, k) on ``devices[i * sz + k]`` (JAX's row-major reshape of
    ``jax.devices()[:sx * sz]``): grid arrays split along both spatial
    axes 0 and 2; an (nx, ny, nz) field owns (nx/sx, ny, nz/sz) blocks."""
    return Mesh(_slots(shape[0] * shape[1], device, devices), (GRID_AXIS, GRID_AXIS_Z), tuple(shape))


def spatial_axes(mesh: Mesh) -> Sequence[Tuple[str, int]]:
    """(mesh_axis_name, grid_array_axis) pairs of the decomposition:
    [("x", 0)] for 1D meshes, [("x", 0), ("z", 2)] for 2D."""
    names = mesh.axis_names
    if len(names) == 1:
        return [(names[0], 0)]
    return [(names[0], 0), (names[1], 2)]


def grid_pspec(mesh: Mesh, ndim: int) -> Tuple[Optional[str], ...]:
    """The mesh axis each array axis of a grid field is split over (None:
    whole), as JAX's ``PartitionSpec``."""
    spec = [None] * ndim
    for name, arr_axis in spatial_axes(mesh):
        if arr_axis < ndim:
            spec[arr_axis] = name
    return tuple(spec)


def _slot_coords(mesh: Mesh, slot: int) -> dict:
    names = mesh.axis_names
    if len(names) == 1:
        return {names[0]: slot}
    sz = mesh.shape[names[1]]
    return {names[0]: slot // sz, names[1]: slot % sz}


class Placement:
    """How a global array lies over a mesh's slots: the port's JAX
    ``NamedSharding(mesh, PartitionSpec(*spec))``.  ``spec`` names, for
    each leading array axis, the mesh axis it is split over, a tuple of
    mesh axes (split over their product, the first the slowest), or None
    (whole); axes past it are whole."""

    def __init__(self, mesh: Mesh, spec: Sequence = ()):
        self.mesh, self.spec = mesh, tuple(spec)

    def __repr__(self):
        return f"Placement({self.mesh}, {self.spec})"

    def devices_indices_map(self, shape) -> Dict[int, Tuple[slice, ...]]:
        """{slot: the index of the block it holds}, one slice an axis, as
        JAX's ``NamedSharding.devices_indices_map`` gives them (keyed by
        slot, not device: slots may share a device).  Every split extent
        must divide its mesh extent."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} names more axes than {tuple(shape)} has")
        spec = self.spec + (None,) * (len(shape) - len(self.spec))
        out = {}
        for s in range(self.mesh.size):
            coords = _slot_coords(self.mesh, s)
            idx = []
            for arr_axis, names in enumerate(spec):
                if names is None:
                    idx.append(slice(None))
                    continue
                names = (names,) if isinstance(names, str) else tuple(names)
                parts, pos = 1, 0
                for name in names:
                    parts, pos = parts * self.mesh.shape[name], pos * self.mesh.shape[name] + coords[name]
                if shape[arr_axis] % parts:
                    raise ValueError(f"axis {arr_axis} of {tuple(shape)} does not divide mesh axis {names}")
                w = shape[arr_axis] // parts
                idx.append(slice(pos * w, (pos + 1) * w))
            out[s] = tuple(idx)
        return out

    def block(self, a: torch.Tensor, slot: int, index=None) -> torch.Tensor:
        """Slot ``slot``'s block of `a`, contiguous, on the slot's device."""
        index = self.devices_indices_map(a.shape)[slot] if index is None else index
        return a[index].to(self.mesh.devices[slot]).contiguous()

    def split(self, a: torch.Tensor) -> List[torch.Tensor]:
        """`a` cut into its slot blocks, in slot order, each contiguous
        and on its slot's device."""
        return [self.block(a, s, idx) for s, idx in self.devices_indices_map(a.shape).items()]

    def gather(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global array from its slot blocks, on slot 0's device (a
        replicated axis from the first slot that holds it)."""
        spec = self.spec + (None,) * (blocks[0].ndim - len(self.spec))
        shape = list(blocks[0].shape)
        for arr_axis, names in enumerate(spec):
            for name in (() if names is None else (names,) if isinstance(names, str) else names):
                shape[arr_axis] *= self.mesh.shape[name]
        index = self.devices_indices_map(shape)
        dev = self.mesh.devices[0]
        first = {}  # each distinct block's first slot
        for s, idx in index.items():
            first.setdefault(tuple((i.start, i.stop) for i in idx), s)
        if len(first) == 1:
            return blocks[0].to(dev)
        out = torch.empty(shape, dtype=blocks[0].dtype, device=dev)
        for s in first.values():
            out[index[s]].copy_(blocks[s])
        return out


def particle_sharding(mesh: Mesh) -> Placement:
    """Particles split along their rows over every slot (both axes of a
    2D mesh flatten onto the rows, slot ix * sz + iz), as JAX's."""
    names = mesh.axis_names
    return Placement(mesh, (names[0] if len(names) == 1 else tuple(names),))


def grid_sharding(mesh: Mesh, ndim: int) -> Placement:
    """Grid fields split along the spatial x (and, on a 2D mesh, z) axes
    (`grid_pspec`), as JAX's; every split extent must divide the mesh
    (the solves pad first: ``halo._pad_to_mesh``)."""
    return Placement(mesh, grid_pspec(mesh, ndim))


def replicated(mesh: Mesh) -> Placement:
    """Every slot holds the whole array, as JAX's."""
    return Placement(mesh, ())


def split_blocks(mesh: Mesh, a: torch.Tensor, spec=None) -> List[torch.Tensor]:
    """A global field cut into its slot blocks, each contiguous and on
    its slot's device: `grid_sharding`'s split, or ``spec``'s (the mesh
    axis of each array axis).  Every split extent must divide its mesh
    extent (pad first: ``halo._pad_to_mesh``)."""
    return (grid_sharding(mesh, a.ndim) if spec is None else Placement(mesh, spec)).split(a)


def gather_blocks(mesh: Mesh, blocks: Sequence[torch.Tensor], spec=None) -> torch.Tensor:
    """The global field from its slot blocks, on slot 0's device."""
    return (grid_sharding(mesh, blocks[0].ndim) if spec is None else Placement(mesh, spec)).gather(blocks)


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """The state for the sharded step: on slot 0's device, where
    everything outside the three solves runs, with the particles padded
    to a multiple of the slot count as the JAX package pads them:
    zero-mass particles (inert: every scatter gates on m > 0) placed on
    particle 0, with zero velocity and APIC rows.  The rows divide by the
    slots: ``particle_sharding(mesh).split(state.particles.x)`` is each
    slot's block on its device, JAX's ``addressable_shards``.  JAX's
    ``shard_grid`` is not taken: it places the solid's dual lattices
    only when their extents divide the mesh, which the (2N + 1) lattice
    never does on an even mesh; the port's solid stays on slot 0's
    device, as JAX's then stays replicated."""
    dev = mesh.devices[0]
    p = state.particles
    n = p.x.shape[0]
    pad = (-n) % mesh.size
    x, v, c, m = (t.to(dev) for t in (p.x, p.v, p.c, p.m))
    if pad:
        x = torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
        v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
        c = torch.cat([c, c.new_zeros((pad,) + tuple(c.shape[1:]))])
        m = torch.cat([m, m.new_zeros((pad,))])
    sol = state.solid
    return SimState(
        particles=Particles(x=x, v=v, c=c, m=m),
        solid=type(sol)(phi=sol.phi.to(dev), v=sol.v.to(dev), rb=sol.rb.to(dev)),
        t=torch.as_tensor(state.t).to(dev),
        step_idx=torch.as_tensor(state.step_idx).to(dev),
        visc_mg=state.visc_mg,
    )
