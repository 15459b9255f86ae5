"""The device-side loop of a captured step: a CUDA graph WHILE node
(``csrc/cuda_graph.cu``) around a body recorded from Python.

`captured_while` runs only while the current stream is being captured
into a CUDA graph by `graph_capture` (``torch.cuda.graph``, as
``engine/step.py::make_step`` captures the step, on one device or, for a
mesh over several cards, as one graph over all of them): it adds the
node (one a device, for a loop whose scalars are replicated a card),
records ``body()`` into each node's own body graph on a second stream of
its device, and ends each body with the exit test kernel.  The bodies'
allocations go to private pools that `graph_capture` makes for the graph
and the caller holds as long as the graph, so no replay writes memory
that the caching allocator has handed to anyone else.  Its plain version
is the host test of the eager loop (``solvers/cg.py::cg``), which the CPU
takes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb

_CAPTURES: list = []  # {device: its loop bodies' pool, or None where its allocations are routed already}, innermost last


@functools.lru_cache(maxsize=None)
def capture_stream(index: int) -> torch.cuda.Stream:
    """The stream device `index`'s graphs are captured on, made once
    (``torch.cuda.graph``'s own default is one stream of whichever device
    was current at its first use, for every later capture)."""
    return torch.cuda.Stream(device=index)


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph", device=None, devices=(), **kw):
    """``torch.cuda.graph(graph, **kw)`` on ``device`` (default: the
    current one), made current for the capture and recorded on its
    `capture_stream`.  Every other CUDA device of ``devices`` (the cards of
    a mesh over several) joins the capture: its `capture_stream` forks from
    the capture's, is its current stream until it joins back at the end,
    and its allocations go to a private pool of its own, so the graph is
    one program over all the devices, launched on ``device``.  Yields the
    private pools, which the caller holds as long as ``graph`` (the graph
    keeps using their memory): first the pool of the loop bodies
    `captured_while` records on ``device`` (the caching allocator refuses
    a second route to the graph's own pool while the graph is being
    captured), then one a further device (its top level and its bodies).
    ``graph_capture.nodes`` is then the top-level node count of the graph
    it captured last, every device's (a WHILE node once;
    ``captured_while.body_nodes`` has each body's)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    others = []
    for d in map(torch.device, devices):
        if d.type == "cuda" and d != dev and d not in others:
            others.append(d)
    pools = []
    for d in (dev, *others):
        with torch.cuda.device(d):
            pools.append(torch.cuda.MemPool())  # a pool belongs to the device current at its making
    for d in others:
        torch.cuda.synchronize(d)
    with contextlib.ExitStack() as routed:
        for d, pool in zip(others, pools[1:]):
            routed.enter_context(torch.cuda.use_mem_pool(pool, device=d))
        with torch.cuda.device(dev), torch.cuda.graph(graph, stream=capture_stream(dev.index), **kw):
            home = torch.cuda.current_stream()
            with contextlib.ExitStack() as joined:
                if others:
                    fork = torch.cuda.Event()
                    fork.record(home)
                    for d in others:
                        capture_stream(d.index).wait_event(fork)
                        joined.enter_context(torch.cuda.stream(capture_stream(d.index)))
                    joined.enter_context(torch.cuda.device(dev))  # entering a stream makes its device current
                _CAPTURES.append({dev: pools[0], **{d: None for d in others}})
                try:
                    yield pools
                    for d in others:
                        done = torch.cuda.Event()
                        done.record(capture_stream(d.index))
                        home.wait_event(done)
                    count = ctypes.c_ulonglong(0)
                    cb.check(cb.LIB.get().pfs_capture_nodes(home.cuda_stream, ctypes.byref(count)),
                             "graph node count")
                    graph_capture.nodes = count.value
                finally:
                    _CAPTURES.pop()


graph_capture.nodes = 0


@functools.lru_cache(maxsize=None)
def body_stream(index: int) -> torch.cuda.Stream:
    """The stream device `index`'s loop bodies are recorded on, made once."""
    return torch.cuda.Stream(device=index)


def captured_while(body, k, res, thresh, delta, max_iter: int):
    """Record ``while res >= thresh and k < max_iter and delta != 0:
    body(); k += 1`` into the graph being captured.

    ``k`` (int32) and ``res``, ``thresh``, ``delta`` (float32) are 0-dim
    tensors on one CUDA device, or tuples of them, one a device (the
    replicas of a distributed loop over several cards): each device gets
    a WHILE node of its own on its current stream, which tests that
    device's scalars, and ``body()`` is called once with every such
    device's current stream set to its node's body stream, so that each
    device's work lands in its own node's body (a WHILE body may hold one
    device's nodes only).  Bodies that read each other's data exchange it
    through kernels that wait for each other on the devices (the halo
    push, the cross-card sum); no event joins two bodies.  ``body()`` must
    leave its results in place, in tensors made before this call (``res``
    and ``delta`` among them): the graph runs the same recorded work on
    the same memory every iteration.  Each test kernel adds one to its
    ``k`` after each body."""
    loops = list(zip(*(t if isinstance(t, tuple) else (t,) for t in (k, res, thresh, delta))))
    devices = []
    for kk, rr, tt, dd in loops:
        dev = kk.device
        for name, t, dtype in (("k", kk, torch.int32), ("res", rr, torch.float32),
                               ("thresh", tt, torch.float32), ("delta", dd, torch.float32)):
            if t.device != dev or t.dtype != dtype or t.dim() != 0:
                raise ValueError(f"captured_while: {name} must be a 0-dim {dtype} tensor on {dev}, "
                                 f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if dev in devices:
            raise ValueError(f"captured_while: two loops on {dev}")
        devices.append(dev)
    if not _CAPTURES or any(d not in _CAPTURES[-1] for d in devices):
        raise RuntimeError(f"captured_while: the loops' devices {[str(d) for d in devices]} are not being captured "
                           "by graph_capture")
    lib = cb.LIB.get()
    begun = []
    recorded = False
    try:
        for dev, (kk, rr, tt, dd) in zip(devices, loops):
            args = (kk.data_ptr(), rr.data_ptr(), tt.data_ptr(), dd.data_ptr(), int(max_iter))
            handle = ctypes.c_ulonglong(0)
            with torch.cuda.device(dev):
                if not torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(f"captured_while: the current stream of {dev} is not being captured")
                cb.check(lib.pfs_while_begin(torch.cuda.current_stream(dev).cuda_stream,
                                             body_stream(dev.index).cuda_stream, *args, ctypes.byref(handle)),
                         "while node")
            begun.append((dev, handle, args))
        with contextlib.ExitStack() as stack:
            here = torch.cuda.current_device()
            for dev in devices:
                stack.enter_context(torch.cuda.stream(body_stream(dev.index)))
                if _CAPTURES[-1][dev] is not None:
                    stack.enter_context(torch.cuda.use_mem_pool(_CAPTURES[-1][dev], device=dev))
            stack.enter_context(torch.cuda.device(here))
            body()
        recorded = True
    finally:
        errs = []
        for dev, handle, args in begun:
            nodes = ctypes.c_ulonglong(0)
            with torch.cuda.device(dev):
                err = lib.pfs_while_end(body_stream(dev.index).cuda_stream, ctypes.byref(handle), *args,
                                        int(recorded), ctypes.byref(nodes))
            errs.append(err)
            if recorded and not err:
                captured_while.nodes += 1
                captured_while.body_nodes.append(nodes.value)
    for err in errs:
        cb.check(err, "while node body")


captured_while.nodes = 0  # WHILE nodes recorded (a replay runs each one's test kernel once an iteration)
captured_while.body_nodes = []  # the nodes of each body recorded, in order (its test kernel among them)
