"""The device-side loop of a captured step: a CUDA graph WHILE node
(``csrc/cuda_graph.cu``) around a body recorded from Python.

`captured_while` runs only while the current stream is being captured
into a CUDA graph by `graph_capture` (``torch.cuda.graph``, as
``engine/step.py::make_step`` captures the step): it adds the node,
records ``body()`` into the node's own body graph on a second stream,
and ends the body with the exit test kernel.  The body's allocations go
to a private pool that `graph_capture` makes for the graph and the
caller holds as long as the graph, so no replay writes memory that the
caching allocator has handed to anyone else.  Its plain version is the
host test of the eager loop (``solvers/cg.py::cg``), which the CPU takes.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb

_POOLS: list = []  # the body pools of the graphs `graph_capture` is capturing, innermost last


@functools.lru_cache(maxsize=None)
def capture_stream(index: int) -> torch.cuda.Stream:
    """The stream device `index`'s graphs are captured on, made once
    (``torch.cuda.graph``'s own default is one stream of whichever device
    was current at its first use, for every later capture)."""
    return torch.cuda.Stream(device=index)


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph", device=None, **kw):
    """``torch.cuda.graph(graph, **kw)`` on ``device`` (default: the
    current one), made current for the capture and recorded on its
    `capture_stream`, with a private pool of its own for the loop bodies
    `captured_while` records, which it yields: the body graphs keep using
    its memory, so it must live as long as ``graph``.  (The caching
    allocator refuses a second route to the graph's own pool while the
    graph is being captured.)  ``graph_capture.nodes`` is then the
    top-level node count of the graph it captured last (a WHILE node
    once; ``captured_while.body_nodes`` has each body's)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    with torch.cuda.device(dev):
        body_pool = torch.cuda.MemPool()  # a pool belongs to the device current at its making
        with torch.cuda.graph(graph, stream=capture_stream(dev.index), **kw):
            _POOLS.append(body_pool)
            try:
                yield body_pool
                count = ctypes.c_ulonglong(0)
                cb.check(cb.LIB.get().pfs_capture_nodes(torch.cuda.current_stream().cuda_stream,
                                                        ctypes.byref(count)), "graph node count")
                graph_capture.nodes = count.value
            finally:
                _POOLS.pop()


graph_capture.nodes = 0


@functools.lru_cache(maxsize=None)
def body_stream(index: int) -> torch.cuda.Stream:
    """The stream device `index`'s loop bodies are recorded on, made once."""
    return torch.cuda.Stream(device=index)


def captured_while(body, k, res, thresh, delta, max_iter: int):
    """Record ``while res >= thresh and k < max_iter and delta != 0:
    body(); k += 1`` into the graph being captured on the current stream.

    ``k`` (int32) and ``res``, ``thresh``, ``delta`` (float32) are 0-dim
    tensors on one CUDA device.  ``body()`` must leave its results in
    place, in tensors made before this call (``res`` and ``delta`` among
    them): the graph runs the same recorded work on the same memory every
    iteration.  The test kernel adds one to ``k`` after each body."""
    dev = k.device
    for name, t, dtype in (("k", k, torch.int32), ("res", res, torch.float32),
                           ("thresh", thresh, torch.float32), ("delta", delta, torch.float32)):
        if t.device != dev or t.dtype != dtype or t.dim() != 0:
            raise ValueError(f"captured_while: {name} must be a 0-dim {dtype} tensor on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.type != "cuda" or not torch.cuda.is_current_stream_capturing() or not _POOLS:
        raise RuntimeError("captured_while: the current stream is not being captured by graph_capture")
    lib = cb.LIB.get()
    side = body_stream(dev.index)
    handle = ctypes.c_ulonglong(0)
    args = (k.data_ptr(), res.data_ptr(), thresh.data_ptr(), delta.data_ptr(), int(max_iter))
    if torch.cuda.current_device() != dev.index:
        raise RuntimeError(f"captured_while: the loop's tensors are on {dev}, the capture on "
                           f"cuda:{torch.cuda.current_device()}")
    cb.check(lib.pfs_while_begin(torch.cuda.current_stream(dev).cuda_stream, side.cuda_stream, *args,
                                 ctypes.byref(handle)), "while node")
    recorded = False
    nodes = ctypes.c_ulonglong(0)
    try:
        with torch.cuda.stream(side), torch.cuda.use_mem_pool(_POOLS[-1], device=dev):
            body()
        recorded = True
    finally:
        err = lib.pfs_while_end(side.cuda_stream, ctypes.byref(handle), *args, int(recorded), ctypes.byref(nodes))
    cb.check(err, "while node body")
    captured_while.nodes += 1
    captured_while.body_nodes.append(nodes.value)


captured_while.nodes = 0  # WHILE nodes recorded (a replay runs each one's test kernel once an iteration)
captured_while.body_nodes = []  # the nodes of each body recorded, in order (its test kernel among them)
