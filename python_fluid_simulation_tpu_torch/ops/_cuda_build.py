"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` sources are compiled into one shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds): one ``nvcc -c`` per source, all started together,
then one link.  The build happens at the first kernel launch, never at
import, and is keyed on a hash of the sources and of both flag lists:
``_build/libpfs_kernels_<hash>.so`` under the package (listed in
``.gitignore``).  Nothing here runs on a machine without a
kernel launch, so the CPU-only tests never need ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]  # each compile
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]  # the one link

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every exported function (pointers and the stream as void*)
_SIGNATURES = {
    "pfs_poisson_pcg": [_P] * 16 + [_I, _P, _L] + [_P] * 3 + [_I] * 3 + [_F, _F, _I, _P],
    "pfs_coupled_visc_pcg": [_P] + [_I] * 7 + [_P] * 5 + [_L, _P, _I] + [_P] * 4 + [_F, _F, _I, _P],
    "pfs_coupled_matvec": [_P, _I, _I, _I, _I] + [_P] * 8 + [_I, _P],
    "pfs_stencil_matvec": [_P] * 9 + [_I] * 4 + [_P],
    "pfs_coupled_stencil_matvec": [_P] * 4,
    "pfs_mg_vcycle_tail": [_P, _I, _I] + [_P] * 3 + [_I] * 6 + [_F, _P],
    "pfs_binned_reduce": [_P, _P, _L] + [_I] * 4 + [_F, _P, _P],
    "pfs_binned_place_live": [_P, _P, _L] + [_I] * 3 + [_F, _P, _L, _P, _P, _L, _P],
    "pfs_seg_scan": [_P, _P, _L, _I, _I, _P, _P],
    "pfs_binned_broadcast": [_P, _P, _L, _I, _I, _P, _P],
    "pfs_fold": [_P] * 4 + [_I] * 9 + [_P, _F, _F, _I, _I, _P],
    "pfs_halo_grid_cap": [_P, _P],
    "pfs_halo_exchange": [_P] * 5 + [_I, _I, _L, _L, _I, _P],
    "pfs_mesh_psum": [_P] * 6 + [_I, _I, _I, _P],
    "pfs_halo_pull": [_P, _I, _L, _L, _I, _P],
    "pfs_enable_peer": [_I],
    "pfs_while_begin": [_P] * 6 + [_I, _P],
    "pfs_while_end": [_P] * 6 + [_I, _I, _P],
    "pfs_capture_nodes": [_P, _P],
}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float  # wall time of the compiles and the link; 0 when it was cached
    log: str  # nvcc's output (-Xptxas -v register / smem / spill lines)
    cached: bool


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ["|"] + LINK_FLAGS).encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile every ``csrc/*.cu`` into one .so (skipped when the library
    for this source hash already exists): the sources in parallel, one
    ``nvcc -c`` each, then one link."""
    out = BUILD_DIR / f"libpfs_kernels_{_key()}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "", True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(tmpdir, src.stem + ".o"), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for cmd, proc in jobs:  # wait for every compile before reporting one
            logs.append((cmd, proc.communicate()[0], proc.returncode))
        link = [nvcc, *LINK_FLAGS, "-o", os.path.join(tmpdir, "lib.so"), *[c[c.index("-o") + 1] for c, _, _ in logs]]
        for cmd, log, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        os.replace(os.path.join(tmpdir, "lib.so"), out)
    seconds = time.perf_counter() - t0
    return BuildInfo(out, seconds, "".join(log for _, log, _ in logs), False)


class _Lib:
    """The loaded kernel library, built on first use."""

    def __init__(self):
        self.handle = None
        self.info = None

    def get(self):
        if self.handle is None:
            self.info = build()
            lib = ctypes.CDLL(str(self.info.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self.handle = lib
        return self.handle


LIB = _Lib()


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def launch_device(name: str, *tensors):
    """The one CUDA device of `tensors` (None entries skipped): a launch
    runs there.  Raises ValueError where two of them lie on different
    devices; there is no copy to a common device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: inputs on {dev} and {t.device}; a launch takes tensors of one device")
    if dev is None or dev.type != "cuda":
        raise ValueError(f"{name}: a launch needs CUDA tensors, got {dev}")
    return dev


@contextlib.contextmanager
def launching(name: str, *tensors, stream=None):
    """The context of every kernel launch: the tensors' one device
    (`launch_device`) made current, so the launcher's device queries,
    attributes and cooperative launches are that card's, and the handle
    of the stream to launch on yielded: ``stream`` (a stream of that
    device), by default the device's current stream.  The previous
    device is current again afterwards."""
    import torch

    dev = launch_device(name, *tensors)
    if stream is not None and stream.device != dev:
        raise ValueError(f"{name}: a stream of {stream.device} for tensors on {dev}")
    with torch.cuda.device(dev):
        yield (stream or torch.cuda.current_stream(dev)).cuda_stream
