"""Build and load the package's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ONE ``nvcc`` call into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds).  The build happens at the
first kernel launch, never at import, and is keyed on a hash of the
sources and flags: ``_build/libpfs_kernels_<hash>.so`` under the package
(listed in ``.gitignore``).  Nothing here runs on a machine without a
kernel launch, so the CPU-only tests never need ``nvcc``.
"""

from __future__ import annotations

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
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every exported function (pointers and the stream as void*)
_SIGNATURES = {
    "pfs_cell_poisson_pcg": [_P] * 9 + [_P] * 5 + [_I] + [_P] * 3 + [_I] * 3 + [_F, _F, _I, _P],
    "pfs_coupled_visc_pcg": [_P, _I] + [_P] * 10 + [_I] + [_P] * 4 + [_F, _F, _I, _P],
    "pfs_stencil_matvec": [_P] * 9 + [_I] * 3 + [_P],
    "pfs_mg_level_chain": [_P] * 12 + [_I] * 4 + [_F, _P],
    "pfs_binned_reduce": [_P, _P, _L] + [_I] * 4 + [_F, _P, _P],
    "pfs_binned_broadcast": [_P, _P, _L, _I, _I, _P, _P],
}


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float  # wall time of the nvcc call; 0 when it was cached
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(SRC_DIR.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile every ``csrc/*.cu`` into one .so (skipped when the library
    for this source hash already exists)."""
    out = BUILD_DIR / f"libpfs_kernels_{_key()}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "", True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return BuildInfo(out, seconds, log, False)


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


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
