"""Native (C++) host-side pieces of the port, loaded with ``ctypes``.

The CUDA kernels live in ``csrc/`` (``ops/_cuda_build.py``); this is the
surface extraction behind the OBJ export and the HTML viewer's solid
wireframe: ``src/marching_cubes.cpp``, the JAX package's source copied
here, with the same ``mc_run`` / ``mc_free`` C interface.  It is built
with ``g++`` at first use, never at import, into
``python_fluid_simulation_tpu_torch/_build/libpfsnative_<hash>.so``
(gitignored), keyed on a hash of the source and the compiler flags.  A
failed build or call raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = Path(__file__).resolve().parent / "src" / "marching_cubes.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libpfsnative_{h.hexdigest()[:16]}.so"


class _Native:
    """The loaded library, built on first use; ``build_seconds`` is the
    wall time of the ``g++`` call (0 when the library was already
    built)."""

    def __init__(self):
        self.handle = None
        self.build_seconds = None

    def get(self):
        if self.handle is None:
            self.handle = self._load()
        return self.handle

    def _load(self):
        out = library_path()
        self.build_seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            # build beside the target, then rename: concurrent processes
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", tmp]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        lib.mc_run.restype = ctypes.c_int
        lib.mc_run.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mc_free.restype = None
        lib.mc_free.argtypes = [ctypes.c_void_p]
        return lib


LIB = _Native()


def load():
    """The native library (built here on first use)."""
    return LIB.get()


class marching_cubes:  # namespace-style accessor, as the JAX package's
    @staticmethod
    def run(phi: np.ndarray, level: float = 0.0):
        """(verts (V, 3) float32 in index units, tris (T, 3) int32) of the
        `level` isosurface of a 3D float32 field."""
        lib = load()
        phi = np.ascontiguousarray(phi, dtype=np.float32)
        if phi.ndim != 3:
            raise ValueError(f"marching_cubes: a 3D field, got shape {phi.shape}")
        nx, ny, nz = phi.shape
        vptr = ctypes.POINTER(ctypes.c_float)()
        tptr = ctypes.POINTER(ctypes.c_int32)()
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        rc = lib.mc_run(
            phi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nx, ny, nz, ctypes.c_float(level),
            ctypes.byref(vptr), ctypes.byref(nv),
            ctypes.byref(tptr), ctypes.byref(nt),
        )
        if rc != 0:
            raise MemoryError("mc_run failed")
        try:
            verts = (np.ctypeslib.as_array(vptr, shape=(nv.value, 3)).copy() if nv.value
                     else np.zeros((0, 3), np.float32))
            tris = (np.ctypeslib.as_array(tptr, shape=(nt.value, 3)).copy() if nt.value
                    else np.zeros((0, 3), np.int32))
        finally:
            lib.mc_free(vptr)
            lib.mc_free(tptr)
        return verts, tris
