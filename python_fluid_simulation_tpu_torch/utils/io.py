"""Artifact IO: the particle-position series and surface export.

Counterpart of ``python_fluid_simulation_tpu.utils.io``.  Reference
counterparts: the per-snapshot particle series pickled at run end (cell
13 :4665-4670, one snapshot every int(1/DT/20) steps with the k3d
[x, z, y] axis shuffle) and k3d marching-cubes visualisation of the
solid SDF (cell 10 :785-795).

Surfaces are triangulated by the native marching cubes (``native/``,
built with ``g++`` at first use); a failed build or call raises.
`marching_cubes_plain` is the same tetrahedral scheme in NumPy, kept as
the reference the tests hold the native library to.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np


def _numpy(a) -> np.ndarray:
    """A host numpy array of an array or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class ParticleSeries:
    """Snapshot store matching the reference's pickle layout:
    {time: positions[N, 3] float32 in [x, z, y] order}."""

    def __init__(self, k3d_axis_order: bool = True):
        self._order = [0, 2, 1] if k3d_axis_order else [0, 1, 2]
        self.series: Dict[float, np.ndarray] = {}

    def snapshot(self, t: float, positions) -> None:
        pos = _numpy(positions).astype(np.float32, copy=False)
        if pos.shape[-1] == len(self._order):
            pos = pos[:, self._order]
        self.series[float(t)] = pos

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.series, f)

    @staticmethod
    def load(path: str) -> "ParticleSeries":
        """Read a series pickle (unpickling runs code: load only files
        this program or the reference wrote)."""
        out = ParticleSeries()
        with open(path, "rb") as f:
            out.series = pickle.load(f)
        return out


def snapshot_interval(dt: float, per_second: int = 20) -> int:
    """Reference: int(1/DT/20) steps between snapshots (cell 13 :4665)."""
    return max(1, int(1.0 / dt / per_second))


def export_levelset_obj(phi, path: str, level: float = 0.0, origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)) -> int:
    """Triangulate the `level` isosurface of a 3D scalar field (an array
    or a tensor on any device) to an OBJ file with the native marching
    cubes; the reference renders it with k3d.marching_cubes in-notebook
    (cell 10 :785-795).  Returns the triangle count."""
    verts, tris = triangulate_levelset(phi, level, origin, spacing)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"f {t[0]+1} {t[1]+1} {t[2]+1}\n")
    return len(tris)


def triangulate_levelset(phi, level: float = 0.0, origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
    """(verts (V, 3) float32 in world units, tris (T, 3) int32) of the
    `level` isosurface, by the native marching cubes (built on first
    use; a failure raises)."""
    from python_fluid_simulation_tpu_torch.native import marching_cubes

    verts, tris = marching_cubes.run(np.ascontiguousarray(_numpy(phi), dtype=np.float32), level)
    return _to_world(verts, origin, spacing), np.asarray(tris)


def _to_world(verts, origin, spacing):
    return np.asarray(verts, np.float32) * np.asarray(spacing, np.float32) + np.asarray(origin, np.float32)


_TETS = [(0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6)]
_CORNERS = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]


def marching_cubes_plain(phi: np.ndarray, level: float):
    """Tetrahedra-based surface extraction in NumPy (the JAX package's
    ``_marching_cubes_numpy``): each cube straddling the level is split
    into 6 tetrahedra, and each crossing tetrahedron emits one triangle
    or a quad.  Returns (verts (V, 3) float32 in index units, tris (T, 3)
    int32)."""
    verts, tris = [], []
    nx, ny, nz = phi.shape
    f = phi - level
    sign = f > 0
    all_pos = np.ones((nx - 1, ny - 1, nz - 1), bool)
    all_neg = np.ones_like(all_pos)
    for dx, dy, dz in _CORNERS:
        s = sign[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
        all_pos &= s
        all_neg &= ~s
    straddle = ~(all_pos | all_neg)
    for x, y, z in zip(*np.nonzero(straddle)):
        corner_pos = [np.array([x + c[0], y + c[1], z + c[2]], np.float32) for c in _CORNERS]
        corner_val = [f[x + c[0], y + c[1], z + c[2]] for c in _CORNERS]
        for tet in _TETS:
            vals = [corner_val[i] for i in tet]
            pos = [corner_pos[i] for i in tet]
            inside = [v < 0 for v in vals]
            n_in = sum(inside)
            if n_in in (0, 4):
                continue
            ins = [i for i in range(4) if inside[i]]
            outs = [i for i in range(4) if not inside[i]]

            def ip(i, j):
                a, b = vals[i], vals[j]
                t = a / (a - b) if a != b else 0.5
                return pos[i] + t * (pos[j] - pos[i])

            base = len(verts)
            if n_in == 1:
                verts.extend(ip(ins[0], j) for j in outs)
                tris.append((base, base + 1, base + 2))
            elif n_in == 3:
                verts.extend(ip(j, outs[0]) for j in ins)
                tris.append((base, base + 1, base + 2))
            else:  # 2 in, 2 out: a quad
                (i0, i1), (o0, o1) = ins, outs
                verts.extend([ip(i0, o0), ip(i0, o1), ip(i1, o1), ip(i1, o0)])
                tris.append((base, base + 1, base + 2))
                tris.append((base, base + 2, base + 3))
    if not verts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)
