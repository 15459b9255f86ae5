"""What the port's CUDA kernels take from the host, checked on the CPU
(no nvcc here): the coupled operator's compiled term table
(``csrc/coupled_tile.cuh::axis_plan``) against ``ops/cuda_cg.py::
stencil_plan()``, the tiled matvec's brick plan (``matvec_tiling``, each
brick decoded as the kernel decodes its block index) covering every face
of each field exactly once at the five grids the engine runs, the coupled
PCG's block -> brick schedule on a 132-block grid and its padded box
(``pcg_box``, ``pcg_boxes``, ``pcg_box_offset`` against the kernel's own
checks and staging), every
exported launcher's C signature against the ctypes argument types of
``ops/_cuda_build.py``, and the
segment broadcast's CPU route against the JAX package's
``binned_segment_broadcast`` in interpret mode on runs of repeated ids
that cross 32-row warps and on an odd channel count (the kernel's scalar
shape case).  Pure index arithmetic and text: no tensor of a grid's
size.
"""

import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops.pallas_binned import binned_segment_broadcast
from python_fluid_simulation_tpu_torch.ops import _cuda_build, cuda_binned, cuda_cg

TILE_HEADER = _cuda_build.SRC_DIR / "coupled_tile.cuh"
# cell resolutions: flagship, 128^3, coiling, 256, 504
GRIDS = [(48, 80, 48), (77, 128, 77), (64, 256, 64), (154, 256, 154), (126, 504, 126)]
H100_SMS = 132

_INT = r"(-?\d+)"
_VEC = r"\{" + r",\s*".join([_INT] * 3) + r"\}"
_FLOAT = r"(-?\d+\.\d*)f"
_TERM = re.compile(r"\{" + r",\s*".join([_INT, _VEC, _INT, _VEC, _INT, _VEC, _FLOAT]) + r"\}")


def _compiled_table():
    """The three AxisPlan initialisers of ``axis_plan``, parsed."""
    text = TILE_HEADER.read_text()
    body = text[text.index("constexpr AxisPlan kAxisPlans[3]"):text.index("return kAxisPlans[a];")]
    axes = re.split(r"//\s*axis \d", body)[1:]
    assert len(axes) == 3
    out = []
    for ax in axes:
        lines = [ln.strip() for ln in ax.splitlines() if ln.strip()]
        active = int(lines[0].split(",")[0])
        diag_cls = [int(v) for v in re.findall(_INT, lines[1])]
        diag_k = [tuple(int(v) for v in m) for m in re.findall(_VEC, lines[2])]
        factors = [float(v) for v in re.findall(_FLOAT, lines[3])]
        terms = []
        for m in _TERM.finditer(ax):
            g = m.groups()
            terms.append((int(g[0]), tuple(map(int, g[1:4])), int(g[4]), tuple(map(int, g[5:8])), int(g[8]),
                          tuple(map(int, g[9:12])), float(g[12])))
        out.append(dict(active=active, diag_cls=diag_cls, diag_k=diag_k, factors=factors, terms=terms))
    return out


def test_compiled_term_table_is_stencil_plan():
    ids = cuda_cg._class_ids()
    compiled = _compiled_table()
    for a, (ax, got) in enumerate(zip(cuda_cg.stencil_plan(), compiled)):
        assert got["active"] == ids[("sphi", ax["active"])], a
        assert got["diag_cls"] == [ids[("vol", c)] for c, _, _ in ax["diag"]], a
        assert got["diag_k"] == [tuple(k) for _, k, _ in ax["diag"]], a
        assert got["factors"] == [0.0 if f is None else f for _, _, f in ax["diag"]], a
        want = [(field, tuple(voff), ids[("sphi", ccls)], tuple(ck), ids[("vol", vcls)], tuple(vk), float(sf))
                for field, voff, ccls, ck, vcls, vk, sf in ax["terms"]]
        assert got["terms"] == want, a
        # the same-axis form takes the first SAME_TERMS terms
        assert [t[0] == a for t in got["terms"]] == [i < cuda_cg.SAME_TERMS for i in range(len(want))]


def test_tile_constants_match_the_header():
    text = TILE_HEADER.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (kTY|kTZ) = (\d+);", text)}
    assert (consts["kTY"], consts["kTZ"]) == (cuda_cg.TILE_Y, cuda_cg.TILE_Z)
    assert "__launch_bounds__(tile::kThreads, %d)" % cuda_cg.TILE_BLOCKS_PER_SM in (
        _cuda_build.SRC_DIR / "coupled_matvec.cu").read_text()


def _brick_box(n, tiling, b):
    """The faces of the union box (n0+1) x (n1+1) x (n2+1) that brick b
    owns, decoded as ``csrc/coupled_tile.cuh::matvec_brick`` decodes
    ``blockIdx.x``: ((x0, x1), (y0, y1), (z0, z1)), each half-open."""
    tiles_y, tiles_z, chunk, _ = tiling
    z0 = b % tiles_z * cuda_cg.TILE_Z
    y0 = b // tiles_z % tiles_y * cuda_cg.TILE_Y
    x0 = b // (tiles_y * tiles_z) * chunk
    return (x0, min(x0 + chunk, n[0] + 1)), (y0, y0 + cuda_cg.TILE_Y), (z0, z0 + cuda_cg.TILE_Z)


@pytest.mark.parametrize("n", GRIDS, ids=["flagship", "128", "coiling", "256", "504"])
def test_bricks_cover_every_face_once(n):
    tiling = cuda_cg.matvec_tiling(n, H100_SMS)
    tiles_y, tiles_z, chunk, bricks = tiling
    u = [k + 1 for k in n]
    assert tiles_y * cuda_cg.TILE_Y >= u[1] and tiles_z * cuda_cg.TILE_Z >= u[2] and chunk >= 1
    # the launcher's grid (csrc/coupled_matvec.cu)
    assert bricks == tiles_y * tiles_z * ((u[0] + chunk - 1) // chunk)
    boxes = [_brick_box(n, tiling, b) for b in range(bricks)]
    # the bricks are the products of three partitions of the union box
    for axis in range(3):
        spans = sorted({box[axis] for box in boxes})
        assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:])), axis
        assert spans[-1][1] >= u[axis] and spans[-1][0] < u[axis], axis
    assert len({tuple(box) for box in boxes}) == bricks  # no brick twice
    for f, shape in enumerate(cuda_cg._face_shapes(n)):
        covered = 0
        for box in boxes:
            covered += math.prod(max(0, min(hi, s) - lo) for (lo, hi), s in zip(box, shape))
        assert covered == math.prod(shape), f


PCG_SOURCE = _cuda_build.SRC_DIR / "coupled_visc_pcg.cu"
GRID_IDS = ["flagship", "128", "coiling", "256", "504"]


@pytest.mark.parametrize("n", GRIDS, ids=GRID_IDS)
def test_pcg_block_schedule_covers_every_face_once(n):
    """The coupled PCG's persistent blocks (one a SM) walk the bricks in
    the fixed order blockIdx.x, + gridDim.x, ... (``brick_phase``): every
    brick goes to exactly one block, at most one wave more than another
    block's, and the blocks' bricks cover every face of each field once."""
    tiling = cuda_cg.matvec_tiling(n, H100_SMS)
    bricks = tiling[3]
    assert "for (long b = blockIdx.x; b < bricks; b += gridDim.x)" in PCG_SOURCE.read_text()
    owned = [list(range(k, bricks, H100_SMS)) for k in range(H100_SMS)]
    assert sorted(b for bs in owned for b in bs) == list(range(bricks))
    assert max(map(len, owned)) - min(map(len, owned)) <= 1
    for f, shape in enumerate(cuda_cg._face_shapes(n)):
        covered = 0
        for bs in owned:
            for b in bs:
                box = _brick_box(n, tiling, b)
                covered += math.prod(max(0, min(hi, s) - lo) for (lo, hi), s in zip(box, shape))
        assert covered == math.prod(shape), f


def _pcg_kernel_box():
    """The box extents the kernel's launcher accepts, and its boxes' order."""
    text = PCG_SOURCE.read_text()
    m = re.search(r"box_x != n\[0\] \+ (\d+) \|\| box_y != n\[1\] \+ (\d+) \|\|\s*box_z != "
                  r"\(n\[2\] \+ (\d+) \+ 3\) / 4 \* 4", text)
    chain = re.findall(r"constexpr int k(\w+)Box = k(\w+)Box \+ 3;", text)
    assert "constexpr int kXBox = kClasses;" in text and "constexpr int kBoxes = kQBox + 3;" in text
    return tuple(int(v) for v in m.groups()), ["x"] + [new.lower() for new, _ in chain]


@pytest.mark.parametrize("n", GRIDS, ids=GRID_IDS)
def test_pcg_box_holds_each_array_with_its_fill(n):
    """The padded box at every grid: the launcher's extents are the ones
    the kernel accepts, 16-byte rows; each of the 25 arrays (the geometry
    classes in the plan's order, then x, pd, r, d, q) lies inside its box
    with a one-cell border of its fill (vol 0, sphi -1, pd 1, the rest 0),
    and the boxes do not overlap."""
    X, Y, Z = cuda_cg.pcg_box(n)
    (ax, ay, az), order = _pcg_kernel_box()
    assert (X, Y, Z) == (n[0] + ax, n[1] + ay, (n[2] + az + 3) // 4 * 4)
    assert Z % 4 == 0 and Z >= n[2] + 3
    assert [name for name, _ in cuda_cg.PCG_VECTORS] == order == ["x", "pd", "r", "d", "q"]
    boxes = cuda_cg.pcg_boxes(n)
    assert len(boxes) == 10 + 3 * len(cuda_cg.PCG_VECTORS)
    classes = list(cuda_cg.VOL_CLASSES) + list(cuda_cg.SPHI_CLASSES)
    want_fill = {"vol": 0.0, "sphi": -1.0, "x": 0.0, "pd": 1.0, "r": 0.0, "d": 0.0, "q": 0.0}
    size = X * Y * Z
    for j, (name, shape, fill) in enumerate(boxes):
        kind = name.split("(")[0].split("[")[0]
        assert fill == want_fill[kind], name
        if j < 10:
            assert shape == cuda_cg.class_shape(classes[j], n), name
        else:
            assert shape == cuda_cg._face_shapes(n)[(j - 10) % 3], name
        assert shape[0] + 2 <= X and shape[1] + 2 <= Y and shape[2] + 2 <= Z, name
        corners = [(0, 0, 0), tuple(s - 1 for s in shape), (-1, -1, -1), tuple(shape)]
        offs = [cuda_cg.pcg_box_offset(n, j, g) for g in corners]
        assert all(j * size <= o < (j + 1) * size for o in offs), name
        assert offs[0] == j * size + (Y + 1) * Z + 1 and offs[2] == j * size, name
        # consecutive z are consecutive, rows Z apart, planes Y * Z apart
        g = (shape[0] // 2, shape[1] // 2, shape[2] // 2)
        base = cuda_cg.pcg_box_offset(n, j, g)
        assert [cuda_cg.pcg_box_offset(n, j, (g[0] + dx, g[1] + dy, g[2] + dz)) - base
                for dx, dy, dz in ((0, 0, 1), (0, 1, 0), (1, 0, 0))] == [1, Z, Y * Z]


@pytest.mark.parametrize("n", GRIDS, ids=GRID_IDS)
def test_pcg_staging_reads_inside_the_box_and_covers_every_kept_face(n):
    """``coupled_tile.cuh::stage_box_plane`` for every brick: a window row
    is 9 copies of 16 bytes from box z0 (16-byte aligned), rows and copies
    past the box's edge skipped; no copy leaves the box, and every element
    that a face of the union face box reads (its one-cell neighbourhood)
    is copied."""
    X, Y, Z = cuda_cg.pcg_box(n)
    tiles_y, tiles_z, chunk, _ = cuda_cg.matvec_tiling(n, H100_SMS)
    u = [k + 1 for k in n]
    rows_w, quads_w = cuda_cg.TILE_Y + 2, (cuda_cg.TILE_Z + 4) // 4
    for ty in range(tiles_y):
        y0 = ty * cuda_cg.TILE_Y
        rows = min(rows_w, Y - y0)
        assert rows > 0 and y0 + rows <= Y
        kept_hi = min(y0 + cuda_cg.TILE_Y, u[1]) - 1 + 2  # box row of the last kept face's +1 neighbour
        assert y0 + rows - 1 >= kept_hi
    for tz in range(tiles_z):
        z0 = tz * cuda_cg.TILE_Z
        assert z0 % 4 == 0 and Z % 4 == 0  # each copy starts on 16 bytes
        quads = min(quads_w, (Z - z0) // 4)
        assert quads > 0 and z0 + 4 * quads <= Z
        kept_hi = min(z0 + cuda_cg.TILE_Z, u[2]) - 1 + 2
        assert z0 + 4 * quads - 1 >= kept_hi
    # every x plane a brick stages (x0 - 1 .. x1) is a box plane
    for c in range(-(-u[0] // chunk)):
        x0, x1 = c * chunk, min((c + 1) * chunk, u[0])
        assert x0 >= 0 and x1 + 1 <= X - 1  # box planes x0 .. x1 + 1


def _c_params(text, name):
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    return [p.strip() for p in m.group(1).split(",")] if m and m.group(1).strip() else []


def _ctype(param):
    if "*" in param:
        return ctypes.c_void_p
    for c, t in (("long long", ctypes.c_longlong), ("unsigned int", ctypes.c_uint), ("float", ctypes.c_float),
                 ("int", ctypes.c_int)):
        if param.startswith(c) or param.startswith("const " + c):
            return t
    raise AssertionError(f"unknown C parameter type: {param}")


def test_launcher_signatures_match_their_ctypes():
    text = "\n".join(p.read_text() for p in _cuda_build.sources())
    exported = set(re.findall(r'extern "C" int (pfs_\w+)\(', text))
    assert exported == set(_cuda_build._SIGNATURES)
    for name, argtypes in _cuda_build._SIGNATURES.items():
        assert [_ctype(p) for p in _c_params(text, name)] == argtypes, name


@pytest.mark.parametrize("c", [7, 54])
def test_broadcast_plain_matches_binned_kernel_on_runs(c):
    """Runs of 1-70 equal ids, so runs start and end inside and across the
    kernel's 32-row warps; ids below 0 and at or above M read 0."""
    rng = np.random.default_rng(c)
    m = 300
    keys = np.sort(np.concatenate([[-4, -1, m, m + 5], rng.choice(m, 116, replace=False)]))
    runs = rng.integers(1, 71, keys.shape[0])
    runs[0] += runs.sum() % 32 == 0  # a ragged last warp
    ids = np.repeat(keys, runs).astype(np.int64)
    table = rng.standard_normal((m, c)).astype(np.float32)
    before = cuda_binned.segment_broadcast.launches
    got = cuda_binned.segment_broadcast(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    assert cuda_binned.segment_broadcast.launches == before  # the CPU runs the plain version
    want = np.asarray(binned_segment_broadcast(jnp.asarray(table), jnp.asarray(ids.astype(np.int32)), interpret=True))
    live = (ids >= 0) & (ids < m)
    ref = np.zeros((ids.shape[0], c), np.float32)
    ref[live] = table[ids[live]]
    np.testing.assert_array_equal(got, ref)
    # the JAX kernel reads negative ids as rows of the first tile; the
    # contract (and the port) reads them as 0
    np.testing.assert_array_equal(got[live], want[live])
    np.testing.assert_array_equal(got[ids >= m], want[ids >= m])
