"""A model of the index logic of ``csrc/mg_vcycle.cu``'s tail kernel, over
torch tensors on any device:

* the packed level descriptors (``ops/cuda_mg.py::pack_levels``), decoded
  word by word back into the tensors they point at;
* the kernel's schedule: each level's phases on the way down (the fused
  restriction with the first relaxation, then the others) and up (the
  first post-relaxation reading x + the parent's correction, then the
  others), the grid-to-block split at the tail's `block_level` (the grid
  restricts into the block's first level, block 0 stages it), and the
  barrier after each phase (a grid barrier, or __syncthreads inside block
  0, and one grid barrier where the grid waits for the block);
* every phase as the kernel computes a cell, from flat indices: the
  stencil's neighbours and bounds (each system's own x bounds in a stack),
  a coarse cell's 2^3 children in the kernel's order (x pairs, then z,
  then y; zero for a child past an odd edge: the kernel's lane butterfly
  adds the same pairs), each child's residual, the parent of a fine cell,
  the ping-pong buffers.

The kernel's constants are read from the source.  tests/test_torch_vcycle_tail.py
holds the model bitwise to ``vcycle_tail_plain`` on the CPU at every
split; ``chip_smoke.py`` holds the kernel bitwise to both on the card.
The model imports no JAX.
"""

import re
from typing import List, NamedTuple, Tuple

import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build


def _const(name):
    text = (_cuda_build.SRC_DIR / "mg_vcycle.cu").read_text()
    return int(re.search(rf"\b{name} = (\d+);", text).group(1))


WORDS = _const("kWords")
MAX_LEVELS = _const("kMaxLevels")


class Level(NamedTuple):
    diag: torch.Tensor  # flat
    coef: Tuple[torch.Tensor, ...]  # flat, +x, -x, +y, -y, +z, -z
    b: torch.Tensor
    buf: Tuple[torch.Tensor, torch.Tensor]
    dims: Tuple[int, int, int, int]  # B, X, Y, Z


def decode(tail) -> List[Level]:
    """The descriptor rows of `tail.desc` as the kernel reads them."""
    assert tail.desc.shape == (len(tail.levels), WORDS) and len(tail.levels) <= MAX_LEVELS
    by_ptr = {}
    for lv, work in zip(tail.levels, tail.work):
        for t in (lv.diag, *[c for _, c in lv.coefs], *work):
            by_ptr[t.data_ptr()] = t.reshape(-1)
    out = []
    for row in tail.desc.tolist():
        f = [by_ptr[p] for p in row[:10]]
        dims = tuple(int(v) for v in row[10:14])
        assert all(t.numel() == dims[0] * dims[1] * dims[2] * dims[3] for t in f)
        out.append(Level(f[0], tuple(f[1:7]), f[7], (f[8], f[9]), dims))
    return out


def _coords(i, dims):
    _, X, Y, Z = dims
    cz = i % Z
    q = i // Z
    cy = q % Y
    q2 = q // Y
    return q2 // X, q2 % X, cy, cz


def _stencil(lv, i, at):
    """(A p)[i], p read through at(j): diag first, then the six offsets."""
    _, X, Y, Z = lv.dims
    _, cx, cy, cz = _coords(i, lv.dims)
    zero = torch.zeros((), dtype=lv.diag.dtype, device=i.device)
    acc = lv.diag[i] * at(i)
    for c, (ok, off) in zip(lv.coef, ((cx + 1 < X, Y * Z), (cx > 0, -Y * Z), (cy + 1 < Y, Z), (cy > 0, -Z),
                                      (cz + 1 < Z, 1), (cz > 0, -1))):
        acc = acc + c[i] * torch.where(ok, at(torch.where(ok, i + off, i)), zero)
    return acc


def _parent(i, fine, coarse):
    bb, cx, cy, cz = _coords(i, fine)
    _, cX, cY, cZ = coarse
    return ((bb * cX + cx // 2) * cY + cy // 2) * cZ + cz // 2


def _inv(lv, omega):
    d = lv.diag
    return torch.full_like(d, omega) / torch.where(d > 0, d, torch.ones_like(d))


def schedule(tail, block_level=None):
    """The kernel's phases in order: (level, phase, scope), phase 'restrict'
    (with the first relaxation), 'relax', 'prolong' (the first
    post-relaxation), 'stage' (block 0 copies the grid's restriction into
    the block's first level to shared memory), 'join' (the grid's wait for
    block 0) or 'out'; scope 'grid' or 'block'."""
    big_l, n = len(tail.levels), tail.n_smooth
    s = tail.block_level if block_level is None else block_level
    out = []

    def down(k, scope, first="restrict"):
        out.append((k, first, scope))
        out.extend((k, "relax", scope) for _ in range((tail.coarse_iters if k == big_l else n) - 1))

    def up(k, scope):
        out.append((k, "prolong", scope))
        out.extend((k, "relax", scope) for _ in range(n - 1))

    for k in range(1, min(s - 1, big_l) + 1):
        down(k, "grid")
    if s <= big_l:
        # the grid restricts into level s, block 0 stages it and goes on
        out.append((s, "restrict", "grid"))
        down(s, "block", first="stage")
        for k in range(s + 1, big_l + 1):
            down(k, "block")
        for k in range(big_l - 1, s - 1, -1):
            up(k, "block")
        out.append((0, "join", "grid"))
    for k in range(min(s - 1, big_l - 1), 0, -1):
        up(k, "grid")
    out.append((0, "out", "grid"))
    return out


def barriers(sched):
    """(grid, block) barriers: one after each phase but the last."""
    grid = sum(1 for _, p, sc in sched if sc == "grid" and p != "out")
    block = sum(1 for _, p, sc in sched if sc == "block")
    return grid, block


def vcycle_tail_model(tail, x, r, block_level=None):
    """The tail kernel's output for the level-0 iterate x and residual r,
    phase by phase in its schedule, writing the tail's workspace as the
    kernel does."""
    lv = [None, *decode(tail)]
    big_l, n, omega = len(tail.levels), tail.n_smooth, tail.omega
    top = tuple(int(v) for v in (tail.fine_shape if len(tail.fine_shape) == 4 else (1, *tail.fine_shape)))
    x0, r0 = x.reshape(-1), r.reshape(-1)
    dev = x.device
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    down_left = {k: 0 for k in range(1, big_l + 1)}  # relaxations done on the way down
    up_left = {k: 0 for k in range(1, big_l)}

    def iters(k):
        return tail.coarse_iters if k == big_l else n

    def result(k):  # where level k's iterate ends: the coarse solve's, or the post-smoothed one
        return lv[k].buf[(iters(k) - 1) & 1] if k == big_l else lv[k].buf[1]

    out = torch.empty_like(x0)
    for k, phase, _ in schedule(tail, block_level):
        if phase == "restrict":
            c = lv[k]
            fine = top if k == 1 else lv[k - 1].dims
            bb, cx, cy, cz = _coords(torch.arange(c.diag.numel(), device=dev), c.dims)
            _, fX, fY, fZ = fine

            def child(jx, jy, jz):
                fx, fy, fz = 2 * cx + jx, 2 * cy + jy, 2 * cz + jz
                ok = (fx < fX) & (fy < fY) & (fz < fZ)
                j = torch.where(ok, ((bb * fX + fx) * fY + fy) * fZ + fz, torch.zeros_like(fx))
                if k == 1:
                    val = r0[j]
                else:
                    f = lv[k - 1]
                    xf = f.buf[(n - 1) & 1]
                    val = f.b[j] - _stencil(f, j, lambda m: xf[m])
                return torch.where(ok, val, zero)

            s2 = []
            for jy in (0, 1):
                s1 = [child(0, jy, jz) + child(1, jy, jz) for jz in (0, 1)]  # x pairs
                s2.append(s1[0] + s1[1])  # z pair
            bv = s2[0] + s2[1]  # y pair
            c.b.copy_(bv)
            c.buf[0].copy_(bv * _inv(c, omega))
            down_left[k] = 1
        elif phase == "stage":
            pass  # the same values, moved to shared memory
        elif phase == "relax":
            c = lv[k]
            if down_left[k] < iters(k):
                j = down_left[k]
                src, dst = c.buf[(j - 1) & 1], c.buf[j & 1]
                down_left[k] += 1
            else:
                j = up_left[k]
                src, dst = c.buf[(n - 1 + j) & 1], c.buf[(n + j) & 1]
                up_left[k] += 1
            i = torch.arange(c.diag.numel(), device=dev)
            dst.copy_(src + (c.b - _stencil(c, i, lambda m: src[m])) * _inv(c, omega))
        elif phase == "prolong":
            c, e = lv[k], result(k + 1)
            xpre = c.buf[(n - 1) & 1]
            i = torch.arange(c.diag.numel(), device=dev)

            def at(m):
                return xpre[m] + e[_parent(m, c.dims, lv[k + 1].dims)]

            c.buf[n & 1].copy_(at(i) + (c.b - _stencil(c, i, at)) * _inv(c, omega))
            up_left[k] = 1
        elif phase == "out":
            i = torch.arange(x0.numel(), device=dev)
            out = x0 + result(1)[_parent(i, top, lv[1].dims)]
    return out.reshape(x.shape)
