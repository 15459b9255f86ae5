"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/sdf.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Analytic rigid-body signed-distance fields (3D): evaluate & project.

Counterpart of ``python_fluid_simulation_tpu.ops.sdf`` (the reference's
``solver/sdf3D.py``).  The rigid-body table encoding is bit-compatible
with the reference (sdf3D.py:294-327):

  rb: (B, 10, 4) float32
    row 0      : [type, p0, p1, p2]  type: 0/1 sphere(+flip), 2/3 box,
                 4/5 cylinder;  sphere p0=radius; box p0..p2=xyz scale;
                 cylinder p0=radius, p1=height
    rows 1:5   : 4x4 translation matrix T
    rows 5:9   : 4x4 rotation matrix R
    row 9      : [vx, vy, vz, 0] body velocity

Every primitive is evaluated for every body and the results combined
with ``torch.where`` on the body's type code, so the table can stay on
the device without a host read of its types.

Divergences from the reference (the same as the JAX package's):
  * ``cylinder_eval``'s use of ``y_clip`` before assignment
    (sdf3D.py:154-160) is fixed by initialising ``y_clip = clamp(y)``;
  * normalisation guards against |p - t| == 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.ops.indexing import rounded_sqrt

_FAR = 100.0  # reference seeds min-distance searches at 100 (sdf3D.py:228)


def _rotation_matrix(axis: Sequence[float], angle_deg: float) -> np.ndarray:
    """Rodrigues rotation; reference uses scipy Rotation (sdf3D.py:286-291)."""
    m = np.eye(4)
    if angle_deg:
        a = np.asarray(axis, dtype=np.float64)
        a = a / np.linalg.norm(a)
        t = math.radians(angle_deg)
        K = np.array(
            [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]],
            dtype=np.float64,
        )
        m[:3, :3] = np.eye(3) + math.sin(t) * K + (1 - math.cos(t)) * (K @ K)
    return m


_TYPE_CODES = {"sphere": 0, "box": 2, "cylinder": 4}


def make_body(
    kind: str,
    params: Sequence[float],
    flip: bool = False,
    center: Sequence[float] = (0.0, 0.0, 0.0),
    axis: Sequence[float] = (0.0, 1.0, 0.0),
    angle: float = 0.0,
    velocity: Sequence[float] = (0.0, 0.0, 0.0),
) -> np.ndarray:
    """One (10,4) rigid-body block. Reference: generate_rb sdf3D.py:294-327."""
    if kind not in _TYPE_CODES:
        raise ValueError(f"unknown rigid body kind {kind!r}")
    rb = np.zeros((10, 4), dtype=np.float32)
    rb[0, 0] = _TYPE_CODES[kind] + (1 if flip else 0)
    p = list(params)
    rb[0, 1 : 1 + len(p)] = p
    t = np.eye(4)
    t[0:3, 3] = np.asarray(center)
    rb[1:5, :] = t
    rb[5:9, :] = _rotation_matrix(axis, angle)
    rb[9, :3] = np.asarray(velocity)
    return rb


class RigidBodySet:
    """Named collection of rigid bodies -> a single (B,10,4) table.

    Mirrors the reference's (rb_d, rb_map) pair and its generate_rb /
    transform_rb / set_vel_rb host API (sdf3D.py:294-336).
    """

    def __init__(self):
        self._blocks: List[np.ndarray] = []
        self.name_to_index: Dict[str, int] = {}

    def add(self, name: str, kind: str, params, **kw) -> int:
        idx = len(self._blocks)
        self._blocks.append(make_body(kind, params, **kw))
        self.name_to_index[name] = idx
        return idx

    def _index(self, name_or_index):
        if isinstance(name_or_index, str):
            return self.name_to_index[name_or_index]
        return name_or_index

    def transform(self, name_or_index, center=None, axis=None, angle=None):
        i = self._index(name_or_index)
        if center is not None:
            t = np.eye(4)
            t[0:3, 3] = np.asarray(center)
            self._blocks[i][1:5, :] = t
        if axis is not None and angle is not None:
            self._blocks[i][5:9, :] = _rotation_matrix(axis, angle)

    def set_velocity(self, name_or_index, vel):
        self._blocks[self._index(name_or_index)][9, :3] = np.asarray(vel)

    def table(self, device="cuda") -> torch.Tensor:
        if not self._blocks:
            return torch.zeros((0, 10, 4), dtype=torch.float32, device=device)
        return torch.as_tensor(np.stack(self._blocks), dtype=torch.float32, device=device)


def advance_rigid_bodies(rb: torch.Tensor, dt) -> torch.Tensor:
    """Every body's translation advanced by its velocity row, T += v dt
    (JAX ``ops/sdf.py::advance_rigid_bodies``): the per-step motion of
    ``SimConfig.moving_solid``, run inside the step.  ``dt`` is a float or
    a 0-dim tensor; returns a new table."""
    if rb.shape[0] == 0:
        return rb
    out = rb.clone()
    out[:, 1:4, 3] = rb[:, 1:4, 3] + rb[:, 9, 0:3] * dt
    return out


def _decode(rb: torch.Tensor):
    """Split the packed table into (kind, flip, params, t, R, vel)."""
    code = rb[:, 0, 0].to(torch.int32)
    kind = torch.div(code, 2, rounding_mode="floor")
    flip = torch.remainder(code, 2)
    params = rb[:, 0, 1:4]
    t = rb[:, 1:4, 3]
    R = rb[:, 5:8, 0:3]
    vel = rb[:, 9, 0:3]
    return kind, flip, params, t, R, vel


def _norm(v):
    return rounded_sqrt(torch.sum(v * v, dim=-1))


def _rot_cols(v, R):
    """R^T v (apply columns): out_i = sum_j v_j R[j, i]; v (..., 3)."""
    return torch.stack(
        [v[..., 0] * R[0, i] + v[..., 1] * R[1, i] + v[..., 2] * R[2, i] for i in range(3)],
        dim=-1,
    )


def _rot_rows(v, R):
    """R v (apply rows): out_i = sum_j R[i, j] v_j; v (..., 3)."""
    return torch.stack(
        [v[..., 0] * R[i, 0] + v[..., 1] * R[i, 1] + v[..., 2] * R[i, 2] for i in range(3)],
        dim=-1,
    )


def _to_local(points, t, R):
    """p_local = R^T (p - t) for all (point, body) pairs -> (P,B,3)."""
    rel = points[:, None, :] - t[None, :, :]
    return torch.stack(
        [
            rel[..., 0] * R[None, :, 0, i]
            + rel[..., 1] * R[None, :, 1, i]
            + rel[..., 2] * R[None, :, 2, i]
            for i in range(3)
        ],
        dim=-1,
    )


def _sphere_sd(points, t, params):
    rel = points[:, None, :] - t[None, :, :]
    return _norm(rel) - params[None, :, 0]


def _box_sd(p_local, params):
    half = params[None, :, :] * 0.5
    d = torch.abs(p_local) - half
    outside = _norm(torch.clamp(d, min=0.0))
    max_d = torch.amax(d, dim=-1)
    return outside + torch.clamp(max_d, max=0.0)


def _cylinder_sd(p_local, params):
    r = params[None, :, 0]
    hh = params[None, :, 1] * 0.5
    y = p_local[..., 1]
    y_clip = torch.minimum(torch.maximum(y, -hh), hh)
    above_below = torch.abs(y) > hh
    sd_r = rounded_sqrt(p_local[..., 0] ** 2 + p_local[..., 2] ** 2) - r
    dy = torch.abs(y_clip - y)
    inside_sd = torch.maximum(sd_r, torch.maximum(y - hh, -(y + hh)))
    sd_neg = torch.where(above_below, dy, inside_sd)
    sd_pos = torch.where(above_below, rounded_sqrt(sd_r**2 + dy**2), sd_r)
    return torch.where(sd_r < 0, sd_neg, sd_pos)


def eval_per_body(rb: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Signed distance of every point to every body: (P, B)."""
    kind, flip, params, t, R, _ = _decode(rb)
    p_local = _to_local(points, t, R)
    sd = torch.where(
        kind[None, :] == 0,
        _sphere_sd(points, t, params),
        torch.where(kind[None, :] == 1, _box_sd(p_local, params), _cylinder_sd(p_local, params)),
    )
    return torch.where(flip[None, :] == 1, -sd, sd)


def evaluate(rb: torch.Tensor, points: torch.Tensor):
    """min-over-bodies SDF + velocity of the owning body where inside.

    Reference: evaluate_kernel (sdf3D.py:218-242): min_sd seeded at 100;
    velocity written only when min_sd <= 0 (zero elsewhere).
    points: (..., 3) -> sd (...,), vel (..., 3)
    """
    shape = points.shape[:-1]
    pts = points.reshape(-1, 3)
    if rb.shape[0] == 0:
        sd = torch.full((pts.shape[0],), _FAR, dtype=points.dtype, device=points.device)
        return sd.reshape(shape), torch.zeros_like(pts).reshape(*shape, 3)
    bvel = rb[:, 9, 0:3]
    sd_all = eval_per_body(rb, pts)
    min_sd = torch.clamp(torch.amin(sd_all, dim=1), max=_FAR)
    owner = torch.argmin(sd_all, dim=1)
    vel = torch.where((min_sd <= 0)[:, None], bvel[owner], torch.zeros((), dtype=pts.dtype, device=pts.device))
    return min_sd.reshape(shape), vel.reshape(*shape, 3).to(points.dtype)


def _safe_normalize(v, eps=1e-12):
    return v / torch.clamp(_norm(v), min=eps)[..., None]


def _project_sphere(points, t_b, params_b, flip_b):
    rel = points - t_b[None, :]
    sd = _norm(rel) - params_b[0]
    sd = torch.where(flip_b == 1, -sd, sd)
    surf = _safe_normalize(rel) * params_b[0] + t_b[None, :]
    return torch.where((sd < 0)[:, None], surf, points)


def _project_box(points, t_b, R_b, params_b, flip_b):
    rel = points - t_b[None, :]
    p_local = _rot_cols(rel, R_b)
    half = params_b * 0.5
    # flipped container: clamp into the box (the reference's
    # `flipped and ~(in_out)` is truthy for any in_out, sdf3D.py:123)
    clipped = torch.minimum(torch.maximum(p_local, -half), half)
    # non-flipped: if inside, push out through the nearest face, with the
    # reference's tie-break order +x,-x,+y,-y,+z,-z (sdf3D.py:132-141)
    inside = torch.all((p_local <= half) & (p_local >= -half), dim=-1)
    d_hi = half[None, :] - p_local
    d_lo = p_local + half[None, :]
    six = torch.stack(
        [d_hi[:, 0], d_lo[:, 0], d_hi[:, 1], d_lo[:, 1], d_hi[:, 2], d_lo[:, 2]], dim=-1
    )
    idx = torch.argmin(six, dim=-1)
    dist = torch.amin(six, dim=-1)
    axis_i = torch.div(idx, 2, rounding_mode="floor")
    sign = torch.where(idx % 2 == 0, 1.0, -1.0)
    onehot = torch.arange(3, device=points.device)[None, :] == axis_i[:, None]
    pushed = p_local + sign[:, None] * dist[:, None] * onehot
    new_local = torch.where(
        flip_b == 1, clipped, torch.where(inside[:, None], pushed, p_local)
    )
    changed = (flip_b == 1) | inside
    new_world = _rot_rows(new_local, R_b) + t_b[None, :]
    return torch.where(changed[:, None], new_world, points)


def _project_cylinder(points, t_b, R_b, params_b, flip_b):
    rel = points - t_b[None, :]
    p = _rot_cols(rel, R_b)
    r = params_b[0]
    hh = params_b[1] * 0.5
    y = p[:, 1]
    y_clip = torch.minimum(torch.maximum(y, -hh), hh)
    radial = rounded_sqrt(p[:, 0] ** 2 + p[:, 2] ** 2)
    sd_r = radial - r
    at_cap = torch.abs(y) >= hh
    safe_radial = torch.clamp(radial, min=1e-12)
    side_x = p[:, 0] / safe_radial * r
    side_z = p[:, 2] / safe_radial * r
    # flipped: project outside-points onto the cylinder (sdf3D.py:188-199)
    out_flip = at_cap | (sd_r > 0)
    fx = torch.where(out_flip & (sd_r >= 0), side_x, p[:, 0])
    fz = torch.where(out_flip & (sd_r >= 0), side_z, p[:, 2])
    fy = torch.where(out_flip, y_clip, y)
    flipped_new = torch.stack([fx, fy, fz], dim=-1)
    # non-flipped: push inside-points to the nearest of side/top/bottom
    inside = (sd_r < 0) & ~at_cap
    which = torch.argmax(torch.stack([sd_r, y - hh, -(y + hh)], dim=-1), dim=-1)
    nx = torch.where(which == 0, side_x, p[:, 0])
    nz = torch.where(which == 0, side_z, p[:, 2])
    ny = torch.where(which == 1, hh, torch.where(which == 2, -hh, y))
    pushed = torch.stack([nx, ny, nz], dim=-1)
    new_local = torch.where(
        flip_b == 1, flipped_new, torch.where(inside[:, None], pushed, p)
    )
    changed = (flip_b == 1) | inside
    new_world = _rot_rows(new_local, R_b) + t_b[None, :]
    return torch.where(changed[:, None], new_world, points)


def project(rb: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Push points out of every solid, body by body in table order.

    Reference: project_kernel (sdf3D.py:245-260) — each body's projection
    applies to the (possibly already moved) position.
    """
    shape = points.shape
    pts = points.reshape(-1, 3)
    kind, flip, params, t, R, _ = _decode(rb)
    for i in range(rb.shape[0]):
        s = _project_sphere(pts, t[i], params[i], flip[i])
        b = _project_box(pts, t[i], R[i], params[i], flip[i])
        c = _project_cylinder(pts, t[i], R[i], params[i], flip[i])
        pts = torch.where(kind[i] == 0, s, torch.where(kind[i] == 1, b, c))
    return pts.reshape(shape)
