"""Analytic rigid-body signed-distance fields (2D): evaluate & project.

Counterpart of ``python_fluid_simulation_tpu.ops.sdf2d`` (the
reference's ``solver/sdf2D.py``): circle ("sphere") and box primitives
with 3x3 rigid transforms.  The table encoding is the reference's
(sdf2D.py:221-252):

  rb: (B, 8, 3) float32
    row 0    : [type, p0, p1]  (0/1 sphere(+flip) radius; 2/3 box w,h)
    rows 1:4 : 3x3 translation matrix
    rows 4:7 : 3x3 rotation matrix
    row 7    : [vx, vy, 0] body velocity

As in ``ops/sdf.py``, every primitive is evaluated for every body and the
results combined with ``torch.where`` on the body's type code, so the
table stays on the device without a host read of its types.

Reference quirk preserved: the projection onto a flipped circle pins a
particle exactly at its center to (cx + r, cy) (sdf2D.py:71-75).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops.indexing import rounded_sqrt

_FAR = 100.0  # min-distance searches start at 100, as in 3D

_TYPE_CODES = {"sphere": 0, "box": 2}


def make_body_2d(
    kind: str,
    params: Sequence[float],
    flip: bool = False,
    center: Sequence[float] = (0.0, 0.0),
    angle: float = 0.0,
    velocity: Sequence[float] = (0.0, 0.0),
) -> np.ndarray:
    """One (8, 3) rigid-body block (sdf2D.py:221-252)."""
    if kind not in _TYPE_CODES:
        raise ValueError(f"unknown 2D rigid body kind {kind!r}")
    rb = np.zeros((8, 3), dtype=np.float32)
    rb[0, 0] = _TYPE_CODES[kind] + (1 if flip else 0)
    p = list(params)
    rb[0, 1 : 1 + len(p)] = p
    t = np.eye(3)
    t[0:2, 2] = np.asarray(center)
    rb[1:4, :] = t
    r = np.eye(3)
    if angle:
        th = math.radians(angle)
        r[:2, :2] = [[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]]
    rb[4:7, :] = r
    rb[7, :2] = np.asarray(velocity)
    return rb


class RigidBodySet2D:
    """Named collection of 2D rigid bodies -> one (B, 8, 3) table."""

    def __init__(self):
        self._blocks: List[np.ndarray] = []
        self.name_to_index: Dict[str, int] = {}

    def add(self, name: str, kind: str, params, **kw) -> int:
        idx = len(self._blocks)
        self._blocks.append(make_body_2d(kind, params, **kw))
        self.name_to_index[name] = idx
        return idx

    def set_velocity(self, name_or_index, vel):
        i = self.name_to_index[name_or_index] if isinstance(name_or_index, str) else name_or_index
        self._blocks[i][7, :2] = np.asarray(vel)

    def table(self, device="cuda") -> torch.Tensor:
        if not self._blocks:
            return torch.zeros((0, 8, 3), dtype=torch.float32, device=device)
        return torch.as_tensor(np.stack(self._blocks), dtype=torch.float32, device=device)


def _decode(rb: torch.Tensor):
    """Split the packed table into (kind, flip, params, t, R, vel)."""
    code = rb[:, 0, 0].to(torch.int32)
    kind = torch.div(code, 2, rounding_mode="floor")
    flip = torch.remainder(code, 2)
    return kind, flip, rb[:, 0, 1:3], rb[:, 1:3, 2], rb[:, 4:6, 0:2], rb[:, 7, 0:2]


def _norm(v):
    return rounded_sqrt(torch.sum(v * v, dim=-1))


def eval_per_body_2d(rb: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Signed distance of every point to every body: (P, B)."""
    kind, flip, params, t, R, _ = _decode(rb)
    rel = points[:, None, :] - t[None, :, :]
    # p_local = R^T rel
    p_local = torch.stack([rel[..., 0] * R[None, :, 0, i] + rel[..., 1] * R[None, :, 1, i] for i in range(2)], dim=-1)
    sd_sphere = _norm(rel) - params[None, :, 0]
    dbox = torch.abs(p_local) - params[None, :, :] * 0.5
    sd_box = _norm(torch.clamp(dbox, min=0.0)) + torch.clamp(torch.amax(dbox, dim=-1), max=0.0)
    sd = torch.where(kind[None, :] == 0, sd_sphere, sd_box)
    return torch.where(flip[None, :] == 1, -sd, sd)


def evaluate_2d(rb: torch.Tensor, points: torch.Tensor):
    """min-over-bodies SDF + velocity of the owning body where inside
    (sdf2D.evaluate_kernel): points (..., 2) -> sd (...,), vel (..., 2)."""
    shape = points.shape[:-1]
    pts = points.reshape(-1, 2)
    if rb.shape[0] == 0:
        sd = torch.full((pts.shape[0],), _FAR, dtype=points.dtype, device=points.device)
        return sd.reshape(shape), torch.zeros_like(pts).reshape(*shape, 2)
    sd_all = eval_per_body_2d(rb, pts)
    min_sd = torch.clamp(torch.amin(sd_all, dim=1), max=_FAR)
    owner = torch.argmin(sd_all, dim=1)
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    vel = torch.where((min_sd <= 0)[:, None], rb[:, 7, 0:2][owner], zero)
    return min_sd.reshape(shape), vel.reshape(*shape, 2).to(points.dtype)


def _project_sphere_2d(points, t_b, params_b, flip_b):
    rel = points - t_b[None, :]
    dist = _norm(rel)
    at_center = dist <= 1e-4  # a flipped circle pins its center to (cx + r, cy) (:71-75)
    r = params_b[0]
    surf = rel / torch.clamp(dist, min=1e-12)[:, None] * r + t_b[None, :]
    pinned = torch.stack([(t_b[0] + r).expand(points.shape[0]), t_b[1].expand(points.shape[0])], dim=-1)
    sd = dist - r
    sd = torch.where(flip_b == 1, -sd, sd)
    return torch.where(at_center[:, None], torch.where(flip_b == 1, pinned, points),
                       torch.where((sd < 0)[:, None], surf, points))


def _project_box_2d(points, t_b, R_b, params_b, flip_b):
    rel = points - t_b[None, :]
    p = torch.stack([rel[:, 0] * R_b[0, j] + rel[:, 1] * R_b[1, j] for j in range(2)], dim=-1)
    half = params_b * 0.5
    clipped = torch.minimum(torch.maximum(p, -half), half)
    inside = torch.all((p <= half) & (p >= -half), dim=-1)
    d_hi = half[None, :] - p
    d_lo = p + half[None, :]
    four = torch.stack([d_hi[:, 0], d_lo[:, 0], d_hi[:, 1], d_lo[:, 1]], dim=-1)
    idx = torch.argmin(four, dim=-1)
    dist = torch.amin(four, dim=-1)
    axis_i = torch.div(idx, 2, rounding_mode="floor")
    sign = torch.where(idx % 2 == 0, 1.0, -1.0)
    onehot = torch.arange(2, device=points.device)[None, :] == axis_i[:, None]
    pushed = p + sign[:, None] * dist[:, None] * onehot
    new_local = torch.where(flip_b == 1, clipped, torch.where(inside[:, None], pushed, p))
    changed = (flip_b == 1) | inside
    new_world = torch.stack([new_local[:, 0] * R_b[i, 0] + new_local[:, 1] * R_b[i, 1] for i in range(2)],
                            dim=-1) + t_b[None, :]
    return torch.where(changed[:, None], new_world, points)


def project_2d(rb: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Push points out of every solid, body by body in table order (each
    body's projection applies to the already moved position)."""
    shape = points.shape
    pts = points.reshape(-1, 2)
    kind, flip, params, t, R, _ = _decode(rb)
    for i in range(rb.shape[0]):
        s = _project_sphere_2d(pts, t[i], params[i], flip[i])
        b = _project_box_2d(pts, t[i], R[i], params[i], flip[i])
        pts = torch.where(kind[i] == 0, s, b)
    return pts.reshape(shape)
