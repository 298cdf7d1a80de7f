"""Pointcloud / pose transforms in torch (port of seevcn_tpu/geom/transforms.py).

Angle convention: heading is measured about +z, increasing x -> y.
``rotate_points_along_z(p, a)`` rotates points *by* ``a`` (canonical ->
view-centric); use ``-a`` for view-centric -> canonical. Points are row
vectors: ``p_rot = p @ rot_z(a)``.
"""
from __future__ import annotations

import numpy as np
import torch


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """(...,) heading -> (..., 3, 3) rotation about z for row-vector points."""
    c, s = torch.cos(angle), torch.sin(angle)
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    return torch.stack([c, s, z, -s, c, z, z, z, o],
                       dim=-1).reshape(*angle.shape, 3, 3)


def rotate_points_along_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 3+C) points by (...,) angle about z; extra channels
    pass through unchanged."""
    xyz = torch.matmul(points[..., :3], rot_z(angle))
    return torch.cat([xyz, points[..., 3:]], dim=-1)


def vc_to_cn(points: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Sensor (view-centric) -> canonical object frame. points (B, N, 3),
    gt_boxes (B, 7) [x y z dx dy dz heading]."""
    return rotate_points_along_z(points - gt_boxes[:, None, :3],
                                 -gt_boxes[:, -1])


def cn_to_vc(points: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Canonical object frame -> sensor frame."""
    return rotate_points_along_z(points, gt_boxes[:, -1]) + gt_boxes[:, None, :3]


def normalize_scale(points: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Scale-normalise canonical points by box length (gt dx)."""
    return points / gt_boxes[:, 3].reshape(-1, 1, 1)


def restore_scale(points: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    return points * gt_boxes[:, 3].reshape(-1, 1, 1)


def rotation_matrix_from_ortho6d(ortho6d: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation (Zhou et al. 2019) -> (B, 3, 3), columns x, y, z."""
    x_raw, y_raw = ortho6d[:, 0:3], ortho6d[:, 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=1, keepdim=True).clamp_min(1e-8)
    z = torch.linalg.cross(x, y_raw, dim=1)
    z = z / torch.linalg.norm(z, dim=1, keepdim=True).clamp_min(1e-8)
    y = torch.linalg.cross(z, x, dim=1)
    return torch.stack([x, y, z], dim=-1)


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = torch.pi) -> torch.Tensor:
    """Wrap val into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z_np(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """numpy form of rotate_points_along_z for the host-side data
    transforms: points (B, N, 3), angle (B,)."""
    c, s = np.cos(angle), np.sin(angle)
    out = points.copy()
    x, y = points[..., 0], points[..., 1]
    out[..., 0] = x * c[:, None] - y * s[:, None]
    out[..., 1] = x * s[:, None] + y * c[:, None]
    return out


def vc_to_cn_rt(points: torch.Tensor, rot: torch.Tensor,
                trans: torch.Tensor) -> torch.Tensor:
    """VC -> CN with an explicit (B, 3, 3) rotation and (B, [1,] 3)
    translation."""
    if trans.dim() == 2:
        trans = trans[:, None, :]
    return (points - trans) @ rot.transpose(-1, -2)


def cn_to_vc_rt(points: torch.Tensor, rot: torch.Tensor,
                trans: torch.Tensor) -> torch.Tensor:
    if trans.dim() == 2:
        trans = trans[:, None, :]
    return points @ rot + trans


def heading_from_rotm(rot: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) rotation -> heading about z in [-pi, pi]: the angle of
    e_x @ R."""
    v = rot[:, 0, :]
    return torch.atan2(v[:, 1], v[:, 0])


def geodesic_distance(r1: torch.Tensor, r2: torch.Tensor,
                      eps: float = 1e-7) -> torch.Tensor:
    """Angle of the relative rotation between two (B, 3, 3) matrices, the
    cosine clipped to [-1 + eps, 1 - eps]."""
    m = r1 @ r2.transpose(-1, -2)
    cos = (m.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0 + eps, 1.0 - eps))
