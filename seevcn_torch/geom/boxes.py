"""3D box geometry in torch, and the KITTI camera box conversions in numpy
(port of seevcn_tpu/geom/boxes.py).

Box convention (lidar frame): (x, y, z, dx, dy, dz, heading) with (x, y, z)
the box centre and heading about +z increasing x -> y.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .transforms import limit_period, rotate_points_along_z

# Corner ordering of the reference (box_utils.py:28-53):
#     7 -------- 4
#    /|         /|
#   6 -------- 5 .
#   | |        | |
#   . 3 -------- 0
#   |/         |/
#   2 -------- 1
_CORNER_TEMPLATE = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
                    (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))
# counter-clockwise BEV footprint, for a positive shoelace area
_BEV_TEMPLATE = ((0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5), (0.5, -0.5))


def boxes_to_corners_3d(boxes3d: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 8, 3) box corners in the lidar frame."""
    template = boxes3d.new_tensor(_CORNER_TEMPLATE) / 2
    corners = boxes3d[:, None, 3:6] * template[None]
    corners = rotate_points_along_z(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 4, 2) BEV footprint corners, counter-clockwise."""
    pts = boxes[..., None, 3:5] * boxes.new_tensor(_BEV_TEMPLATE)
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    rot = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)
    return pts @ rot + boxes[..., None, 0:2]


def enlarge_box3d(boxes3d: torch.Tensor, extra_width=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """(N, 7+) boxes with (dx, dy, dz) grown by ``extra_width``."""
    extra = boxes3d.new_tensor(extra_width)
    return torch.cat([boxes3d[:, :3], boxes3d[:, 3:6] + extra[None],
                      boxes3d[:, 6:]], dim=1)


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Rotated-box containment, (N, 3+) points x (M, 7) boxes -> (M, N) bool:
    each point rotated by the box's -heading into its frame, inside where
    |local| <= half the size on every axis (z from zc - dz/2 to zc + dz/2)."""
    rel = points[None, :, :3] - boxes[:, None, :3]               # (M, N, 3)
    local = rotate_points_along_z(rel, -boxes[:, 6])
    return (local.abs() <= boxes[:, None, 3:6] / 2).all(-1)


def points_in_boxes_count(points: torch.Tensor, boxes: torch.Tensor,
                          point_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(M,) number of (valid) points inside each box."""
    inside = points_in_boxes(points, boxes)
    if point_mask is not None:
        inside = inside & point_mask[None, :]
    return inside.sum(1)


def boxes3d_to_aligned_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """Snap each rotated box to its nearest axis-aligned BEV box (N, 4)."""
    rot = limit_period(boxes3d[:, 6], offset=0.5, period=math.pi).abs()
    swap = rot[:, None] >= math.pi / 4
    dims = torch.where(swap, boxes3d[:, [4, 3]], boxes3d[:, [3, 4]])
    return torch.cat([boxes3d[:, 0:2] - dims / 2, boxes3d[:, 0:2] + dims / 2],
                     dim=1)


def boxes_iou_normal(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU, (N, 4) x (M, 4) -> (N, M)."""
    x_min = torch.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0])
    x_max = torch.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2])
    y_min = torch.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    y_max = torch.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3])
    inter = (x_max - x_min).clamp_min(0) * (y_max - y_min).clamp_min(0)
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp_min(1e-6)


def boxes3d_nearest_bev_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 7) x (M, 7) -> (N, M) IoU of the nearest axis-aligned BEV boxes,
    the anchor assigner's measure when MATCH_HEIGHT is off."""
    return boxes_iou_normal(boxes3d_to_aligned_bev(boxes_a),
                            boxes3d_to_aligned_bev(boxes_b))


def mask_boxes_outside_range(boxes: torch.Tensor, limit_range,
                             min_num_corners: int = 1) -> torch.Tensor:
    """(N, 7+) boxes and [x0 y0 z0 x1 y1 z1] -> (N,) bool: at least
    ``min_num_corners`` of a box's 8 corners inside the range."""
    lr = boxes.new_tensor(limit_range)
    corners = boxes_to_corners_3d(boxes[:, :7])
    inside = ((corners >= lr[0:3]) & (corners <= lr[3:6])).all(2)
    return inside.sum(1) >= min_num_corners


# ---------------------------------------------------------------------------
# KITTI camera <-> lidar box conversions, host-side numpy (reference
# box_utils.py:129-283). A KITTI camera box is (x, y, z, l, h, w, ry), (x, y,
# z) the bottom face's centre in rect coordinates.
# ---------------------------------------------------------------------------

def boxes3d_lidar_to_kitti_camera(boxes3d_lidar: np.ndarray, calib) -> np.ndarray:
    """(N, 7) lidar boxes -> (N, 7) camera boxes (f64), ``calib`` a
    ``geom.calibration.KittiCalibration``."""
    b = np.array(boxes3d_lidar, dtype=np.float64, copy=True)
    xyz, l, w, h, r = b[:, 0:3], b[:, 3:4], b[:, 4:5], b[:, 5:6], b[:, 6:7]
    xyz[:, 2] -= h[:, 0] / 2                       # centre -> bottom
    xyz_cam = calib.lidar_to_rect(xyz)
    r = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r], axis=-1)


def boxes3d_kitti_camera_to_lidar(boxes3d_camera: np.ndarray, calib) -> np.ndarray:
    """(N, 7) camera boxes -> (N, 7) lidar boxes (f64)."""
    b = np.array(boxes3d_camera, dtype=np.float64, copy=True)
    xyz_cam, r = b[:, 0:3], b[:, 6:7]
    l, h, w = b[:, 3:4], b[:, 4:5], b[:, 5:6]
    xyz = calib.rect_to_lidar(xyz_cam)
    xyz[:, 2] += h[:, 0] / 2                       # bottom -> centre
    return np.concatenate([xyz, l, w, h, -(r + np.pi / 2)], axis=-1)


def boxes3d_to_corners3d_kitti_camera(boxes3d: np.ndarray,
                                      bottom_center: bool = True) -> np.ndarray:
    """(N, 7) camera boxes -> (N, 8, 3) corners in rect coordinates (f32)."""
    n = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2], axis=1)
    z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], axis=1)
    if bottom_center:
        y_c = np.zeros((n, 8), dtype=boxes3d.dtype)
        y_c[:, 4:8] = -h[:, None]
    else:
        y_c = np.stack([h / 2] * 4 + [-h / 2] * 4, axis=1)
    ry = boxes3d[:, 6]
    zeros, ones = np.zeros_like(ry), np.ones_like(ry)
    rot = np.stack([
        np.stack([np.cos(ry), zeros, -np.sin(ry)], 1),
        np.stack([zeros, ones, zeros], 1),
        np.stack([np.sin(ry), zeros, np.cos(ry)], 1)], axis=1)  # (N, 3, 3)
    corners = np.stack([x_c, y_c, z_c], axis=2) @ rot
    return (corners + boxes3d[:, None, 0:3]).astype(np.float32)


def boxes3d_kitti_camera_to_imageboxes(boxes3d: np.ndarray, calib,
                                       image_shape=None) -> np.ndarray:
    """(N, 7) camera boxes -> (N, 4) image boxes [x1 y1 x2 y2], the
    projected corners' extent, clipped to ``image_shape`` (H, W) if given."""
    corners3d = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners3d.reshape(-1, 3))
    uv = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([uv.min(axis=1), uv.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, [0, 2]] = np.clip(boxes2d[:, [0, 2]], 0, image_shape[1] - 1)
        boxes2d[:, [1, 3]] = np.clip(boxes2d[:, [1, 3]], 0, image_shape[0] - 1)
    return boxes2d
