"""3D box geometry in torch (port of the detector's part of
seevcn_tpu/geom/boxes.py).

Box convention (lidar frame): (x, y, z, dx, dy, dz, heading) with (x, y, z)
the box centre and heading about +z increasing x -> y.
"""
from __future__ import annotations

import math

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
