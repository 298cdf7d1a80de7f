"""Rotated BEV box intersection and IoU (port of seevcn_tpu/ops/iou3d.py).

The reference's sort-free formulation: the shoelace integral of a convex
intersection A∩B splits over its oriented boundary, the pieces of A's edges
inside B plus the pieces of B's edges inside A. Each piece comes from
clipping a parametric edge against the other box's 4 half-planes, and its
contribution cross(start, end)/2 does not depend on order, so the whole
computation is elementwise over (N, M) pairs. Shared boundaries are counted
once by shrinking the half-planes of the second pass by a small epsilon.

Boxes are (N, 7) [x, y, z, dx, dy, dz, heading].
"""
from __future__ import annotations

import torch

from ..geom.boxes import corners_bev

_EPS = 1e-5  # f32 tolerance for boundary tests (coordinates are pre-centred)


def _edges_in_poly_area(p: torch.Tensor, q: torch.Tensor, shrink: float) -> torch.Tensor:
    """Signed shoelace contribution of p's edges clipped to the convex
    counter-clockwise quads q: p, q (..., 4, 2) -> (...)."""
    dp = torch.roll(p, -1, dims=-2) - p                  # (..., 4, 2) edges of p
    e = (torch.roll(q, -1, dims=-2) - q)[..., None, :, :]  # (..., 1, 4, 2) clip edges
    rel = p[..., :, None, :] - q[..., None, :, :]        # (..., 4, 4, 2)
    # f(t) = a + t*b >= 0  <=>  the point at t is inside the clip half-plane
    a = e[..., 0] * rel[..., 1] - e[..., 1] * rel[..., 0] - shrink
    b = e[..., 0] * dp[..., :, None, 1] - e[..., 1] * dp[..., :, None, 0]
    ratio = -a / torch.where(b.abs() < _EPS, 1.0, b)
    lo = torch.where(b > _EPS, ratio, 0.0)
    hi = torch.where(b < -_EPS, ratio, 1.0)
    empty = (b.abs() <= _EPS) & (a < -_EPS)          # parallel and outside
    t0 = lo.amax(-1).clamp_min(0.0)
    t1 = hi.amin(-1).clamp_max(1.0)
    valid = (t1 > t0) & ~empty.any(-1)
    x0 = p + t0[..., None] * dp
    x1 = p + t1[..., None] * dp
    contrib = 0.5 * (x0[..., 0] * x1[..., 1] - x0[..., 1] * x1[..., 0])
    return torch.where(valid, contrib, 0.0).sum(-1)


def _overlap_matrix(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(N, 4, 2) x (M, 4, 2) corners -> (N, M) intersection areas, each pair
    in coordinates centred on the first box (f32 cancellation at 75 m is
    larger than any usable epsilon)."""
    offset = ca.mean(1, keepdim=True)                    # (N, 1, 2)
    pa = (ca - offset)[:, None].expand(-1, cb.shape[0], -1, -1)
    pb = cb[None] - offset[:, None]                      # (N, M, 4, 2)
    area = _edges_in_poly_area(pa, pb, 0.0) + _edges_in_poly_area(pb, pa, 4 * _EPS)
    return area.clamp_min(0.0)


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                      row_chunk: int | None = None) -> torch.Tensor:
    """(N, M) rotated BEV intersection areas; ``row_chunk`` bounds the
    (rows, M, 4, 4) temporaries."""
    ca, cb = corners_bev(boxes_a), corners_bev(boxes_b)
    if row_chunk is None or ca.shape[0] <= row_chunk:
        return _overlap_matrix(ca, cb)
    return torch.cat([_overlap_matrix(ca[s:s + row_chunk], cb)
                      for s in range(0, ca.shape[0], row_chunk)])


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                  row_chunk: int | None = None) -> torch.Tensor:
    """(N, M) rotated BEV IoU."""
    inter = boxes_overlap_bev(boxes_a, boxes_b, row_chunk=row_chunk)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / (area_a + area_b - inter).clamp_min(1e-7)
