"""Rotated BEV box intersection and IoU as polygon clipping.

The intersection of two rotated rectangles is the first clipped by the
four half-planes of the second (Sutherland-Hodgman), its area by the
shoelace formula. Every pair is clipped at once in float64, in coordinates
centred on the second box, and the result is cast back.

Boxes are (N, 7) [x, y, z, dx, dy, dz, heading].
"""
from __future__ import annotations

import torch

# clipped polygons of two rectangles have at most 8 vertices
_SLOTS = 8
# pairs clipped per pass, to bound the temporaries
_PAIRS = 1 << 20


def _corners(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 4, 2) BEV corners, counter-clockwise."""
    sx = torch.tensor([0.5, -0.5, -0.5, 0.5], dtype=boxes.dtype, device=boxes.device)
    sy = torch.tensor([0.5, 0.5, -0.5, -0.5], dtype=boxes.dtype, device=boxes.device)
    lx, ly = boxes[:, 3:4] * sx, boxes[:, 4:5] * sy
    c, s = torch.cos(boxes[:, 6:7]), torch.sin(boxes[:, 6:7])
    return torch.stack([boxes[:, 0:1] + c * lx - s * ly, boxes[:, 1:2] + s * lx + c * ly], -1)


def _clip(poly: torch.Tensor, n: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Clip polygons poly (M, S, 2) of n (M,) vertices to the left of the
    directed lines a -> b (M, 2): -> (polygons, counts)."""
    m, s, _ = poly.shape
    j = torch.arange(s, device=poly.device)
    live = j[None] < n[:, None]
    nxt = torch.where(j[None] + 1 < n[:, None], j[None] + 1, 0)
    q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    d = (b - a)[:, None]

    def side(p):
        return d[..., 0] * (p[..., 1] - a[:, None, 1]) - d[..., 1] * (p[..., 0] - a[:, None, 0])

    sp, sq = side(poly), side(q)
    inside_p, inside_q = sp >= 0, sq >= 0
    t = (sp / torch.where(sp == sq, 1.0, sp - sq))[..., None]
    cross = poly + t * (q - poly)
    pts = torch.stack([poly, cross], 2).reshape(m, 2 * s, 2)
    keep = torch.stack([live & inside_p, live & (inside_p != inside_q)], 2).reshape(m, 2 * s)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :_SLOTS]
    return torch.gather(pts, 1, order[..., None].expand(-1, -1, 2)), keep.sum(1).clamp_max(_SLOTS)


def _area(poly: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    j = torch.arange(poly.shape[1], device=poly.device)
    nxt = torch.where(j[None] + 1 < n[:, None], j[None] + 1, 0)
    q = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))
    cr = poly[..., 0] * q[..., 1] - poly[..., 1] * q[..., 0]
    return 0.5 * torch.where(j[None] < n[:, None], cr, 0.0).sum(1)


def _pair_overlap(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Corners (M, 4, 2) and (M, 4, 2) of M pairs -> (M,) intersection areas."""
    centre = cb.mean(1, keepdim=True)
    ca, cb = ca - centre, cb - centre
    poly = torch.cat([ca, ca.new_zeros((ca.shape[0], _SLOTS - 4, 2))], 1)
    n = torch.full((ca.shape[0],), 4, dtype=torch.long, device=ca.device)
    for e in range(4):
        poly, n = _clip(poly, n, cb[:, e], cb[:, (e + 1) % 4])
    return torch.where(n >= 3, _area(poly, n), 0.0).clamp_min(0.0)


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor, **_) -> torch.Tensor:
    """(N, M) rotated BEV intersection areas."""
    na, nb = boxes_a.shape[0], boxes_b.shape[0]
    ca, cb = _corners(boxes_a.double()), _corners(boxes_b.double())
    ia = torch.arange(na, device=boxes_a.device).repeat_interleave(nb)
    ib = torch.arange(nb, device=boxes_a.device).repeat(na)
    out = torch.cat([_pair_overlap(ca[ia[s:s + _PAIRS]], cb[ib[s:s + _PAIRS]])
                     for s in range(0, na * nb, _PAIRS)]) if na * nb else ca.new_zeros(0)
    return out.view(na, nb).to(boxes_a.dtype)


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor, **_) -> torch.Tensor:
    """(N, M) rotated BEV IoU."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / (area_a + area_b - inter).clamp_min(1e-7)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor, **_) -> torch.Tensor:
    """(N, M) 3D IoU: the rotated BEV overlap times the overlap of the z
    extents, over the union of the volumes."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    top = torch.minimum((boxes_a[:, 2] + boxes_a[:, 5] / 2)[:, None],
                        (boxes_b[:, 2] + boxes_b[:, 5] / 2)[None, :])
    bottom = torch.maximum((boxes_a[:, 2] - boxes_a[:, 5] / 2)[:, None],
                           (boxes_b[:, 2] - boxes_b[:, 5] / 2)[None, :])
    inter = inter_bev * (top - bottom).clamp_min(0)
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / (vol_a + vol_b - inter).clamp_min(1e-6)
