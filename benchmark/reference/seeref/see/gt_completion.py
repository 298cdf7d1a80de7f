"""SEE's completion of the source domain (SEE-VCN's GT path), as its
definition: for each valid GT box of a frame, the frame's valid points
inside the box lifted 0.05 m and 0.1 m shorter; the first 2,048 of them in
scan order (taken from the first points of any box, as many as the
program's candidate cap admits); their largest DBSCAN cluster (3 points,
eps 4 * range * tan(0.4 deg) of the instance's centroid, within [0.3, 1.0]
m), tiled to the VCN's count, valid with more than 10 points; VCN_CN with
the box (its sizes at least 0.1 m) and the completion step
(``VCNInference``); a completion is sane where the mean distance of its
points to the nearest observed point is at most ``sanity_max_dist`` m;
then every scan point within 0.1 m of a point of a valid completion is
dropped, and every completion's points appended, valid with their
instance. Geometry runs in float64."""
from __future__ import annotations

import math

import torch

from .. import resolve_device, tf32_off
from ..ops.neighbours import dbscan, largest_cluster, sqdist, tile

MAX_INSTANCE_PTS = 2048
REPLACE_M = 0.1


def in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(P, 3), (D, 7) -> (D, P): the point lies in the box, faces included."""
    rel = points.double()[None] - boxes.double()[:, None, :3]
    c, s = torch.cos(boxes[:, 6].double())[:, None], torch.sin(boxes[:, 6].double())[:, None]
    local = torch.stack([c * rel[..., 0] + s * rel[..., 1], -s * rel[..., 0] + c * rel[..., 1],
                         rel[..., 2]], -1)
    return (local.abs() <= boxes.double()[:, None, 3:6] / 2).all(-1)


def isolate(points, member, n: int):
    """points (P, 3), member (D, P) -> ((D, n, 3) instances, (D,) ok)."""
    d, p = member.shape
    m = MAX_INSTANCE_PTS
    cap = min(p, max(2 * d * m, 1 << 12) if d * m < 1 << 16 else 1 << 16)
    anyone = member.any(0)
    member = member & anyone & (torch.cumsum(anyone.long(), 0) <= cap)
    out, ok = [], []
    for row in member:
        idx = torch.nonzero(row)[:, 0][:m]
        pts = points[idx, :3]
        if idx.numel() == 0:
            out.append(points.new_zeros((n, 3)))
            ok.append(False)
            continue
        rng = float(pts.double().mean(0).norm())
        eps = min(max(4.0 * rng * math.tan(math.radians(0.4)), 0.3), 1.0)
        keep = largest_cluster(dbscan(pts, eps, 3))
        out.append(tile(pts, keep, n))
        ok.append(int(keep.sum()) > 10)
    return torch.stack(out), torch.tensor(ok, device=points.device)


def sane(observed, completed, max_dist: float) -> torch.Tensor:
    """(D, n, 3) instances, (D, K, 3) completions -> (D,): the completion's
    mean distance to the instance's nearest point (rows not all zero) is at
    most max_dist."""
    out = []
    for obs, comp in zip(observed, completed):
        real = obs[(obs != 0).any(-1)]
        out.append(real.shape[0] > 0 and
                   float(sqdist(comp, real).amin(1).sqrt().mean()) <= max_dist)
    return torch.tensor(out, device=observed.device)


def replace(points, valid, completed, inst_valid):
    """-> ((P + D*K, 3), validity): the scan without its points within 0.1 m
    of a valid completion's point, then every completion's points."""
    flat = completed.reshape(-1, 3)
    flat_valid = inst_valid.repeat_interleave(completed.shape[1])
    near = torch.zeros_like(valid)
    src = flat[flat_valid]
    for s in range(0, points.shape[0], 4096):
        if src.shape[0]:
            near[s:s + 4096] = sqdist(points[s:s + 4096, :3], src).amin(1) <= REPLACE_M ** 2
    return torch.cat([points[:, :3], flat]), torch.cat([valid & ~near, flat_valid])


@torch.no_grad()
def complete_gt_frames(vcn, points, valid, gt_boxes, gt_mask, *, device="cuda",
                       sanity_max_dist: float = 2.0, vcn_boxes: bool = False):
    """points (F, P, 3), valid (F, P), gt_boxes (F, D, >=7), gt_mask (F, D)
    -> (new_pts (F, P + D*n, 3), new_valid, stats with ``ok``, ``sane`` and
    ``inst_valid`` (F, D))."""
    dev = resolve_device(device)
    tf32_off()
    points, valid, gt_boxes, gt_mask = (t.to(dev) for t in (points, valid, gt_boxes, gt_mask))
    f, d = gt_mask.shape
    lift = gt_boxes.new_tensor([0, 0, 0.05, 0, 0, -0.1, 0])
    iso, ok = [], []
    for i in range(f):
        member = in_boxes(points[i], gt_boxes[i, :, :7] + lift) & gt_mask[i][:, None] & valid[i]
        a, b = isolate(points[i], member, vcn.num_points)
        iso.append(a)
        ok.append(b)
    iso, ok = torch.stack(iso), torch.stack(ok)
    boxes = None
    if vcn_boxes:
        boxes = gt_boxes[..., :7].reshape(f * d, 7).clone()
        boxes[:, 3:6] = boxes[:, 3:6].clamp_min(0.1)
    completed = vcn(iso.reshape(f * d, -1, 3), boxes)[3]
    ok_sane = sane(iso.reshape(f * d, -1, 3), completed, sanity_max_dist).view(f, d)
    completed = completed.view(f, d, -1, 3)
    inst_valid = ok & ok_sane
    out = [replace(points[i], valid[i], completed[i], inst_valid[i]) for i in range(f)]
    stats = {"isolated": iso, "completed": completed, "ok": ok, "sane": ok_sane,
             "inst_valid": inst_valid}
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]), stats
