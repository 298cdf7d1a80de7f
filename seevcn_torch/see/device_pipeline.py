"""The SEE DET path on the device, fixed-shape (port of
seevcn_tpu/see/device_pipeline.py): mask membership -> isolation ->
completion guard -> replacement.

Every tensor keeps the reference's fixed capacity and validity masks. The
reference's ``jnp.nonzero(size=..., fill_value=-1)`` becomes
``nonzero_padded``, which truncates in scan order and pads the same way
without a host synchronisation.
"""
from __future__ import annotations

import math

import torch

from ..ops.chamfer import chamfer_sq
from ..ops.clustering import dbscan, largest_cluster_mask, nearest_core_cluster_mask
from ..ops.sampling import tile_to_n, within_radius_mask


def nonzero_padded(mask: torch.Tensor, size: int) -> torch.Tensor:
    """(P,) bool -> (size,) int64 indices of the first ``size`` True entries
    in index order, padded with -1."""
    pos = torch.cumsum(mask, 0) - 1
    keep = mask & (pos < size)
    tgt = torch.where(keep, pos, size)
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, tgt, torch.arange(mask.shape[0], device=mask.device))
    return out[:size]


def project_points(points: torch.Tensor, proj: torch.Tensor):
    """points (P, 3) x proj (3, 4) -> (u, v, depth) each (P,)."""
    uvw = points @ proj[:, :3].T + proj[:, 3]
    depth = uvw[:, 2]
    safe = torch.where(depth.abs() > 1e-6, depth, 1e-6)
    return uvw[:, 0] / safe, uvw[:, 1] / safe, depth


def _bilinear_patch(patch: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor):
    """Sample (D, mh, mw) patches at fractional (D, P) (fy, fx), zero outside."""
    d, mh, mw = patch.shape
    y0 = torch.floor(fy).long().clamp(0, mh - 1)
    x0 = torch.floor(fx).long().clamp(0, mw - 1)
    y1 = (y0 + 1).clamp(0, mh - 1)
    x1 = (x0 + 1).clamp(0, mw - 1)
    wy = (fy - y0).clamp(0.0, 1.0)
    wx = (fx - x0).clamp(0.0, 1.0)
    flat = patch.reshape(d, mh * mw)

    def at(y, x):
        return torch.gather(flat, 1, y * mw + x)

    v = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y1, x0) * wy * (1 - wx)
         + at(y0, x1) * (1 - wy) * wx + at(y1, x1) * wy * wx)
    inb = (fy >= -0.5) & (fy <= mh - 0.5) & (fx >= -0.5) & (fx <= mw - 0.5)
    return torch.where(inb, v, 0.0)


def _shrink_boxes(boxes: torch.Tensor, shrink_pct: float) -> torch.Tensor:
    s = 1.0 - shrink_pct / 100.0
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    return torch.stack([cx + (boxes[:, 0] - cx) * s, cy + (boxes[:, 1] - cy) * s,
                        cx + (boxes[:, 2] - cx) * s, cy + (boxes[:, 3] - cy) * s],
                       dim=1)


def rasterize_masks(det_boxes: torch.Tensor, det_masks: torch.Tensor,
                    det_scores: torch.Tensor, image_size: tuple,
                    score_thresh: float = 0.5, mask_thresh: float = 0.5,
                    shrink_pct: float = 0.0) -> torch.Tensor:
    """Paste D <= 32 mask patches onto one (H, W) int32 bit canvas: bit d is
    set where instance d's mask covers the pixel (bit 31 is the sign bit).

    The patch -> image resize is A_y @ patch @ A_x^T with per-instance
    bilinear weight matrices (clamp-to-edge), as in the reference.
    ``shrink_pct`` scales each box toward its centre first."""
    h, w = image_size
    d, mh, mw = det_masks.shape
    if d > 32:
        raise ValueError("the bit canvas holds up to 32 instances")
    dev = det_masks.device
    if shrink_pct:
        det_boxes = _shrink_boxes(det_boxes, shrink_pct)
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
    ksy = torch.arange(mh, dtype=torch.float32, device=dev)[None, None, :]
    ksx = torch.arange(mw, dtype=torch.float32, device=dev)[None, None, :]

    x1, y1 = det_boxes[:, 0, None, None], det_boxes[:, 1, None, None]
    bw = (det_boxes[:, 2] - det_boxes[:, 0]).clamp_min(1e-3)[:, None, None]
    bh = (det_boxes[:, 3] - det_boxes[:, 1]).clamp_min(1e-3)[:, None, None]
    fy = (ys + 0.5 - y1) / bh * mh - 0.5                          # (D, H, 1)
    fx = (xs + 0.5 - x1) / bw * mw - 0.5                          # (D, W, 1)
    ay = (1.0 - (fy - ksy).abs()).clamp_min(0.0)                  # (D, H, mh)
    ax = (1.0 - (fx - ksx).abs()).clamp_min(0.0)                  # (D, W, mw)
    # clamp-to-edge at the patch border
    ay[:, :, 0] += (-fy[:, :, 0]).clamp_min(0.0)
    ay[:, :, mh - 1] += (fy[:, :, 0] - (mh - 1)).clamp_min(0.0)
    ax[:, :, 0] += (-fx[:, :, 0]).clamp_min(0.0)
    ax[:, :, mw - 1] += (fx[:, :, 0] - (mw - 1)).clamp_min(0.0)
    inb_y = (fy[:, :, 0] >= -0.5) & (fy[:, :, 0] <= mh - 0.5)    # (D, H)
    inb_x = (fx[:, :, 0] >= -0.5) & (fx[:, :, 0] <= mw - 0.5)    # (D, W)
    val = torch.matmul(torch.matmul(ay, det_masks), ax.transpose(1, 2))
    on = (val >= mask_thresh) & (det_scores >= score_thresh)[:, None, None]
    bits = on & inb_y[:, :, None] & inb_x[:, None, :]             # (D, H, W)
    weights = torch.bitwise_left_shift(
        torch.ones(d, dtype=torch.int32, device=dev),
        torch.arange(d, dtype=torch.int32, device=dev))[:, None, None]
    # bits are disjoint, so the int32 sum is their OR (bit 31 included)
    return (bits.to(torch.int32) * weights).sum(0, dtype=torch.int32)


def _canvas_bits(canvas: torch.Tensor, vi, ui, d: int, ok) -> torch.Tensor:
    bits = canvas[vi, ui]                                         # (P,) int32
    shift = torch.arange(d, dtype=torch.int32, device=canvas.device)[:, None]
    return (((bits[None, :] >> shift) & 1) > 0) & ok[None, :]


def mask_membership(points: torch.Tensor, valid: torch.Tensor,
                    proj: torch.Tensor, det_boxes: torch.Tensor,
                    det_masks: torch.Tensor, det_scores: torch.Tensor,
                    score_thresh: float = 0.5, mask_thresh: float = 0.5,
                    image_size: tuple | None = None, shrink_pct: float = 0.0,
                    core_shrink_pct: float | None = None):
    """(D, P) bool: which in-view points fall inside each detection's mask.

    det_boxes (D, 4) xyxy image coords, det_masks (D, mh, mw) patch
    probabilities, det_scores (D,). With ``image_size`` the masks go onto a
    32-bit canvas and each point reads one pixel at (floor(v), floor(u));
    without it each point samples every patch bilinearly. With
    ``core_shrink_pct`` a second membership at that heavier shrink (the mask
    core) is returned as well: (member, core); the bilinear path has no
    shrink and returns its membership twice."""
    u, v, depth = project_points(points[:, :3], proj)
    in_front = depth > 0.1

    if image_size is not None:
        h, w = image_size
        # floor, not round: the reference indexes mask[int(v), int(u)]
        ui = torch.floor(u).long().clamp(0, w - 1)
        vi = torch.floor(v).long().clamp(0, h - 1)
        in_img = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        ok = in_front & valid & in_img
        d = det_masks.shape[0]
        canvas = rasterize_masks(det_boxes, det_masks, det_scores, image_size,
                                 score_thresh, mask_thresh,
                                 shrink_pct=shrink_pct)
        member = _canvas_bits(canvas, vi, ui, d, ok)
        if core_shrink_pct is None:
            return member
        core_canvas = rasterize_masks(det_boxes, det_masks, det_scores,
                                      image_size, score_thresh, mask_thresh,
                                      shrink_pct=core_shrink_pct)
        return member, _canvas_bits(core_canvas, vi, ui, d, ok)

    x1, y1 = det_boxes[:, 0, None], det_boxes[:, 1, None]
    bw = (det_boxes[:, 2] - det_boxes[:, 0]).clamp_min(1e-3)[:, None]
    bh = (det_boxes[:, 3] - det_boxes[:, 1]).clamp_min(1e-3)[:, None]
    mh, mw = det_masks.shape[1:]
    fx = (u[None] - x1) / bw * mw - 0.5
    fy = (v[None] - y1) / bh * mh - 0.5
    val = _bilinear_patch(det_masks, fy, fx)
    keep = (val >= mask_thresh) & (det_scores >= score_thresh)[:, None]
    member = keep & (in_front & valid)[None, :]
    if core_shrink_pct is not None:
        return member, member
    return member


def isolate_and_resample(points: torch.Tensor, membership: torch.Tensor,
                         eps_scaling: float = 4.0, min_eps: float = 0.3,
                         max_eps: float = 1.0, vres_deg: float = 0.4,
                         min_cluster: int = 10, max_instance_pts: int = 2048,
                         out_pts: int = 1024,
                         core_membership: torch.Tensor | None = None):
    """membership (D, P) -> each instance's chosen DBSCAN cluster tiled to
    ``out_pts``: (D, out_pts, 3) + (D,) validity (cluster > min_cluster).

    Two-stage compaction as in the reference: the points of any mask first
    (capped in scan order), then each instance's first ``max_instance_pts``
    of them. The DBSCAN eps adapts to the instance centroid's range
    (eps_scaling * range * tan(vres), clipped). With ``core_membership`` the
    cluster is picked by ``nearest_core_cluster_mask``, else the largest."""
    d, p = membership.shape
    m = max_instance_pts
    dev = points.device
    cand_cap = min(p, max(2 * d * m, 1 << 12) if d * m < 1 << 16 else 1 << 16)
    cand = nonzero_padded(membership.any(0), cand_cap)
    cvalid = cand >= 0
    csafe = cand.clamp_min(0)
    mem_c = membership[:, csafe] & cvalid[None, :]                # (D, Pc)

    rank = torch.cumsum(mem_c, 1) - 1
    ok = mem_c & (rank < m)
    inst = torch.arange(d, device=dev)[:, None]
    tgt = torch.where(ok, inst * m + rank, d * m)
    src = torch.where(ok, csafe[None, :], -1)
    gathered = torch.full((d * m + 1,), -1, dtype=torch.int64, device=dev)
    gathered = gathered.scatter_reduce(0, tgt.reshape(-1), src.reshape(-1),
                                       "amax")
    idx = gathered[:d * m].reshape(d, m)                          # (D, m)

    iv = idx >= 0
    isafe = idx.clamp_min(0)
    pts = torch.where(iv[..., None], points[isafe, :3], 0.0)      # (D, m, 3)
    centroid = pts.sum(1) / iv.sum(1).clamp_min(1)[:, None]
    rng = torch.linalg.norm(centroid, dim=-1)
    tan_vres = torch.tan(torch.deg2rad(
        torch.tensor(vres_deg, dtype=torch.float32, device=dev)))
    eps = (eps_scaling * rng * tan_vres).clamp(min_eps, max_eps)
    # 8 propagation rounds reach 2^8-hop chains, far beyond a car at eps >= 0.3
    labels = dbscan(pts, eps, min_points=3, valid=iv, n_iters=8)
    if core_membership is None:
        cmask = largest_cluster_mask(labels) & iv
    else:
        core = torch.gather(core_membership, 1, isafe) & iv
        cmask = nearest_core_cluster_mask(labels, core, pts) & iv
    inst_ok = cmask.sum(1) > min_cluster
    out, _ = tile_to_n(pts, cmask, out_pts)
    return out, inst_ok


def completion_sanity_mask(observed: torch.Tensor, completed: torch.Tensor,
                           inst_valid: torch.Tensor,
                           max_dist: float = 2.0) -> torch.Tensor:
    """(D,) bool: False where a completion left its observed instance behind
    (mean nearest-observed distance of the completed surface > ``max_dist``
    metres) or the instance has no observed point.

    observed (D, N, 3) with all-zero rows as padding, completed (D, K, 3)."""
    obs_valid = (observed != 0.0).any(-1)                         # (D, N)
    d1, _ = chamfer_sq(completed, observed, valid2=obs_valid)     # (D, K)
    mean_nn = torch.sqrt(d1.clamp_min(0.0)).mean(-1)
    return inst_valid & obs_valid.any(-1) & (mean_nn <= max_dist)


def replacement_candidates(points: torch.Tensor, valid: torch.Tensor,
                           completed: torch.Tensor, inst_valid: torch.Tensor,
                           r: float, cand_cap: int) -> torch.Tensor:
    """(cand_cap,) indices, -1 padded, of the valid scan points inside some
    valid instance's AABB grown by ``r``: the only points replacement can
    drop. Truncated in scan order."""
    lo = torch.where(inst_valid[:, None], completed.amin(1) - r, math.inf)
    hi = torch.where(inst_valid[:, None], completed.amax(1) + r, -math.inf)
    in_box = ((points[:, None, :3] >= lo[None])
              & (points[:, None, :3] <= hi[None])).all(-1)        # (P, D)
    return nonzero_padded(in_box.any(1) & valid, cand_cap)


def replace_with_completed(points: torch.Tensor, valid: torch.Tensor,
                           completed: torch.Tensor, inst_valid: torch.Tensor,
                           point_dist_thresh: float = 0.1,
                           cand_cap: int = 32768):
    """Splice completed surfaces into the frame cloud, fixed shape.

    points (P, 3), completed (D, K, 3), inst_valid (D,) -> ((P + D*K, 3),
    (P + D*K,) validity): scan points within ``point_dist_thresh`` of a valid
    completed point are dropped and the completed points appended.

    When P > 4 * cand_cap only the scan points inside some instance's
    (AABB + thresh) are tested, at most ``cand_cap`` of them in scan order;
    points past the cap are kept, never wrongly dropped. The test itself is
    ``within_radius_mask``: the pruned min-distance kernel on the card."""
    d, k, _ = completed.shape
    p = points.shape[0]
    flat = completed.reshape(d * k, 3)
    flat_valid = inst_valid.repeat_interleave(k)
    r = point_dist_thresh
    if p > 4 * cand_cap:
        cand = replacement_candidates(points, valid, completed, inst_valid, r,
                                      cand_cap)
        cok = cand >= 0
        # padding rows far from every car, so no box test keeps them
        sub = torch.where(cok[:, None], points[cand.clamp_min(0), :3], 1e9)
        near_sub = within_radius_mask(sub, flat, r, b_valid=flat_valid)
        near = torch.zeros((p + 1,), dtype=torch.bool, device=points.device)
        near[torch.where(cok, cand, p)] = near_sub & cok
        near = near[:p]
    else:
        near = within_radius_mask(points[:, :3], flat, r, b_valid=flat_valid)
    new_pts = torch.cat([points[:, :3], flat], dim=0)
    new_valid = torch.cat([valid & ~near, flat_valid])
    return new_pts, new_valid
