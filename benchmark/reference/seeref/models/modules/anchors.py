"""Anchors and their targets: OpenPCDet's anchor generator
(anchor_generator.py), its axis-aligned target assigner
(axis_aligned_target_assigner.py) written from its definition, and the
direction bins (anchor_head_template.py)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ...geom.transforms import limit_period
from ...ops.iou3d import boxes_iou3d


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range,
                     anchor_ndim: int = 7):
    """Host-side (numpy): returns (anchors (A, anchor_ndim) float32,
    num_anchors_per_location list). Multi-class anchors are concatenated on
    the per-location 'size' axis, matching the reference cat(dim=-3)."""
    pcr = np.asarray(point_cloud_range, dtype=np.float64)
    per_class = []
    num_per_loc = []
    for cfg in anchor_generator_cfg:
        stride = int(cfg["feature_map_stride"])
        gx, gy = int(grid_size[0]) // stride, int(grid_size[1]) // stride
        sizes = np.asarray(cfg["anchor_sizes"], dtype=np.float64)       # (S, 3)
        rots = np.asarray(cfg["anchor_rotations"], dtype=np.float64)    # (R,)
        heights = np.asarray(cfg["anchor_bottom_heights"], dtype=np.float64)  # (Z,)
        align = bool(cfg.get("align_center", False))
        num_per_loc.append(len(sizes) * len(rots) * len(heights))

        if align:
            xs = (pcr[3] - pcr[0]) / gx
            ys = (pcr[4] - pcr[1]) / gy
            xo, yo = xs / 2, ys / 2
        else:
            xs = (pcr[3] - pcr[0]) / (gx - 1)
            ys = (pcr[4] - pcr[1]) / (gy - 1)
            xo = yo = 0.0
        x_shifts = np.arange(pcr[0] + xo, pcr[3] + 1e-5, xs)
        y_shifts = np.arange(pcr[1] + yo, pcr[4] + 1e-5, ys)

        X, Y, Z = np.meshgrid(x_shifts, y_shifts, heights, indexing="ij")  # (gx, gy, gz)
        cent = np.stack([X, Y, Z], axis=-1)                                 # (gx, gy, gz, 3)
        a = np.broadcast_to(cent[:, :, :, None, None, :],
                            (*cent.shape[:3], len(sizes), len(rots), 3))
        s = np.broadcast_to(sizes[None, None, None, :, None, :], a.shape)
        r = np.broadcast_to(rots[None, None, None, None, :, None],
                            (*a.shape[:-1], 1))
        anchors = np.concatenate([a, s, r], axis=-1)        # (gx, gy, gz, S, R, 7)
        anchors = anchors.transpose(2, 1, 0, 3, 4, 5)       # (gz, gy, gx, S, R, 7)
        anchors[..., 2] += anchors[..., 5] / 2              # bottom -> center z
        per_class.append(anchors)

    cat = np.concatenate(per_class, axis=3)                  # stack classes on size axis
    flat = cat.reshape(-1, 7).astype(np.float32)
    if anchor_ndim != 7:
        flat = np.concatenate(
            [flat, np.zeros((len(flat), anchor_ndim - 7), np.float32)], axis=1)
    return flat, num_per_loc


class AxisAlignedTargetAssigner:
    """OpenPCDet's AxisAlignedTargetAssigner, per anchor class, thresholds
    from the anchor generator config."""

    def __init__(self, anchor_generator_cfg, class_names, box_coder,
                 match_height: bool = False):
        self.box_coder = box_coder
        self.match_height = match_height
        names = [c["class_name"] for c in anchor_generator_cfg]
        # 1-based class id (the last column of gt_boxes) of each anchor class
        self.class_ids = [list(class_names).index(n) + 1 for n in names]
        self.matched = [float(c["matched_threshold"]) for c in anchor_generator_cfg]
        self.unmatched = [float(c["unmatched_threshold"]) for c in anchor_generator_cfg]

    def assign(self, anchors_per_class, gt_boxes: torch.Tensor) -> dict:
        """anchors_per_class: one (locations, per-location, ndim) tensor a
        class; gt_boxes (B, M, 8) [box, class id], zero rows padding. ->
        box_cls_labels (B, A) int32, box_reg_targets (B, A, code),
        reg_weights (B, A), the classes interleaved per location."""
        labels, targets, weights = [], [], []
        for gt in gt_boxes:
            real = gt[gt.abs().sum(1) > 0]
            per = []
            for a, cid, mt, ut in zip(anchors_per_class, self.class_ids, self.matched,
                                      self.unmatched):
                flat = a.reshape(-1, a.shape[-1])
                lab, tgt = assign_single(flat, real[real[:, -1].long() == cid],
                                         mt, ut, self.box_coder, self.match_height)
                per.append((lab.view(a.shape[0], -1), tgt.view(a.shape[0], a.shape[1], -1)))
            lab = torch.cat([p[0] for p in per], 1).reshape(-1)
            labels.append(lab)
            targets.append(torch.cat([p[1] for p in per], 1).reshape(lab.shape[0], -1))
            weights.append((lab > 0).float())
        return {"box_cls_labels": torch.stack(labels),
                "box_reg_targets": torch.stack(targets),
                "reg_weights": torch.stack(weights)}


def aligned_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 7) -> (N, 4) [x1, y1, x2, y2]: each box turned to the nearer axis
    (its dims swapped where |heading| mod pi is pi/4 or more)."""
    rot = limit_period(boxes[:, 6], 0.5, math.pi).abs()
    dims = torch.where((rot < math.pi / 4)[:, None], boxes[:, [3, 4]], boxes[:, [4, 3]])
    return torch.cat([boxes[:, 0:2] - dims / 2, boxes[:, 0:2] + dims / 2], 1)


def nearest_bev_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) IoU of the axis-aligned BEV rectangles of ``aligned_bev``."""
    ra, rb = aligned_bev(a), aligned_bev(b)
    w = (torch.minimum(ra[:, None, 2], rb[None, :, 2])
         - torch.maximum(ra[:, None, 0], rb[None, :, 0])).clamp_min(0)
    h = (torch.minimum(ra[:, None, 3], rb[None, :, 3])
         - torch.maximum(ra[:, None, 1], rb[None, :, 1])).clamp_min(0)
    inter = w * h
    area_a = ((ra[:, 2] - ra[:, 0]) * (ra[:, 3] - ra[:, 1]))[:, None]
    area_b = ((rb[:, 2] - rb[:, 0]) * (rb[:, 3] - rb[:, 1]))[None, :]
    return inter / (area_a + area_b - inter).clamp_min(1e-6)


def assign_single(anchors, gt, matched_thr, unmatched_thr, coder, match_height):
    """One frame, one anchor class, gt (M, 8) that class's boxes ->
    labels (A,) (-1 ignored, 0 background, else the class id) and box
    targets (A, code). An anchor whose IoU reaches matched_thr takes its
    best box; each box's best anchors (every anchor at its highest IoU, if
    above 0) are foreground whatever their IoU; below unmatched_thr the
    rest are background. A foreground anchor regresses to its own best box
    (the first at a tie)."""
    n = anchors.shape[0]
    labels = torch.full((n,), -1, dtype=torch.int32, device=anchors.device)
    targets = anchors.new_zeros((n, coder.code_size))
    if gt.shape[0] == 0:
        return torch.zeros_like(labels), targets
    a = anchors[:, :7]
    iou = boxes_iou3d(a, gt[:, :7]) if match_height else nearest_bev_iou(a, gt[:, :7])
    best, best_gt = iou.max(1)
    gt_best = iou.max(0).values
    gt_best = torch.where(gt_best == 0, -1.0, gt_best)
    forced = (iou == gt_best[None]).any(1)
    cls = gt[:, -1].to(torch.int32)
    labels[best < unmatched_thr] = 0
    pos = best >= matched_thr
    labels[pos] = cls[best_gt[pos]]
    labels[forced] = cls[best_gt[forced]]
    fg = labels > 0
    targets[fg] = coder.encode(gt[best_gt[fg], :7], anchors[fg])
    return labels, targets


def get_direction_targets(anchors: torch.Tensor, reg_targets: torch.Tensor,
                          dir_offset: float, num_bins: int) -> torch.Tensor:
    """(B, A, 7) anchors + residual targets -> (B, A) direction bins
    (anchor_head_template.py:146-160)."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    bins = torch.floor(offset_rot / (2 * math.pi / num_bins)).to(torch.int64)
    return bins.clamp(0, num_bins - 1)
