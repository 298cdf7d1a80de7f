"""Anchors and their targets (port of ``generate_anchors``,
``AxisAlignedTargetAssigner``, ``ATSSTargetAssigner`` and
``get_direction_targets`` of seevcn_tpu/models/modules/anchors.py; reference
anchor_generator.py:17-60, axis_aligned_target_assigner.py:36-210 and
atss_target_assigner.py:7-142).

Anchors: grid anchors at every feature-map cell, per class sizes, rotations
and bottom heights, flattened (z, y, x, size, rot) as the conv head's
channels are; host-side numpy, as in the reference. Targets: per anchor
class, the IoU of every anchor with every ground-truth box of that class,
matched / unmatched thresholds, and each ground truth's best anchors forced
to match; residual targets for the positives. Fixed shapes over padded
ground truth (all-zero rows), as in the reference: a padding row has zero
IoU everywhere and is neutralised by ``g2a_max == 0 -> -1``.

ATSS assigns over every anchor at once, in the head's layout (the anchor
classes interleaved per location, as the head predicts them and as the
axis-aligned assigner lays out its targets). The JAX package joins the
classes class-major there, which puts the labels of several anchor classes
on rows the head predicts for other anchors; with one anchor class the two
orders agree.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...geom.boxes import boxes3d_nearest_bev_iou
from ...geom.transforms import limit_period
from ...ops.iou3d import boxes_iou3d, boxes_iou_bev


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
    """Anchor-to-ground-truth assignment per anchor class, thresholds from
    the anchor generator config."""

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
        reg_weights (B, A), with the classes interleaved per location as the
        reference's cat(dim=-2) lays them out."""
        labels, targets, weights = [], [], []
        for gt in gt_boxes:
            gt_cls = gt[:, -1].to(torch.int32)
            per = [_assign_single(a, gt[:, :7], gt_cls, cid, mt, ut,
                                  self.box_coder, self.match_height)
                   for a, cid, mt, ut in zip(anchors_per_class, self.class_ids,
                                             self.matched, self.unmatched)]
            loc = per[0][0].shape[0]
            labels.append(torch.cat([p[0].reshape(loc, -1) for p in per], -1).reshape(-1))
            targets.append(torch.cat([p[1].reshape(loc, -1, p[1].shape[-1])
                                      for p in per], -2).reshape(-1, per[0][1].shape[-1]))
            weights.append(torch.cat([p[2].reshape(loc, -1) for p in per], -1).reshape(-1))
        return {"box_cls_labels": torch.stack(labels),
                "box_reg_targets": torch.stack(targets),
                "reg_weights": torch.stack(weights)}


def _assign_single(anchors, gt, gt_cls, class_id, matched_thr, unmatched_thr,
                   coder, match_height):
    """One frame, one anchor class: anchors (..., ndim) -> labels, targets,
    weights with the anchors' leading shape. ``argmax`` takes the first
    maximum, as ``jnp.argmax`` does, over the IoUs and over the boolean
    force-match rows alike."""
    a_shape = anchors.shape[:-1]
    a = anchors.reshape(-1, anchors.shape[-1])[:, :7]
    cls_mask = (gt_cls == class_id) & (gt.abs().sum(1) > 0)
    iou = boxes_iou3d(a, gt, row_chunk=8192) if match_height \
        else boxes3d_nearest_bev_iou(a, gt)
    iou = torch.where(cls_mask[None, :], iou, 0.0)

    a2g_max, a2g_arg = iou.amax(1), iou.argmax(1)
    g2a_max = iou.amax(0)
    g2a_max = torch.where(g2a_max == 0, -1.0, g2a_max)
    # force-match: every anchor that reaches a ground truth's best IoU
    force = (iou == g2a_max[None, :]) & cls_mask[None, :]
    force_any = force.any(1)
    force_gt = force.to(torch.uint8).argmax(1)

    pos = a2g_max >= matched_thr
    neg = a2g_max < unmatched_thr
    labels = torch.full(a2g_max.shape, -1, dtype=torch.int32, device=a.device)
    labels = torch.where(neg, 0, labels)
    labels = torch.where(pos, gt_cls[a2g_arg], labels)
    labels = torch.where(force_any, gt_cls[force_gt], labels)

    assigned = torch.where(force_any & ~pos, force_gt, a2g_arg)
    fg = labels > 0
    targets = torch.where(fg[:, None], coder.encode(gt[assigned], a), 0.0)
    return (labels.reshape(a_shape), targets.reshape(*a_shape, -1),
            fg.to(torch.float32).reshape(a_shape))


def get_direction_targets(anchors: torch.Tensor, reg_targets: torch.Tensor,
                          dir_offset: float, num_bins: int) -> torch.Tensor:
    """(B, A, 7) anchors + residual targets -> (B, A) direction bins
    (anchor_head_template.py:146-160)."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    bins = torch.floor(offset_rot / (2 * math.pi / num_bins)).to(torch.int64)
    return bins.clamp(0, num_bins - 1)


class ATSSTargetAssigner:
    """Adaptive training sample selection (arXiv:1912.02424): per ground
    truth, the TOPK anchors nearest by 3D centre distance (a stable sort:
    ties to the lower row), their IoUs thresholded at mean + std (ddof 1) +
    1e-6, the anchor centre inside the ground truth's rotated BEV rectangle;
    each anchor then takes its best-IoU positive ground truth, and each
    valid ground truth's best anchor (first maximum) is forced to it, the
    later ground truth winning a shared anchor as XLA's scatter does. No
    anchor is ignored: labels are 0 or a class id."""

    def __init__(self, topk: int, box_coder, match_height: bool = False):
        self.topk = int(topk)
        self.box_coder = box_coder
        self.match_height = bool(match_height)

    def assign(self, anchors: torch.Tensor, gt_boxes: torch.Tensor) -> dict:
        """anchors (A, ndim) in the head's layout; gt_boxes (B, M, 8), zero
        rows padding -> box_cls_labels (B, A) int32, box_reg_targets (B, A,
        code), reg_weights (B, A)."""
        a = anchors[:, :7]
        per = [self._assign_one(a, gt) for gt in gt_boxes]
        return {k: torch.stack([p[i] for p in per]) for i, k in enumerate(
            ("box_cls_labels", "box_reg_targets", "reg_weights"))}

    def _assign_one(self, a: torch.Tensor, gt_all: torch.Tensor):
        gt = gt_all[:, :7]
        gt_cls = gt_all[:, -1].to(torch.int32)
        valid = gt_all.abs().sum(1) > 0
        num_gt, num_a = gt.shape[0], a.shape[0]
        iou = boxes_iou3d(a, gt, row_chunk=8192) if self.match_height \
            else boxes_iou_bev(a, gt, row_chunk=8192)
        iou = torch.where(valid[None, :], iou, 0.0)

        d = a[:, None, :3] - gt[None, :, :3]
        dist = (d * d).sum(-1).sqrt()
        k = min(self.topk, num_a)
        topk_idx = torch.sort(dist.T, dim=1, stable=True).indices[:, :k]    # (M, K)
        cand = torch.zeros((num_gt, num_a), dtype=torch.bool, device=a.device)
        cand.scatter_(1, topk_idx, True)
        cand_iou = torch.gather(iou.T, 1, topk_idx)
        thr = cand_iou.mean(1) + cand_iou.std(1) + 1e-6

        c, s = torch.cos(-gt[:, 6]), torch.sin(-gt[:, 6])
        lx = d[..., 0] * c[None, :] - d[..., 1] * s[None, :]
        ly = d[..., 0] * s[None, :] + d[..., 1] * c[None, :]
        inside = (lx.abs() <= gt[None, :, 3] / 2) & (ly.abs() <= gt[None, :, 4] / 2)
        is_pos = cand.T & (iou >= thr[None, :]) & inside & valid[None, :]

        neg = -1e9
        iou_pos = torch.where(is_pos, iou, neg)
        best_val, best_gt = iou_pos.amax(1), iou_pos.argmax(1)
        # force-match each valid ground truth's best anchor; where several
        # name one anchor the last one's write stands, an invalid row's
        # write keeping what was there
        gt_best_val, gt_best_anchor = iou.amax(0), iou.argmax(0)
        rows = torch.arange(num_gt, device=a.device)
        writer = torch.full((num_a,), -1, dtype=torch.long, device=a.device).scatter_reduce(
            0, gt_best_anchor, rows, "amax", include_self=True)
        j = writer.clamp_min(0)
        forced = (writer >= 0) & valid[j]
        best_gt = torch.where(forced, j, best_gt)
        best_val = torch.where(forced, gt_best_val[j], best_val)

        fg = best_val > neg / 2
        labels = torch.where(fg, gt_cls[best_gt], 0).to(torch.int32)
        targets = torch.where(fg[:, None], self.box_coder.encode(gt[best_gt], a), 0.0)
        return labels, targets, fg.to(torch.float32)
