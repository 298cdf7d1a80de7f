"""PV-RCNN's keypoint foreground head and RoI-grid head (port of
seevcn_tpu/models/modules/pvrcnn_head.py; reference
pcdet/models/dense_heads/point_head_simple.py, roi_heads/pvrcnn_head.py and
roi_head_template.py).

- ``PointHeadSimple`` scores each keypoint as foreground; its sigmoid
  weighs the keypoint features that the RoI grid pools.
- ``PVRCNNHead``: 6^3 grid points a RoI, set abstraction of the weighted
  keypoint features around each, the shared FC stack, then the class and
  box branches. Box residuals live in the RoI's canonical frame.
- In training: the point head's BCE against "inside an enlarged ground
  truth box", and the RCNN loss, BCE on the RoI-IoU labels, smooth-l1 on
  the canonical residuals and the corner regularisation.

Key names are OpenPCDet's. Dropout (DP_RATIO) runs between the shared
layers only, as in the JAX package; the branches keep an empty slot where
the reference's ``make_fc_layers`` puts one, so that their key indices are
the reference's.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...geom.boxes import boxes_to_corners_3d, enlarge_box3d, points_in_boxes
from ...geom.transforms import rotate_points_along_z
from ...parallel.mesh import global_count
from ..losses import binary_cross_entropy_with_logits, weighted_smooth_l1
from .box_coder import ResidualCoder
from .common import BatchNorm1d
from .pfe import SALayer
from .roi_heads import _fc_layers, dropout


class PointHeadSimple(nn.Module):
    """Keypoint foreground scorer: Linear (no bias) + BN + ReLU per CLS_FC
    width, then a Linear to one logit."""

    def __init__(self, input_channels: int, cls_fc: Sequence[int] = (256, 256)):
        super().__init__()
        layers, c = [], input_channels
        for f in cls_fc:
            layers += [nn.Linear(c, int(f), bias=False),
                       BatchNorm1d(int(f), eps=1e-3, momentum=0.01), nn.ReLU()]
            c = int(f)
        layers.append(nn.Linear(c, 1, bias=True))
        self.cls_layers = nn.Sequential(*layers)

    def forward(self, point_features: torch.Tensor) -> torch.Tensor:
        """(B, K, C) -> (B, K) logits."""
        b, k, c = point_features.shape
        return self.cls_layers(point_features.reshape(b * k, c)).reshape(b, k)


def point_head_loss(logits, keypoints, gt_boxes, gt_mask, extra_width=(0.2, 0.2, 0.2)):
    """BCE of the keypoint logits (B, K) against targets "inside a valid
    ground-truth box (B, M, 7+) grown by ``extra_width``", summed and
    divided by the positives (at least 1)."""
    targets = torch.stack([
        (points_in_boxes(kp, enlarge_box3d(gb[:, :7], extra_width))
         & gm[:, None]).any(0)
        for kp, gb, gm in zip(keypoints, gt_boxes, gt_mask)])
    per = binary_cross_entropy_with_logits(logits, targets.to(logits.dtype))
    return per.sum() / global_count(targets.sum()).clamp_min(1.0)


def roi_grid_points(rois: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(R, 7) -> (R, G^3, 3) world-frame grid points at the cell centres of
    a G x G x G grid over each box, x-major (get_global_grid_points_of_roi)."""
    g = grid_size
    r = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    local = (idx.to(rois.dtype) + 0.5) / g - 0.5
    local = local[None] * rois[:, None, 3:6]
    return rotate_points_along_z(local, rois[:, 6]) + rois[:, None, :3]


class PVRCNNHead(nn.Module):
    def __init__(self, input_channels: int, roi_cfg, num_class: int = 1,
                 code_size: int = 7):
        super().__init__()
        pool = roi_cfg.ROI_GRID_POOL
        if pool.get("POOL_METHOD", "max_pool") != "max_pool":
            raise NotImplementedError(f"ROI_GRID_POOL.POOL_METHOD {pool.POOL_METHOD}")
        self.grid_size = int(pool.GRID_SIZE)
        self.roi_grid_pool_layer = SALayer(input_channels, pool.POOL_RADIUS,
                                           pool.NSAMPLE, pool.MLPS)
        dp = float(roi_cfg.DP_RATIO)
        self.dp_ratio = dp
        c = self.roi_grid_pool_layer.out_channels * self.grid_size ** 3
        self.shared_fc_layer = nn.Sequential(*_fc_layers(c, roi_cfg.SHARED_FC, dp))
        c = int(roi_cfg.SHARED_FC[-1])
        self.cls_layers = nn.Sequential(
            *_fc_layers(c, roi_cfg.CLS_FC, dp, dropout=False),
            nn.Conv1d(int(roi_cfg.CLS_FC[-1]), num_class, 1, bias=True))
        self.reg_layers = nn.Sequential(
            *_fc_layers(c, roi_cfg.REG_FC, dp, dropout=False),
            nn.Conv1d(int(roi_cfg.REG_FC[-1]), code_size * num_class, 1, bias=True))

    def pool(self, rois, keypoints, keypoint_features, keypoint_scores) -> torch.Tensor:
        """rois (B, R, 7), keypoints (B, K, 3), their features (B, K, C) and
        sigmoid scores (B, K) -> (B, R, G^3, C'): the RoI-grid pool of the
        score-weighted keypoint features."""
        weighted = keypoint_features * keypoint_scores[..., None]
        b, r = rois.shape[:2]
        grids = [roi_grid_points(fr, self.grid_size).reshape(-1, 3) for fr in rois]
        # JAX's support width: the keypoint count
        feats = self.roi_grid_pool_layer(list(zip(grids, keypoints, weighted)),
                                         width=keypoints.shape[1])
        return feats.reshape(b, r, self.grid_size ** 3, -1)

    def head(self, pooled: torch.Tensor, generator=None):
        """(B, R, G^3, C') -> (rcnn_cls (B, R), rcnn_reg (B, R, 7)), flattened
        in the reference's (C', G^3) order. In training, dropout between the
        shared layers draws from ``generator``."""
        b, r, p, c = pooled.shape
        x = pooled.permute(0, 1, 3, 2).reshape(b * r, c * p, 1)
        for layer in self.shared_fc_layer:
            if isinstance(layer, nn.Dropout):
                if self.training:
                    x = dropout(x, layer.p, generator)
            else:
                x = layer(x)
        return (self.cls_layers(x).reshape(b, r),
                self.reg_layers(x).reshape(b, r, -1))

    def forward(self, rois, keypoints, keypoint_features, keypoint_scores,
                generator=None):
        return self.head(self.pool(rois, keypoints, keypoint_features,
                                   keypoint_scores), generator)


def _roi_anchor(rois: torch.Tensor) -> torch.Tensor:
    """The RoI at the origin with its own size and heading 0."""
    return torch.cat([torch.zeros_like(rois[..., :3]), rois[..., 3:6],
                      torch.zeros_like(rois[..., 6:7])], -1)


def decode_rcnn_boxes(rois: torch.Tensor, rcnn_reg: torch.Tensor,
                      coder: ResidualCoder | None = None) -> torch.Tensor:
    """Canonical residuals (..., 7) of rois (..., 7) -> world boxes
    (generate_predicted_boxes)."""
    coder = coder or ResidualCoder()
    local = coder.decode(rcnn_reg, _roi_anchor(rois))
    ry = rois[..., 6]
    xyz = rotate_points_along_z(local[..., None, :3].reshape(-1, 1, 3),
                                ry.reshape(-1)).reshape(*ry.shape, 3)
    return torch.cat([xyz + rois[..., :3], local[..., 3:6],
                      local[..., 6:7] + ry[..., None], local[..., 7:]], -1)


def canonical_gt_of_rois(rois: torch.Tensor, gt_of_rois: torch.Tensor) -> torch.Tensor:
    """Ground truth (..., 7+) into each RoI's canonical frame
    (roi_head_template.py:113-133), the heading folded to [-pi/2, pi/2]
    with the opposite direction flipped."""
    ry = torch.remainder(rois[..., 6], 2 * math.pi)
    centred = torch.cat([gt_of_rois[..., :3] - rois[..., :3], gt_of_rois[..., 3:6],
                         gt_of_rois[..., 6:7] - ry[..., None]], -1)
    xyz = rotate_points_along_z(centred[..., None, :3].reshape(-1, 1, 3),
                                -ry.reshape(-1)).reshape(*ry.shape, 3)
    heading = torch.remainder(centred[..., 6], 2 * math.pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite, torch.remainder(heading + math.pi, 2 * math.pi),
                          heading)
    heading = torch.where(heading > math.pi, heading - 2 * math.pi, heading)
    heading = heading.clamp(-math.pi / 2, math.pi / 2)
    return torch.cat([xyz, centred[..., 3:6], heading[..., None]], -1)


def pvrcnn_rcnn_loss(rcnn_cls, rcnn_reg, targets: dict, loss_cfg,
                     coder: ResidualCoder | None = None):
    """(roi_head_template.py:136-232) BCE of rcnn_cls (B, R) on the sampled
    RoI-IoU labels (-1 ignored), smooth-l1 of rcnn_reg (B, R, 7) against the
    canonical residuals of the foreground RoIs, and with
    CORNER_LOSS_REGULARIZATION the corner loss of the decoded boxes against
    the ground truth or its flip, whichever is nearer. -> (total, terms
    rcnn_loss_cls, rcnn_loss_reg, rcnn_loss_corner, rcnn_loss)."""
    coder = coder or ResidualCoder()
    w = loss_cfg.LOSS_WEIGHTS
    labels = targets["rcnn_cls_labels"]
    valid = (labels >= 0).to(rcnn_cls.dtype)
    cls_per = binary_cross_entropy_with_logits(rcnn_cls, labels.clamp(0, 1))
    cls_loss = (cls_per * valid).sum() / global_count(valid.sum()).clamp_min(1.0) \
        * float(w["rcnn_cls_weight"])

    rois = targets["rois"][..., :7]
    gt = targets["gt_of_rois"][..., :7]
    reg_targets = coder.encode(canonical_gt_of_rois(rois, gt), _roi_anchor(rois))
    fg = targets["reg_valid_mask"].to(rcnn_reg.dtype)
    n_fg = global_count(fg.sum()).clamp_min(1.0)
    reg_per = weighted_smooth_l1(rcnn_reg, reg_targets, fg,
                                 code_weights=w["code_weights"])
    reg_loss = reg_per.sum() / n_fg * float(w["rcnn_reg_weight"])
    total = cls_loss + reg_loss
    tb = {"rcnn_loss_cls": cls_loss, "rcnn_loss_reg": reg_loss}
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        decoded = decode_rcnn_boxes(rois, rcnn_reg, coder).reshape(-1, 7)
        flat = gt.reshape(-1, 7)
        c_pred = boxes_to_corners_3d(decoded)
        c_gt = boxes_to_corners_3d(flat)
        flip = torch.cat([flat[:, :6], flat[:, 6:7] + math.pi], -1)
        d = torch.minimum(torch.linalg.norm(c_pred - c_gt, dim=-1),
                          torch.linalg.norm(c_pred - boxes_to_corners_3d(flip), dim=-1))
        corner = (d.mean(-1).reshape(fg.shape) * fg).sum() / n_fg \
            * float(w["rcnn_corner_weight"])
        tb["rcnn_loss_corner"] = corner
        total = total + corner
    tb["rcnn_loss"] = total
    return total, tb
