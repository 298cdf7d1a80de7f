"""SECOND-IoU's RoI head (SEE-VCN's second_head.py and OpenPCDet's
roi_head_template.py, proposal_target_layer.py): the proposal layer, the
rotated BEV grid pool, SECONDHead, and for training the RoI sample and the
IoU loss.

The sample follows the program's fixed-shape rule, given each RoI's random
priority: the foreground RoIs of lowest priority up to FG_RATIO of
ROI_PER_IMAGE, then HARD_BG_RATIO of the rest from hard background, then
easy background; foreground rows first, then background, then unsampled
rows, each by priority.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.iou3d import boxes_iou3d
from ...ops.nms import nms_bev
from ..losses import binary_cross_entropy_with_logits
from .common import BatchNorm1d


@torch.no_grad()
def proposal_layer(batch_cls_preds: torch.Tensor, batch_box_preds: torch.Tensor,
                   nms_config) -> dict:
    """(B, A, ncls), (B, A, 7+C) -> rois (B, R, 7+C), roi_scores (B, R) (the
    raw class score, before the sigmoid), roi_labels (B, R) int32 (1-based),
    roi_mask (B, R): per frame, the NMS of the decoded anchor boxes."""
    roi_score, roi_label = batch_cls_preds.max(-1)
    out = {"rois": [], "roi_scores": [], "roi_labels": [], "roi_mask": []}
    for boxes, score, label in zip(batch_box_preds, roi_score, roi_label):
        idx, keep, _ = nms_bev(boxes[:, :7], score,
                               thresh=float(nms_config.NMS_THRESH),
                               pre_maxsize=int(nms_config.NMS_PRE_MAXSIZE),
                               post_maxsize=int(nms_config.NMS_POST_MAXSIZE))
        out["rois"].append(torch.where(keep[:, None], boxes[idx], 0.0))
        out["roi_scores"].append(torch.where(keep, score[idx], 0.0))
        out["roi_labels"].append(torch.where(keep, label[idx] + 1, 0).to(torch.int32))
        out["roi_mask"].append(keep)
    return {k: torch.stack(v) for k, v in out.items()}


def bilinear_sample(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """fmap (H, W, C), xy (..., 2) pixel coords (x, y) -> (..., C), zero
    outside (grid_sample with zero padding and align_corners=True)."""
    h, w, c = fmap.shape
    flat = fmap.reshape(h * w, c)
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        return torch.where(inb[..., None], flat[lin], 0.0)

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def roi_grid_pool_bev(bev: torch.Tensor, rois: torch.Tensor, grid_size: int,
                      point_cloud_range, voxel_size, downsample_ratio: int) -> torch.Tensor:
    """bev (B, H, W, C), rois (B, R, 7) -> (B, R, g, g, C): a g x g grid
    rotated with each roi, bilinear-sampled with the align-corners pixel
    mapping of second_head.py:63-120."""
    min_x, min_y = float(point_cloud_range[0]), float(point_cloud_range[1])
    vx = float(voxel_size[0]) * downsample_ratio
    vy = float(voxel_size[1]) * downsample_ratio
    u = torch.linspace(-1.0, 1.0, grid_size, device=bev.device)
    pv, pu = torch.meshgrid(u, u, indexing="ij")   # pu varies along columns
    out = []
    for fmap, r in zip(bev, rois):
        cx = ((r[:, 0] - min_x) / vx - 0.5)[:, None, None]   # pixel centres
        cy = ((r[:, 1] - min_y) / vy - 0.5)[:, None, None]
        hx = (r[:, 3] / vx / 2)[:, None, None]
        hy = (r[:, 4] / vy / 2)[:, None, None]
        ca = torch.cos(r[:, 6])[:, None, None]
        sa = torch.sin(r[:, 6])[:, None, None]
        xs = cx + hx * (ca * pu - sa * pv)
        ys = cy + hy * (sa * pu + ca * pv)
        out.append(bilinear_sample(fmap, torch.stack([xs, ys], -1)))
    return torch.stack(out)


def _fc_layers(cin: int, widths: Sequence[int], dp_ratio: float,
               dropout: bool = True) -> list[nn.Module]:
    """Conv1d (k=1, no bias) + BN + ReLU per width, Dropout between them:
    the reference's make_fc_layers, whose indices the checkpoint keys use.
    With ``dropout`` False the slot holds an Identity: the JAX package
    draws dropout in an rcnn head's shared stack only."""
    layers = []
    for k, f in enumerate(widths):
        f = int(f)
        layers += [nn.Conv1d(cin, f, 1, bias=False),
                   BatchNorm1d(f, eps=1e-3, momentum=0.01), nn.ReLU()]
        if k != len(widths) - 1 and dp_ratio > 0:
            layers.append(nn.Dropout(dp_ratio) if dropout else nn.Identity())
        cin = f
    return layers


def dropout(x: torch.Tensor, p: float, generator=None) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1 - p), 0.0)


class SECONDHead(nn.Module):
    """IoU-scoring rcnn head: shared FC stack + IoU regressor; dropout
    (DP_RATIO) between the shared layers in training, none in the IoU
    branch (seevcn_tpu/models/modules/roi_heads.py:SECONDHead)."""

    def __init__(self, input_channels: int, grid_size: int,
                 shared_fc: Sequence[int] = (256, 256),
                 iou_fc: Sequence[int] = (256, 256), dp_ratio: float = 0.3):
        super().__init__()
        self.shared_fc_layer = nn.Sequential(*_fc_layers(
            input_channels * grid_size * grid_size, shared_fc, dp_ratio))
        self.iou_layers = nn.Sequential(
            *_fc_layers(shared_fc[-1], iou_fc, dp_ratio, dropout=False),
            nn.Conv1d(iou_fc[-1], 1, 1, bias=True))

    def forward(self, pooled: torch.Tensor, generator=None) -> torch.Tensor:
        """pooled (B, R, g, g, C) -> rcnn_iou (B, R), flattened in the
        reference's (C, g, g) order. In training, dropout masks come from
        ``generator``."""
        b, r, g, _, c = pooled.shape
        x = pooled.permute(0, 1, 4, 2, 3).reshape(b * r, c * g * g, 1)
        for layer in (*self.shared_fc_layer, *self.iou_layers):
            if isinstance(layer, nn.Dropout):
                if self.training:
                    x = dropout(x, layer.p, generator)
            else:
                x = layer(x)
        return x.reshape(b, r)


def sample_rois_for_rcnn(u, rois, roi_labels, roi_scores, roi_mask, gt_boxes,
                         cfg) -> dict:
    """One frame: priorities u (R,), rois (R, 7+), gt_boxes (M, 8) padded
    -> rois (S, 7+), roi_labels, rcnn_cls_labels (S,) (-1 where ignored),
    reg_valid_mask, gt_of_rois (S, 8), gt_iou_of_rois, roi_sample_mask."""
    s = int(cfg.ROI_PER_IMAGE)
    real = gt_boxes.abs().sum(1) > 0
    iou = boxes_iou3d(rois[:, :7], gt_boxes[:, :7])
    same = roi_labels[:, None].long() == gt_boxes[None, :, -1].long()
    iou = torch.where(same & real[None], iou, torch.zeros((), dtype=iou.dtype, device=iou.device))
    best, best_gt = iou.max(1) if iou.shape[1] else (iou.new_zeros(iou.shape[0]),
                                                     torch.zeros_like(u, dtype=torch.long))
    best = torch.where(roi_mask, best, -1.0)

    def by_priority(m):
        i = torch.nonzero(m)[:, 0]
        return i[torch.argsort(u[i], stable=True)]

    fg = by_priority(best >= min(float(cfg.REG_FG_THRESH), float(cfg.CLS_FG_THRESH)))
    hard = by_priority(roi_mask & (best >= float(cfg.CLS_BG_THRESH_LO))
                       & (best < float(cfg.REG_FG_THRESH)))
    easy = by_priority(roi_mask & (best >= 0) & (best < float(cfg.CLS_BG_THRESH_LO)))
    fg = fg[:int(round(float(cfg.FG_RATIO) * s))]
    hard = hard[:int((s - fg.shape[0]) * float(cfg.HARD_BG_RATIO))]
    easy = easy[:s - fg.shape[0] - hard.shape[0]]
    bg = torch.cat([hard, easy])
    bg = bg[torch.argsort(u[bg], stable=True)]
    taken = torch.zeros_like(roi_mask)
    taken[fg], taken[bg] = True, True
    idx = torch.cat([fg, bg, by_priority(~taken)])[:s]
    sampled = taken[idx]
    out_iou = best[idx]
    labels = torch.where(sampled, out_iou.clamp(0.0, 1.0), -1.0)
    if cfg.get("CLS_SCORE_TYPE", "raw_roi_iou") != "raw_roi_iou":
        raise NotImplementedError(cfg.CLS_SCORE_TYPE)
    return {"rois": rois[idx], "roi_labels": roi_labels[idx], "rcnn_cls_labels": labels,
            "reg_valid_mask": sampled & (out_iou >= float(cfg.REG_FG_THRESH)),
            "gt_of_rois": gt_boxes[best_gt[idx]], "gt_iou_of_rois": out_iou,
            "roi_sample_mask": sampled}


def rcnn_iou_loss(rcnn_iou: torch.Tensor, rcnn_cls_labels: torch.Tensor,
                  loss_type: str = "BinaryCrossEntropy",
                  weight: float = 1.0) -> torch.Tensor:
    """second_head.py:163-188: BCE (or L2) of the IoU logits against the
    sampled labels, averaged over the labels that are not ignored (-1)."""
    pred, lab = rcnn_iou.reshape(-1), rcnn_cls_labels.reshape(-1)
    if loss_type == "BinaryCrossEntropy":
        per = binary_cross_entropy_with_logits(pred, lab.clamp(0, 1))
    elif loss_type == "L2":
        per = (pred - lab) ** 2
    else:
        raise NotImplementedError(loss_type)
    valid = (lab >= 0).float()
    return (per * valid).sum() / valid.sum().clamp_min(1.0) * weight
