"""RoI head of SECOND-IoU (port of seevcn_tpu/models/modules/roi_heads.py;
reference roi_head_template.py:45-102, second_head.py:10-188 and
proposal_target_layer.py): the proposal layer, the rotated BEV grid pool,
SECONDHead, and for training the stratified RoI sampler and the IoU loss.

The sampler keeps the reference's fixed-shape form: a random priority
ranks the RoIs within each stratum (foreground, hard and easy background),
and the zero-foreground / zero-background corners fall back to the nearest
stratum instead of oversampling.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
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


def _fc_layers(cin: int, widths: Sequence[int], dp_ratio: float) -> list[nn.Module]:
    """Conv1d (k=1, no bias) + BN + ReLU per width, Dropout between them:
    the reference's make_fc_layers, whose indices the checkpoint keys use."""
    layers = []
    for k, f in enumerate(widths):
        layers += [nn.Conv1d(cin, f, 1, bias=False),
                   BatchNorm1d(f, eps=1e-3, momentum=0.01), nn.ReLU()]
        if k != len(widths) - 1 and dp_ratio > 0:
            layers.append(nn.Dropout(dp_ratio))
        cin = f
    return layers


def uniform(shape, generator, device) -> torch.Tensor:
    """U[0, 1) draws on ``device`` from ``generator``, a generator of that
    device (None: its default one)."""
    return torch.rand(shape, generator=generator, device=device)


def dropout(x: torch.Tensor, p: float, generator=None) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``generator``."""
    keep = uniform(x.shape, generator, x.device) >= p
    return torch.where(keep, x / (1 - p), 0.0)


class SECONDHead(nn.Module):
    """IoU-scoring rcnn head: shared FC stack + IoU regressor; dropout
    (DP_RATIO) between the shared layers in training."""

    def __init__(self, input_channels: int, grid_size: int,
                 shared_fc: Sequence[int] = (256, 256),
                 iou_fc: Sequence[int] = (256, 256), dp_ratio: float = 0.3):
        super().__init__()
        self.shared_fc_layer = nn.Sequential(*_fc_layers(
            input_channels * grid_size * grid_size, shared_fc, dp_ratio))
        self.iou_layers = nn.Sequential(
            *_fc_layers(shared_fc[-1], iou_fc, dp_ratio),
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


def get_max_iou_with_same_class(rois, roi_labels, gt_boxes, gt_labels, gt_valid):
    """(R, 7), (R,), (M, 7), (M,), (M,) -> each roi's max 3D IoU over the
    valid ground truth of its class, and that box's index (the first on a
    tie) (proposal_target_layer.py:197-232)."""
    iou = boxes_iou3d(rois, gt_boxes)
    same = roi_labels[:, None] == gt_labels[None, :]
    iou = torch.where(same & gt_valid[None, :], iou, 0.0)
    return iou.amax(1), iou.argmax(1)


def _stratum_rank(m: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Rank of each row among the rows of mask ``m`` by priority u (rows
    outside m rank after them), stable as jnp.argsort is."""
    order = torch.argsort(torch.where(m, u, 2.0), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    return rank


def sample_rois_for_rcnn(u, rois, roi_labels, roi_scores, roi_mask, gt_boxes,
                         cfg) -> dict:
    """One frame's stratified, fixed-shape RoI sample: u (R,) the random
    priorities in [0, 1), rois (R, 7+), gt_boxes (M, 8) padded. Takes up to
    FG_RATIO * ROI_PER_IMAGE foreground RoIs, HARD_BG_RATIO of the rest from
    hard background, easy background after that. -> rois (S, 7+),
    roi_labels, rcnn_cls_labels (S,) (-1 where ignored), reg_valid_mask,
    gt_of_rois (S, 8), gt_iou_of_rois, roi_sample_mask."""
    s = int(cfg.ROI_PER_IMAGE)
    fg_per_image = int(np.round(cfg.FG_RATIO * s))
    fg_thresh = min(float(cfg.REG_FG_THRESH), float(cfg.CLS_FG_THRESH))

    gt_labels = gt_boxes[:, -1].to(torch.int32)
    gt_valid = gt_boxes.abs().sum(1) > 0
    max_iou, gt_assign = get_max_iou_with_same_class(
        rois[:, :7], roi_labels, gt_boxes[:, :7], gt_labels, gt_valid)
    max_iou = torch.where(roi_mask, max_iou, -1.0)

    fg = max_iou >= fg_thresh
    easy_bg = roi_mask & (max_iou < float(cfg.CLS_BG_THRESH_LO)) & (max_iou >= 0)
    hard_bg = roi_mask & (max_iou >= float(cfg.CLS_BG_THRESH_LO)) \
        & (max_iou < float(cfg.REG_FG_THRESH))

    take_fg = fg.sum().clamp_max(fg_per_image)
    want_hard = torch.floor((s - take_fg) * float(cfg.HARD_BG_RATIO)).to(torch.int64)
    take_hard = torch.minimum(want_hard, hard_bg.sum())
    sel_fg = fg & (_stratum_rank(fg, u) < take_fg)
    sel_hard = hard_bg & (_stratum_rank(hard_bg, u) < take_hard)
    # easy background fills the rest
    remaining = s - take_fg - sel_hard.sum()
    sel_easy = easy_bg & (_stratum_rank(easy_bg, u) < remaining)
    selected = sel_fg | sel_hard | sel_easy

    # compact: foreground first, then background, then the unselected
    prio = torch.where(sel_fg, 0, torch.where(sel_hard | sel_easy, 1, 2))
    sel_idx = torch.argsort(prio * 10.0 + u, stable=True)[:s]
    sel_valid = selected[sel_idx]
    out_iou = max_iou[sel_idx]
    reg_valid = (out_iou >= float(cfg.REG_FG_THRESH)) & sel_valid

    score_type = cfg.get("CLS_SCORE_TYPE", "raw_roi_iou")
    if score_type == "cls":
        cls_labels = (out_iou > float(cfg.CLS_FG_THRESH)).float()
        ignore = (out_iou > float(cfg.CLS_BG_THRESH)) & (out_iou < float(cfg.CLS_FG_THRESH))
        cls_labels = torch.where(ignore, -1.0, cls_labels)
    elif score_type == "roi_iou":
        bg_t, fg_t = float(cfg.CLS_BG_THRESH), float(cfg.CLS_FG_THRESH)
        cls_labels = ((out_iou - bg_t) / (fg_t - bg_t)).clamp(0.0, 1.0)
    else:                                                       # raw_roi_iou
        cls_labels = out_iou.clamp(0.0, 1.0)
    cls_labels = torch.where(sel_valid, cls_labels, -1.0)
    return {"rois": rois[sel_idx], "roi_labels": roi_labels[sel_idx],
            "rcnn_cls_labels": cls_labels, "reg_valid_mask": reg_valid,
            "gt_of_rois": gt_boxes[gt_assign[sel_idx]], "gt_iou_of_rois": out_iou,
            "roi_sample_mask": sel_valid}


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
