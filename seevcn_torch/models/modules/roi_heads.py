"""RoI head of SECOND-IoU, eval side (port of proposal_layer,
bilinear_sample, roi_grid_pool_bev and SECONDHead of
seevcn_tpu/models/modules/roi_heads.py; reference roi_head_template.py:45-102
and second_head.py:10-188)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.nms import nms_bev


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
                   nn.BatchNorm1d(f, eps=1e-3, momentum=0.01), nn.ReLU()]
        if k != len(widths) - 1 and dp_ratio > 0:
            layers.append(nn.Dropout(dp_ratio))
        cin = f
    return layers


class SECONDHead(nn.Module):
    """IoU-scoring rcnn head: shared FC stack + IoU regressor (eval)."""

    def __init__(self, input_channels: int, grid_size: int,
                 shared_fc: Sequence[int] = (256, 256),
                 iou_fc: Sequence[int] = (256, 256), dp_ratio: float = 0.3):
        super().__init__()
        self.shared_fc_layer = nn.Sequential(*_fc_layers(
            input_channels * grid_size * grid_size, shared_fc, dp_ratio))
        self.iou_layers = nn.Sequential(
            *_fc_layers(shared_fc[-1], iou_fc, dp_ratio),
            nn.Conv1d(iou_fc[-1], 1, 1, bias=True))

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        """pooled (B, R, g, g, C) -> rcnn_iou (B, R), flattened in the
        reference's (C, g, g) order."""
        b, r, g, _, c = pooled.shape
        x = pooled.permute(0, 1, 4, 2, 3).reshape(b * r, c * g * g, 1)
        return self.iou_layers(self.shared_fc_layer(x)).reshape(b, r)
