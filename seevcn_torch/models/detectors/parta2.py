"""Part-A2 (Part-A² net): forward and training loss (port of PartA2 of
seevcn_tpu/models/detectors/parta2.py; reference PartA2_net.py,
dense_heads/point_intra_part_head.py, roi_heads/partA2_head.py and
tools/cfgs/kitti_models/PartA2.yaml).

MeanVFE -> UNetV2 (``unet3d.py``), whose stride-8 tensor feeds the anchor
RPN (HeightCompression -> BaseBEVBackbone -> AnchorHeadSingle -> the
proposal NMS, in training the RoI sample: ``AnchorDetector``), and whose
stride-1 features feed the intra-object part head: one Linear to a
segmentation logit (``seg_out``) and one to three part locations
(``part_out``). The RoI head pools, per frame over that frame's voxel
centres, [sigmoid(part), sigmoid(seg)] by the mean and the 16 features by
the max in each RoI's G^3 roiaware grid (``ops/roiaware.py``; G from
ROI_GRID_POOL.GRID_SIZE, 12 by default, as the JAX package reads it),
flattens them cell-major with the channels minor, and runs the shared,
class and box stacks (Linear without bias, BN, ReLU; no dropout, as the
JAX package has none whatever DP_RATIO says). In training the pooled
inputs are detached. In eval the refined boxes become ``rois`` and
``rcnn_iou`` is the class logit.

The JAX package's docstring calls the RoI pool a radius grouping; its code
runs the exact roiaware pool, which the port follows.

State-dict keys: OpenPCDet's for the backbones and the anchor head
(``backbone_3d`` with the decoder's ``conv_up_t{i}``, ``conv_up_m{i}``,
``inv_conv{i}``, ``conv5``; ``backbone_2d``; ``dense_head.conv_*``); the
JAX package's module names for the rest: ``seg_out``, ``part_out``,
``roi_head.{shared,cls,reg}_fc{i}`` (Linear, no bias) and ``_bn{i}``,
``roi_head.cls_out`` and ``reg_out``.
"""
from __future__ import annotations

import torch
from torch import nn

from ...geom.boxes import points_in_boxes
from ...geom.transforms import rotate_points_along_z
from ...ops.roiaware import roiaware_pool3d
from ...parallel.mesh import global_count
from ..losses import binary_cross_entropy_with_logits
from ..modules.common import BatchNorm1d
from ..modules.pfe import voxel_centres
from ..modules.pvrcnn_head import decode_rcnn_boxes, pvrcnn_rcnn_loss
from .second import AnchorDetector, DetectorConfig


class PartA2FCHead(nn.Module):
    """The FC stacks of Part-A2's RoI head over the roiaware-pooled grid."""

    def __init__(self, roi_cfg, point_channels: int = 16, code_size: int = 7):
        super().__init__()
        pool = roi_cfg.get("ROI_GRID_POOL", {})
        self.grid_size = int(pool.get("GRID_SIZE", 12))
        self.relu = nn.ReLU()
        self.branches = {}
        cin = (4 + point_channels) * self.grid_size ** 3
        shared = int(roi_cfg.SHARED_FC[-1])
        for name, widths, c in (("shared", roi_cfg.SHARED_FC, cin),
                                ("cls", roi_cfg.CLS_FC, shared),
                                ("reg", roi_cfg.REG_FC, shared)):
            self.branches[name] = len(widths)
            for i, f in enumerate(widths):
                self.add_module(f"{name}_fc{i}", nn.Linear(c, int(f), bias=False))
                self.add_module(f"{name}_bn{i}", BatchNorm1d(int(f), eps=1e-3, momentum=0.01))
                c = int(f)
        self.cls_out = nn.Linear(int(roi_cfg.CLS_FC[-1]), 1)
        self.reg_out = nn.Linear(int(roi_cfg.REG_FC[-1]), code_size)

    def _stack(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.branches[name]):
            x = self.relu(getattr(self, f"{name}_bn{i}")(getattr(self, f"{name}_fc{i}")(x)))
        return x

    def forward(self, pooled: torch.Tensor):
        """(B, R, G^3, 4 + C) -> (rcnn_cls (B, R), rcnn_reg (B, R, 7))."""
        b, r = pooled.shape[:2]
        x = self._stack("shared", pooled.reshape(b * r, -1))
        return (self.cls_out(self._stack("cls", x)).reshape(b, r),
                self.reg_out(self._stack("reg", x)).reshape(b, r, -1))


class PartA2(AnchorDetector):
    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg)
        self.seg_out = nn.Linear(16, 1)
        self.part_out = nn.Linear(16, 3)
        self.roi_head = PartA2FCHead(cfg.model_cfg.ROI_HEAD)

    def centres(self, pf) -> torch.Tensor:
        """(N, 3) metric centres of the stride-1 voxels."""
        return voxel_centres(pf.coords, 1.0, self.cfg.voxel_size, self.cfg.point_cloud_range,
                             pf.features.dtype)

    def part_features(self, pf, seg_logits, part_reg) -> torch.Tensor:
        """[sigmoid(part) (3), sigmoid(seg) (1), features (16)] of every
        stride-1 voxel."""
        return torch.cat([torch.sigmoid(part_reg), torch.sigmoid(seg_logits)[:, None],
                          pf.features], 1)

    def pool(self, rois: torch.Tensor, pf, feats: torch.Tensor) -> torch.Tensor:
        """rois (B, R, 7), the stride-1 tensor and its ``part_features`` ->
        (B, R, G^3, 20): per frame over that frame's valid voxels, the part
        and segmentation channels averaged and the features max-pooled in
        each grid cell."""
        g = self.roi_head.grid_size
        centres = self.centres(pf)
        out = []
        for i, ro in enumerate(rois):
            rows = pf.mask & (pf.coords[:, 0] == i)
            c, f = centres[rows], feats[rows]
            ok = torch.ones_like(c[:, 0], dtype=torch.bool)
            out.append(torch.cat([roiaware_pool3d(ro, c, f[:, :4], ok, g, "avg"),
                                  roiaware_pool3d(ro, c, f[:, 4:], ok, g, "max")], -1))
        return torch.stack(out)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """points (B, P, 3+C), points_valid (B, P) -> head_out,
        batch_cls_preds (B, A, ncls), batch_box_preds (B, A, 7),
        spatial_features_2d, roi_mask (B, R) of the proposals, seg_logits
        (V,) and part_reg (V, 3) on the stride-1 voxel rows, rcnn_cls (B,
        R), rcnn_reg (B, R, 7), ``active_voxels`` as SECONDNetIoU gives them
        and ``_voxel_tensor``, the stride-1 tensor (for ``loss``). In eval
        also roi_scores, roi_labels, rois (the refined boxes) and rcnn_iou
        (= rcnn_cls). In training, ``gt_boxes`` (B, M, 8) is required and
        the output holds ``rcnn_targets``; the sample's priorities are
        ``roi_u`` (B, R) where given, else drawn from ``generator``."""
        out = self.rpn(points, points_valid)
        bb, props = out.pop("bb"), out.pop("props")
        pf = bb["point_features"]
        feats = pf.features.to(self.seg_out.weight.dtype)
        pf = pf._replace(features=feats)
        seg_logits = self.seg_out(feats)[:, 0]
        part_reg = self.part_out(feats)
        out.update(seg_logits=seg_logits, part_reg=part_reg, _voxel_tensor=pf)
        if self.training:
            targets = self.sample_rois(props, gt_boxes, generator, roi_u)
            out["rcnn_targets"] = targets
            rois = targets["rois"]
        else:
            out.update(props)
            rois = props["rois"]
        pooled_in = self.part_features(pf, seg_logits, part_reg)
        if self.training:
            pooled_in = pooled_in.detach()
        rcnn_cls, rcnn_reg = self.roi_head(self.pool(rois[..., :7], pf, pooled_in))
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
        if not self.training:
            out.update(rois=decode_rcnn_boxes(rois[..., :7], rcnn_reg), rcnn_iou=rcnn_cls)
        return out

    def part_targets(self, pf, gt_boxes: torch.Tensor):
        """Each stride-1 voxel's foreground flag and part location: its
        centre inside a valid ground-truth box of its frame (the first by
        index), the centre's place in that box, (local / max(size, 1e-3) +
        0.5) clipped to [0, 1]."""
        centres = self.centres(pf)
        fg = torch.zeros_like(pf.mask)
        part = torch.zeros_like(centres)
        for i, gb in enumerate(gt_boxes):
            inside = points_in_boxes(centres, gb[:, :7].to(centres.dtype)) \
                & (gb.abs().sum(-1) > 0)[:, None] & (pf.coords[:, 0] == i)[None, :]
            f = inside.any(0)
            box = gb[inside.to(torch.uint8).argmax(0), :7].to(centres.dtype)
            local = rotate_points_along_z((centres - box[:, :3])[:, None], -box[:, 6])[:, 0]
            p = (local / box[:, 3:6].clamp_min(1e-3) + 0.5).clamp(0, 1)
            fg = fg | f
            part = part + p * f[:, None]
        return fg & pf.mask, part

    def loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """-> (total, the terms: rpn_loss_cls, rpn_loss_loc, rpn_loss_dir,
        rpn_loss, seg_loss (BCE over the valid voxels), part_loss (BCE of
        the part locations over the foreground voxels), rcnn_loss_cls,
        rcnn_loss_reg, rcnn_loss_corner, rcnn_loss)."""
        rpn_loss, tb = self.rpn_loss(out, gt_boxes)
        pf = out["_voxel_tensor"]
        fg, part_t = self.part_targets(pf, gt_boxes)
        dt = out["seg_logits"].dtype
        valid = pf.mask.to(dt)
        seg = binary_cross_entropy_with_logits(out["seg_logits"], fg.to(dt))
        seg_loss = (seg * valid).sum() / global_count(valid.sum()).clamp_min(1.0)
        part_bce = binary_cross_entropy_with_logits(out["part_reg"], part_t.to(dt))
        part_loss = (part_bce.sum(-1) * fg.to(dt)).sum() \
            / global_count(fg.sum()).to(dt).clamp_min(1.0)
        tb.update(seg_loss=seg_loss, part_loss=part_loss)
        rcnn_loss, rtb = pvrcnn_rcnn_loss(out["rcnn_cls"], out["rcnn_reg"],
                                          out["rcnn_targets"],
                                          self.cfg.model_cfg.ROI_HEAD.LOSS_CONFIG)
        tb.update(rtb)
        return rpn_loss + seg_loss + part_loss + rcnn_loss, tb
