"""PV-RCNN: forward and training loss (port of PVRCNN of
seevcn_tpu/models/detectors/pvrcnn.py; reference pv_rcnn.py and
tools/cfgs/kitti_models/pv_rcnn.yaml).

MeanVFE -> VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone ->
AnchorHeadSingle (the RPN, shared with SECOND-IoU: ``AnchorDetector``) and
VoxelSetAbstraction (keypoints) -> PointHeadSimple -> PVRCNNHead (RoI-grid
pooling over the keypoints, box refinement). The keypoint set abstraction
reads every active voxel of each backbone stage: the port's strided convs
keep them all, so no extraction capacity is needed. In eval the output's
``rois`` are the refined boxes and ``rcnn_iou`` the class logit, which
``post_processing``'s ``iou`` branch reads. In training the RoI sample is
drawn as SECOND-IoU's is, the keypoints carry no gradient, and ``loss``
adds the RPN's, the point head's and the RCNN's losses.
"""
from __future__ import annotations

import torch

from ..modules.pfe import VoxelSetAbstraction
from ..modules.pvrcnn_head import (PVRCNNHead, PointHeadSimple, decode_rcnn_boxes,
                                   point_head_loss, pvrcnn_rcnn_loss)
from .second import AnchorDetector, DetectorConfig

#: the BEV map's stride over the voxel grid (BaseBEVBackbone returns to the
#: stride-8 map of HeightCompression)
BEV_STRIDE = 8


class PVRCNN(AnchorDetector):
    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg)
        mcfg = cfg.model_cfg
        self.pfe = VoxelSetAbstraction(
            mcfg.PFE, cfg.point_cloud_range, cfg.voxel_size,
            self.backbone_2d.num_bev_features, cfg.num_point_features)
        ph = mcfg.POINT_HEAD
        self.before_fusion = bool(ph.get("USE_POINT_FEATURES_BEFORE_FUSION", False))
        self.point_head = PointHeadSimple(
            self.pfe.num_point_features_before_fusion if self.before_fusion
            else self.pfe.num_point_features, tuple(ph.CLS_FC))
        self.roi_head = PVRCNNHead(self.pfe.num_point_features, mcfg.ROI_HEAD)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """points (B, P, 3+C), points_valid (B, P) -> the reference's dict:
        head_out, batch_cls_preds (B, A, ncls), batch_box_preds (B, A, 7),
        spatial_features_2d, point_logits (B, K), keypoints (B, K, 3),
        roi_mask (B, R) of the proposals, rcnn_cls (B, R), rcnn_reg (B, R,
        7), ``active_voxels`` as SECONDNetIoU gives them. In eval also
        roi_scores, roi_labels, rois and batch_box_preds_refined (B, R, 7),
        the refined boxes, and rcnn_iou (= rcnn_cls). In training,
        ``gt_boxes`` (B, M, 8) is required and the output holds
        ``rcnn_targets``; the sample's priorities are ``roi_u`` (B, R) where
        given, else drawn from ``generator``, which also draws the dropout
        masks."""
        out = self.rpn(points, points_valid)
        bb, props = out.pop("bb"), out.pop("props")
        vsa = self.pfe(points, points_valid, out["spatial_features_2d"], BEV_STRIDE,
                       bb["multi_scale_3d_features"])
        point_logits = self.point_head(
            vsa["point_features_before_fusion"] if self.before_fusion
            else vsa["point_features"])
        out.update(point_logits=point_logits, keypoints=vsa["keypoints"])
        if self.training:
            targets = self.sample_rois(props, gt_boxes, generator, roi_u)
            out["rcnn_targets"] = targets
            rois = targets["rois"]
        else:
            out.update(props)
            rois = props["rois"]
        rcnn_cls, rcnn_reg = self.roi_head(
            rois[..., :7], vsa["keypoints"].detach(), vsa["point_features"],
            torch.sigmoid(point_logits), generator)
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
        if not self.training:
            refined = decode_rcnn_boxes(rois[..., :7], rcnn_reg)
            out.update(batch_box_preds_refined=refined, rois=refined,
                       rcnn_iou=rcnn_cls)
        return out

    def loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The training loss of a training forward's output -> (total, the
        terms: rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss,
        point_loss_cls, rcnn_loss_cls, rcnn_loss_reg, rcnn_loss_corner,
        rcnn_loss)."""
        mcfg = self.cfg.model_cfg
        rpn_loss, tb = self.rpn_loss(out, gt_boxes)
        ph = mcfg.POINT_HEAD
        pt_loss = point_head_loss(
            out["point_logits"], out["keypoints"], gt_boxes,
            gt_boxes.abs().sum(-1) > 0,
            tuple(ph.TARGET_CONFIG.get("GT_EXTRA_WIDTH", [0.2, 0.2, 0.2]))) \
            * float(ph.LOSS_CONFIG.LOSS_WEIGHTS.get("point_cls_weight", 1.0))
        tb["point_loss_cls"] = pt_loss
        rcnn_loss, rtb = pvrcnn_rcnn_loss(out["rcnn_cls"], out["rcnn_reg"],
                                          out["rcnn_targets"],
                                          mcfg.ROI_HEAD.LOSS_CONFIG)
        tb.update(rtb)
        return rpn_loss + pt_loss + rcnn_loss, tb
