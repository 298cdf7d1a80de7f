"""PV-RCNN and PV-RCNN++: forward and training loss (port of PVRCNN and
PVRCNNPlusPlus of seevcn_tpu/models/detectors/pvrcnn.py; reference
pv_rcnn.py, pv_rcnn_plusplus.py and tools/cfgs/kitti_models/pv_rcnn.yaml).

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

PV-RCNN++ has the same modules and loss but takes its proposals (in
training, its RoI sample) first: under SAMPLE_METHOD SPC the VSA samples its
keypoints near them (sector FPS); under FPS the keypoints, and the raw-point
supports, are the points inside the RoIs grown by 2 ROI_NEIGHBOR_RADIUS,
every RoI row counted as the JAX package counts them.
"""
from __future__ import annotations

import torch

from ...geom.boxes import points_in_boxes
from ...parallel.mesh import global_batch
from ..modules.pfe import VoxelSetAbstraction
from ..modules.pvrcnn_head import (PVRCNNHead, PointHeadSimple, decode_rcnn_boxes,
                                   point_head_loss, pvrcnn_rcnn_loss)
from .second import AnchorDetector, DetectorConfig

#: the BEV map's stride over the voxel grid (BaseBEVBackbone returns to the
#: stride-8 map of HeightCompression)
BEV_STRIDE = 8


def jax_stage_width(cfg: DetectorConfig, batch: int) -> int:
    """The support width of the JAX package's SA layers over a backbone
    stage: the row count of the stage tensor its VSA reads. In
    BACKBONE_3D.MODE sparse that is the voxeliser's B x max_voxels rows (its
    convs keep the input's row count); in the default modes ``SP.as_sparse``
    extracts into round(those rows x EXTRACT_CAPACITY_MULT) (JAX's
    pvrcnn.py:57-61)."""
    bb = cfg.model_cfg.BACKBONE_3D
    rows = batch * cfg.max_voxels
    if bb.get("MODE", "hybrid") == "sparse":
        return rows
    return int(round(rows * float(bb.get("EXTRACT_CAPACITY_MULT", 1.5))))


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
        vsa = self.keypoint_features(out, points, points_valid, bb)
        if self.training:
            targets = self.sample_rois(props, gt_boxes, generator, roi_u)
            out["rcnn_targets"] = targets
            rois = targets["rois"]
        else:
            out.update(props)
            rois = props["rois"]
        return self.refine(out, vsa, rois, generator)

    def keypoint_features(self, out: dict, points, points_valid, bb, rois=None,
                          roi_mask=None) -> dict:
        """The VSA and the point head: -> the VSA's output; the point logits
        and the keypoints go into ``out``."""
        vsa = self.pfe(points, points_valid, out["spatial_features_2d"], BEV_STRIDE,
                       bb["multi_scale_3d_features"],
                       jax_stage_width(self.cfg, global_batch(points.shape[0])), rois,
                       roi_mask)
        point_logits = self.point_head(
            vsa["point_features_before_fusion"] if self.before_fusion
            else vsa["point_features"])
        out.update(point_logits=point_logits, keypoints=vsa["keypoints"])
        return vsa

    def refine(self, out: dict, vsa: dict, rois, generator=None) -> dict:
        """The RoI-grid head on ``rois`` (B, R, 7+); in eval the refined
        boxes become ``rois``."""
        rcnn_cls, rcnn_reg = self.roi_head(
            rois[..., :7], vsa["keypoints"].detach(), vsa["point_features"],
            torch.sigmoid(out["point_logits"]), generator)
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


class PVRCNNPlusPlus(PVRCNN):
    """PV-RCNN++ (pv_rcnn_plusplus.py, the JAX package's PVRCNNPlusPlus):
    PV-RCNN's modules with the proposals taken before the keypoints."""

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """As ``PVRCNN.forward``, in PV-RCNN++'s order: the RPN, the
        proposals (in training the RoI sample, drawn first), then the
        keypoints, the VSA, the point head and the RoI head. Under SPC the
        VSA samples near ``rois`` with the proposals' ``roi_mask`` in eval
        and the sample's ``roi_sample_mask`` in training; under FPS the
        keypoint candidates and the raw-point supports are
        ``roi_neighbourhood``'s."""
        out = self.rpn(points, points_valid)
        bb, props = out.pop("bb"), out.pop("props")
        if self.training:
            targets = self.sample_rois(props, gt_boxes, generator, roi_u)
            out["rcnn_targets"] = targets
            rois, roi_mask = targets["rois"], targets["roi_sample_mask"]
        else:
            out.update(props)
            rois, roi_mask = props["rois"], props["roi_mask"]
        if self.pfe.sample_method == "SPC":
            vsa = self.keypoint_features(out, points, points_valid, bb,
                                         rois[..., :7], roi_mask)
        else:
            vsa = self.keypoint_features(out, points,
                                         self.roi_neighbourhood(points, points_valid, rois),
                                         bb)
        return self.refine(out, vsa, rois, generator)

    @torch.no_grad()
    def roi_neighbourhood(self, points, points_valid, rois) -> torch.Tensor:
        """FPS mode's keypoint candidates, (B, P) bool: the valid points
        inside any RoI row grown by 2 ROI_NEIGHBOR_RADIUS in each size (every
        row, masked or not, as the JAX package tests them), or all valid
        points of a frame where none is."""
        radius = float(self.cfg.model_cfg.PFE.get("ROI_NEIGHBOR_RADIUS", 2.4))
        big = rois[..., :7].clone()
        big[..., 3:6] += 2 * radius
        near = torch.stack([v & points_in_boxes(p[:, :3], r).any(0)
                            for p, v, r in zip(points, points_valid, big)])
        return torch.where(near.any(1, keepdim=True), near, points_valid)
