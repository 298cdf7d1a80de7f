"""SECOND-IoU (SEE-VCN's second_net_iou.py): the anchor RPN, the proposal
NMS, the rotated BEV RoI-grid pool and SECONDHead's IoU. In training the
proposals come from NMS_CONFIG.TRAIN, the RoI sample is drawn against the
ground truth, the pooled features are detached, and ``loss`` adds the RPN's
losses to the IoU head's."""
from __future__ import annotations

import torch

from ..modules.roi_heads import SECONDHead, rcnn_iou_loss, roi_grid_pool_bev
from .anchor_rpn import AnchorDetector


class SECONDNetIoU(AnchorDetector):
    """SECOND + IoU rcnn head: the rotated BEV RoI-grid pool -> SECONDHead."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__(cfg)
        r = cfg.model_cfg.ROI_HEAD
        self.roi_head = SECONDHead(
            self.backbone_2d.num_bev_features, int(r.ROI_GRID_POOL.GRID_SIZE),
            tuple(r.SHARED_FC), tuple(r.IOU_FC), float(r.DP_RATIO))

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """points (B, P, 3+C), points_valid (B, P) -> the reference's dict:
        head_out, batch_cls_preds (B, A, ncls), batch_box_preds (B, A, 7),
        spatial_features_2d, roi_mask (B, R) of the proposals, rcnn_iou; and
        ``active_voxels``, the active count of the backbone's input and of
        each stage's output. In eval also rois (B, R, 7), roi_scores,
        roi_labels. In training, ``gt_boxes`` (B, M, 8) (zero rows padding)
        is required and the output holds ``rcnn_targets``, the RoI sample
        that rcnn_iou scores. The sample's random priorities are ``roi_u``
        (B, R) where given, else drawn from ``generator``, which also draws
        the dropout masks."""
        out = self.rpn(points, points_valid)
        props = out.pop("props")
        rcfg = self.cfg.model_cfg.ROI_HEAD
        if self.training:
            targets = self.sample_rois(props, gt_boxes, generator, roi_u)
            out["rcnn_targets"] = targets
            rois = targets["rois"]
        else:
            out.update(props)
            rois = props["rois"]
        pooled = roi_grid_pool_bev(
            out["spatial_features_2d"], rois[..., :7],
            int(rcfg.ROI_GRID_POOL.GRID_SIZE), self.cfg.point_cloud_range,
            self.cfg.voxel_size, int(rcfg.ROI_GRID_POOL.DOWNSAMPLE_RATIO))
        if self.training:
            # the reference detaches the BEV features for the rcnn head
            pooled = pooled.detach()
        out["rcnn_iou"] = self.roi_head(pooled, generator)
        return out

    def loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The training loss of a training forward's output: the RPN's
        (assignment against gt_boxes) plus the IoU head's. -> (total, the
        terms: rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss,
        rcnn_loss_iou)."""
        rpn_loss, tb = self.rpn_loss(out, gt_boxes)
        lcfg = self.cfg.model_cfg.ROI_HEAD.LOSS_CONFIG
        rcnn = rcnn_iou_loss(out["rcnn_iou"], out["rcnn_targets"]["rcnn_cls_labels"],
                             loss_type=lcfg.IOU_LOSS,
                             weight=float(lcfg.LOSS_WEIGHTS["rcnn_iou_weight"]))
        tb["rcnn_loss_iou"] = rcnn
        return rpn_loss + rcnn, tb


Detector = SECONDNetIoU
