"""CenterPoint: forward and training loss (port of CenterPoint of
seevcn_tpu/models/detectors/centerpoint.py; reference centerpoint.py and
tools/cfgs/waymo_models/centerpoint.yaml).

MeanVFE (the voxeliser's mean) -> VoxelBackBone8x or VoxelResBackBone8x
(BACKBONE_3D.MODE names a TPU lowering and is not read) ->
HeightCompression -> BaseBEVBackbone -> ``CenterHead`` at stride 8. In
eval the heatmap's peaks are decoded (``decode_center_boxes``, k =
POST_PROCESSING.MAX_OBJ_PER_SAMPLE): ``batch_box_preds`` (B, k, 7),
``batch_cls_preds`` (B, k, 1) the peaks' probabilities and
``batch_pred_labels`` (B, k) their classes, which ``post_processing``'s
dense branch reads as they are. The loss is the heatmap's focal loss and
the centre pixels' L1, weighted by LOSS_WEIGHTS cls_weight and loc_weight.
State-dict keys: OpenPCDet's ``backbone_3d`` and ``backbone_2d``, and the
JAX package's module names under ``dense_head`` (``center_head.py``).
"""
from __future__ import annotations

import torch

from ..modules.center_head import CenterHead, center_head_loss, decode_center_boxes
from ..modules.map_to_bev import height_compression
from .second import AnchorDetector, _bev_backbone

#: the head's stride over the voxel grid, fixed as in the JAX package
STRIDE = 8


class CenterPoint(AnchorDetector):
    """The voxel backbone of ``AnchorDetector`` with a center head in place
    of the anchor head."""

    def _init_head(self, cfg, bev_channels: int) -> None:
        self.backbone_2d = _bev_backbone(cfg.model_cfg.BACKBONE_2D, bev_channels)
        self.dense_head = CenterHead(self.backbone_2d.num_bev_features, cfg.num_class)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """points (B, P, 3+C), points_valid (B, P) -> head_out (the head's
        maps), spatial_features_2d and ``active_voxels`` (the active count
        of the backbone's input and of each stage's output); in eval also
        batch_box_preds, batch_cls_preds and batch_pred_labels. The same in
        training (the ground truth reaches only ``loss``; ``generator`` and
        ``roi_u`` are not used: this detector draws nothing)."""
        st, bb = self.voxel_backbone(points, points_valid)
        enc = bb["encoded_spconv_tensor"]
        bev2d = self.backbone_2d(height_compression(enc).to(
            self.dense_head.shared_conv.weight.dtype))
        head_out = self.dense_head(bev2d)
        stages = [st] + [bb["multi_scale_3d_features"][f"x_conv{i}"]
                         for i in range(1, 5)] + [enc]
        out = {"head_out": head_out, "spatial_features_2d": bev2d,
               "active_voxels": torch.stack([s.mask.sum() for s in stages])}
        if not self.training:
            out.update(self.decode(head_out))
        return out

    def decode(self, head_out: dict) -> dict:
        """The eval outputs from the head's maps: batch_box_preds (B, k, 7),
        batch_cls_preds (B, k, 1) (probabilities) and batch_pred_labels (B,
        k)."""
        cfg = self.cfg
        post = cfg.model_cfg.get("POST_PROCESSING", {})
        boxes, scores, labels = decode_center_boxes(
            head_out, cfg.point_cloud_range, cfg.voxel_size, STRIDE,
            k=int(post.get("MAX_OBJ_PER_SAMPLE", 500)))
        return {"batch_box_preds": boxes, "batch_cls_preds": scores[..., None],
                "batch_pred_labels": labels}

    def loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """-> (total, terms hm_loss, loc_loss and rpn_loss, the total)."""
        cfg = self.cfg
        grid_hw = (int(cfg.grid_size[1]) // STRIDE, int(cfg.grid_size[0]) // STRIDE)
        hm_loss, reg_loss = center_head_loss(
            out["head_out"], gt_boxes, gt_boxes.abs().sum(-1) > 0, grid_hw,
            cfg.point_cloud_range, cfg.voxel_size, STRIDE, cfg.num_class)
        w = cfg.model_cfg.DENSE_HEAD.get("LOSS_CONFIG", {}).get(
            "LOSS_WEIGHTS", {"cls_weight": 1.0, "loc_weight": 2.0})
        total = hm_loss * float(w.get("cls_weight", 1.0)) \
            + reg_loss * float(w.get("loc_weight", 2.0))
        return total, {"hm_loss": hm_loss, "loc_loss": reg_loss, "rpn_loss": total}
