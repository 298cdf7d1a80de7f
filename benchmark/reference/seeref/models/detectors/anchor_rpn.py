"""What the voxel anchor detectors share: the configuration read from a
pcdet config, and the RPN (MeanVFE as the voxel mean, the 3D backbone,
HeightCompression, BaseBEVBackbone, the anchor head and its loss), the
proposal NMS and, in training, the RoI sample against the ground truth."""
from __future__ import annotations

import torch
from torch import nn

from ...ops import sparse as SP
from ...ops.voxelize import grid_size as compute_grid_size
from ...ops.voxelize import voxelize_batch
from ..modules.backbone2d import BaseBEVBackbone
from ..modules.backbone3d import VoxelBackBone8x
from ..modules.dense_heads import AnchorHeadLogic, build_anchor_head
from ..modules.map_to_bev import height_compression
from ..modules.roi_heads import proposal_layer, sample_rois_for_rcnn


class DetectorConfig:
    """The static configuration of a pcdet config's MODEL and DATA_CONFIG;
    the voxel cap is MAX_NUMBER_OF_VOXELS' test value unless ``max_voxels``
    is given."""

    def __init__(self, model_cfg, data_cfg, class_names, max_voxels=None):
        self.model_cfg = model_cfg
        self.class_names = list(class_names)
        self.num_class = len(self.class_names)
        self.point_cloud_range = [float(v) for v in data_cfg.POINT_CLOUD_RANGE]
        vox = [p for p in data_cfg.DATA_PROCESSOR if p.NAME == "transform_points_to_voxels"][0]
        self.voxel_size = [float(v) for v in vox.VOXEL_SIZE]
        mv = vox.MAX_NUMBER_OF_VOXELS
        self.max_voxels = int(max_voxels or (mv["test"] if isinstance(mv, dict) else mv))
        self.max_points_per_voxel = int(vox.get("MAX_POINTS_PER_VOXEL", 5))
        self.grid_size = compute_grid_size(self.point_cloud_range, self.voxel_size)
        feat_cfg = data_cfg.get("POINT_FEATURE_ENCODING", None)
        self.num_point_features = len(feat_cfg.used_feature_list) if feat_cfg else 4
        self.head_logic = AnchorHeadLogic(model_cfg.DENSE_HEAD, self.num_class,
                                          self.class_names, self.grid_size,
                                          self.point_cloud_range)

    @property
    def sparse_shape(self) -> tuple:
        """(nz + 1, ny, nx): the backbone's grid, one z level more than the
        voxel grid, as OpenPCDet's."""
        g = self.grid_size
        return (int(g[2]) + 1, int(g[1]), int(g[0]))


class AnchorDetector(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        bb = cfg.model_cfg.BACKBONE_3D
        if bb.get("NAME", "VoxelBackBone8x") != "VoxelBackBone8x":
            raise NotImplementedError(f"BACKBONE_3D {bb.NAME}")
        self.backbone_3d = VoxelBackBone8x(cfg.num_point_features,
                                           dtype=bb.get("DTYPE", "float32"))
        nz = self.backbone_3d.encoded_shape(cfg.sparse_shape)[0]
        b2 = cfg.model_cfg.BACKBONE_2D
        self.backbone_2d = BaseBEVBackbone(
            128 * nz, b2.LAYER_NUMS, b2.LAYER_STRIDES, b2.NUM_FILTERS,
            b2.get("UPSAMPLE_STRIDES", ()), b2.get("NUM_UPSAMPLE_FILTERS", ()),
            dtype=b2.get("DTYPE", None))
        self.dense_head = build_anchor_head(
            cfg.model_cfg.DENSE_HEAD, cfg.head_logic, self.backbone_2d.num_bev_features,
            cfg.num_class, cfg.class_names)

    def dense(self, points: torch.Tensor, points_valid: torch.Tensor) -> dict:
        """points (B, P, 3+C) -> head_out, batch_cls_preds (B, A, ncls),
        batch_box_preds (B, A, 7), spatial_features_2d (B, H, W, C)."""
        cfg = self.cfg
        feats, coords, mask = voxelize_batch(
            points, points_valid, point_cloud_range=cfg.point_cloud_range,
            voxel_size=cfg.voxel_size, max_voxels=cfg.max_voxels,
            max_points_per_voxel=cfg.max_points_per_voxel)
        st = SP.make_sparse_tensor(feats, coords, mask, cfg.sparse_shape, points.shape[0])
        bev = height_compression(self.backbone_3d(st)["encoded_spconv_tensor"])
        bev2d = self.backbone_2d(bev.to(next(self.dense_head.parameters()).dtype))
        head_out = self.dense_head(bev2d)
        cls_preds, box_preds = cfg.head_logic.predict_boxes(head_out)
        return {"head_out": head_out, "batch_cls_preds": cls_preds,
                "batch_box_preds": box_preds, "spatial_features_2d": bev2d}

    def rpn(self, points: torch.Tensor, points_valid: torch.Tensor) -> dict:
        """``dense``'s dict with the proposals ``props`` and their
        ``roi_mask``."""
        out = self.dense(points, points_valid)
        rcfg = self.cfg.model_cfg.ROI_HEAD
        props = proposal_layer(out["batch_cls_preds"], out["batch_box_preds"],
                               rcfg.NMS_CONFIG["TRAIN" if self.training else "TEST"])
        out.update(roi_mask=props["roi_mask"], props=props)
        return out

    def rpn_loss(self, out: dict, gt_boxes: torch.Tensor):
        logic = self.cfg.head_logic
        return logic.loss(out["head_out"], logic.assign_targets(gt_boxes))

    def sample_rois(self, props: dict, gt_boxes, generator=None, roi_u=None) -> dict:
        """Each frame's RoI sample against gt_boxes (B, M, 8) by the
        priorities ``roi_u`` (B, R), drawn from ``generator`` where not
        given."""
        if roi_u is None:
            roi_u = torch.rand(props["rois"].shape[:2], generator=generator,
                               device=gt_boxes.device)
        tcfg = self.cfg.model_cfg.ROI_HEAD.TARGET_CONFIG
        per = [sample_rois_for_rcnn(*a, tcfg) for a in zip(
            roi_u.to(gt_boxes.device), props["rois"], props["roi_labels"],
            props["roi_scores"], props["roi_mask"], gt_boxes)]
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}
