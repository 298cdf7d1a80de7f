"""SECOND-IoU: forward, training loss and post-processing (port of
SECONDNetIoU, post_processing and build_detector of
seevcn_tpu/models/detectors/second.py; reference second_net_iou.py).

MeanVFE (the voxeliser's mean) -> VoxelBackBone8x -> HeightCompression ->
BaseBEVBackbone -> AnchorHeadSingle -> proposal NMS -> rotated BEV RoI-grid
pool -> SECONDHead IoU; then ``post_processing``, the final NMS. In training
(``model.train()``) the proposals come from NMS_CONFIG.TRAIN, the RoI
sampler picks ROI_PER_IMAGE of them against the ground truth, the pooled
features are detached, and ``loss`` adds the RPN's losses to the IoU head's.
Inputs are fixed-capacity padded points (B, P, 3) with a validity mask,
outputs the reference's fixed-shape dicts. State-dict keys are OpenPCDet's.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import resolve_device
from ...ops import sparse as SP
from ...ops.nms import nms_bev
from ...ops.voxelize import grid_size as compute_grid_size
from ...ops.voxelize import voxelize_batch
from ..modules.backbone2d import BaseBEVBackbone
from ..modules.backbone3d import VoxelBackBone8x
from ..modules.dense_heads import AnchorHeadLogic, AnchorHeadSingle
from ..modules.map_to_bev import height_compression
from ..modules.roi_heads import (SECONDHead, proposal_layer, rcnn_iou_loss,
                                 roi_grid_pool_bev, sample_rois_for_rcnn, uniform)


class DetectorConfig:
    """Static detector configuration derived from a reference pcdet config
    (MODEL + DATA_CONFIG blocks). The voxel cap is MAX_NUMBER_OF_VOXELS'
    test value unless ``max_voxels`` is given (its train value, to train)."""

    def __init__(self, model_cfg, data_cfg, class_names, max_voxels=None):
        self.model_cfg = model_cfg
        self.class_names = list(class_names)
        self.num_class = len(self.class_names)
        self.point_cloud_range = [float(v) for v in data_cfg.POINT_CLOUD_RANGE]
        vox = [p for p in data_cfg.DATA_PROCESSOR
               if p.NAME == "transform_points_to_voxels"][0]
        self.voxel_size = [float(v) for v in vox.VOXEL_SIZE]
        mv = vox.get("MAX_NUMBER_OF_VOXELS", 60000)
        self.max_voxels = int(max_voxels or (mv["test"] if isinstance(mv, dict) else mv))
        self.max_points_per_voxel = int(vox.get("MAX_POINTS_PER_VOXEL", 5))
        self.grid_size = compute_grid_size(self.point_cloud_range, self.voxel_size)
        feat_cfg = data_cfg.get("POINT_FEATURE_ENCODING", None)
        self.num_point_features = len(feat_cfg.used_feature_list) if feat_cfg else 4
        self.head_logic = AnchorHeadLogic(
            model_cfg.DENSE_HEAD, self.num_class, self.class_names,
            self.grid_size, self.point_cloud_range)

    @property
    def sparse_shape(self) -> tuple:
        """(nz + 1, ny, nx): the backbone's grid, one z level more than the
        voxel grid, as in the reference."""
        g = self.grid_size
        return (int(g[2]) + 1, int(g[1]), int(g[0]))


class SECONDNetIoU(nn.Module):
    """SECOND + IoU rcnn head."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        mcfg = cfg.model_cfg
        bb = mcfg.BACKBONE_3D
        if bb.NAME != "VoxelBackBone8x":
            raise NotImplementedError(f"BACKBONE_3D {bb.NAME}")
        # MODE names a TPU lowering of the same math; the port has one
        self.backbone_3d = VoxelBackBone8x(cfg.num_point_features,
                                           dtype=bb.get("DTYPE", "float32"))
        nz = VoxelBackBone8x.encoded_shape(cfg.sparse_shape)[0]
        b2 = mcfg.BACKBONE_2D
        if b2.get("DTYPE", None) is not None:
            raise NotImplementedError("BACKBONE_2D.DTYPE")
        self.backbone_2d = BaseBEVBackbone(
            128 * nz, b2.LAYER_NUMS, b2.LAYER_STRIDES, b2.NUM_FILTERS,
            b2.get("UPSAMPLE_STRIDES", ()), b2.get("NUM_UPSAMPLE_FILTERS", ()))
        dh = mcfg.DENSE_HEAD
        if dh.get("NAME", "AnchorHeadSingle") != "AnchorHeadSingle":
            raise NotImplementedError(f"DENSE_HEAD {dh.NAME}")
        logic = cfg.head_logic
        self.dense_head = AnchorHeadSingle(
            self.backbone_2d.num_bev_features, cfg.num_class,
            logic.num_anchors_per_location, logic.box_coder.code_size,
            logic.num_dir_bins)
        r = mcfg.ROI_HEAD
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
        cfg = self.cfg
        feats, coords, mask = voxelize_batch(
            points, points_valid, point_cloud_range=cfg.point_cloud_range,
            voxel_size=cfg.voxel_size, max_voxels=cfg.max_voxels,
            max_points_per_voxel=cfg.max_points_per_voxel)
        st = SP.make_sparse_tensor(feats, coords, mask, cfg.sparse_shape,
                                   points.shape[0])
        bb = self.backbone_3d(st)
        enc = bb["encoded_spconv_tensor"]
        # a bf16 backbone hands a bf16 BEV over; the 2D convs run in f32
        bev = height_compression(enc).float()
        bev2d = self.backbone_2d(bev)
        head_out = self.dense_head(bev2d)
        cls_preds, box_preds = cfg.head_logic.predict_boxes(head_out)
        rcfg = cfg.model_cfg.ROI_HEAD
        props = proposal_layer(cls_preds, box_preds,
                               rcfg.NMS_CONFIG["TRAIN" if self.training else "TEST"])
        stages = [st] + [bb["multi_scale_3d_features"][f"x_conv{i}"]
                         for i in range(1, 5)] + [enc]
        out = {"head_out": head_out, "batch_cls_preds": cls_preds,
               "batch_box_preds": box_preds, "spatial_features_2d": bev2d,
               "roi_mask": props["roi_mask"],
               "active_voxels": torch.stack([s.mask.sum() for s in stages])}
        if self.training:
            if gt_boxes is None:
                raise ValueError("training needs gt_boxes")
            if roi_u is None:
                roi_u = uniform(props["rois"].shape[:2], generator, points.device)
            roi_u = roi_u.to(points.device)
            per = [sample_rois_for_rcnn(*a, rcfg.TARGET_CONFIG) for a in zip(
                roi_u, props["rois"], props["roi_labels"], props["roi_scores"],
                props["roi_mask"], gt_boxes)]
            targets = {k: torch.stack([p[k] for p in per]) for k in per[0]}
            out["rcnn_targets"] = targets
            rois = targets["rois"]
        else:
            out.update(props)
            rois = props["rois"]
        pooled = roi_grid_pool_bev(
            bev2d, rois[..., :7], int(rcfg.ROI_GRID_POOL.GRID_SIZE),
            cfg.point_cloud_range, cfg.voxel_size,
            int(rcfg.ROI_GRID_POOL.DOWNSAMPLE_RATIO))
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
        logic = self.cfg.head_logic
        rpn_loss, tb = logic.loss(out["head_out"], logic.assign_targets(gt_boxes))
        lcfg = self.cfg.model_cfg.ROI_HEAD.LOSS_CONFIG
        rcnn = rcnn_iou_loss(out["rcnn_iou"], out["rcnn_targets"]["rcnn_cls_labels"],
                             loss_type=lcfg.IOU_LOSS,
                             weight=float(lcfg.LOSS_WEIGHTS["rcnn_iou_weight"]))
        tb["rcnn_loss_iou"] = rcnn
        return rpn_loss + rcnn, tb


def post_processing(out: dict, post_cfg, num_class: int, has_roi_head: bool) -> dict:
    """The final NMS: per frame, pred_boxes (B, N, 7), pred_scores (B, N),
    pred_labels (B, N) int32, pred_mask (B, N). Ported: the rcnn branch with
    the ``iou`` score type, the flagship's."""
    nms_cfg = post_cfg.NMS_CONFIG
    score_type = nms_cfg.get("SCORE_TYPE", "iou")
    if not has_roi_head or score_type not in (None, "iou"):
        raise NotImplementedError(
            "post_processing is ported for the rcnn head with SCORE_TYPE iou")
    score_thresh = post_cfg.get("SCORE_THRESH", 0.1)
    if isinstance(score_thresh, (list, tuple)):
        raise NotImplementedError("per-class SCORE_THRESH")
    scores = torch.sigmoid(out["rcnn_iou"])
    res = {"pred_boxes": [], "pred_scores": [], "pred_labels": [], "pred_mask": []}
    for bx, sc, lb, vd in zip(out["rois"], scores, out["roi_labels"],
                              out["roi_mask"]):
        idx, keep, _ = nms_bev(bx[:, :7], sc, thresh=float(nms_cfg.NMS_THRESH),
                               pre_maxsize=int(nms_cfg.NMS_PRE_MAXSIZE),
                               post_maxsize=int(nms_cfg.NMS_POST_MAXSIZE),
                               score_thresh=float(score_thresh), valid_mask=vd)
        res["pred_boxes"].append(torch.where(keep[:, None], bx[idx], 0.0))
        res["pred_scores"].append(torch.where(keep, sc[idx], 0.0))
        res["pred_labels"].append(torch.where(keep, lb[idx], 0).to(torch.int32))
        res["pred_mask"].append(keep)
    return {k: torch.stack(v) for k, v in res.items()}


def build_detector(cfg, state_dict: dict | None = None, *, max_voxels=None,
                   device="cuda"):
    """cfg: a full pcdet config (MODEL / DATA_CONFIG / CLASS_NAMES) naming
    SECONDNetIoU -> (model in eval mode on ``device``, DetectorConfig). A
    given state dict (reference key names) is loaded with strict=True;
    ``max_voxels`` overrides the voxel cap (DetectorConfig)."""
    dev = resolve_device(device)
    if cfg.MODEL.NAME != "SECONDNetIoU":
        raise NotImplementedError(f"detector {cfg.MODEL.NAME}")
    dcfg = DetectorConfig(cfg.MODEL, cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                          max_voxels=max_voxels)
    model = SECONDNetIoU(dcfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval(), dcfg
