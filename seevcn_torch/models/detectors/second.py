"""SECOND-IoU, SECONDNet and PointPillar: forward, training loss and
post-processing (port of SECONDNetIoU, SECONDNet, PointPillar,
focal_importance_loss, post_processing and build_detector of
seevcn_tpu/models/detectors/second.py; reference second_net_iou.py,
second_net.py, pointpillar.py), and ``AnchorDetector``, the RPN that
PV-RCNN, PV-RCNN++ (``pvrcnn.py``), Voxel R-CNN (``voxelrcnn.py``) and
Part-A2 (``parta2.py``) share with SECOND-IoU and SECONDNet, and whose voxel
backbone CenterPoint (``centerpoint.py``) runs under its own head.
PointRCNN (``pointrcnn.py``) runs on the points, with no voxels.

SECOND-IoU: MeanVFE (the voxeliser's mean) -> VoxelBackBone8x ->
HeightCompression -> BaseBEVBackbone -> AnchorHeadSingle -> proposal NMS ->
rotated BEV RoI-grid pool -> SECONDHead IoU; then ``post_processing``, the
final NMS. In training (``model.train()``) the proposals come from
NMS_CONFIG.TRAIN, the RoI sampler picks ROI_PER_IMAGE of them against the
ground truth, the pooled features are detached, and ``loss`` adds the RPN's
losses to the IoU head's. SECONDNet stops after the dense head, with any of
the three 3D backbones (``backbone3d.BACKBONES``) and AnchorHeadSingle or
AnchorHeadMulti; its loss is the RPN's, plus the focal backbone's
importance loss. PointPillar: per-frame pillars (every point of a pillar
averaged) -> DynamicPillarVFE -> ``pillar_scatter`` -> BaseBEVBackbone ->
the anchor head. Inputs are fixed-capacity padded points (B, P, 3) with a
validity mask, outputs the reference's fixed-shape dicts. State-dict keys
are OpenPCDet's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ... import resolve_device
from ...geom.boxes import points_in_boxes, points_in_boxes_count
from ...ops import sparse as SP
from ...ops.nms import nms_bev
from ...ops.voxelize import grid_size as compute_grid_size
from ...ops.voxelize import voxelize, voxelize_batch
from ...parallel.mesh import global_count
from ...parallel.spatial import gather_w, scatter_w, w_sharded
from ..modules.backbone2d import BaseBEVBackbone
from ..modules.unet3d import BACKBONES  # VoxelBackBone8x and the rest, and UNetV2
from ..modules.dense_heads import AnchorHeadLogic, build_anchor_head
from ..modules.map_to_bev import height_compression, pillar_scatter
from ..modules.roi_heads import (SECONDHead, proposal_layer, rcnn_iou_loss,
                                 roi_grid_pool_bev, sample_rois_for_rcnn, uniform)
from ..modules.vfe import DynamicPillarVFE


class DetectorConfig:
    """Static detector configuration derived from a reference pcdet config
    (MODEL + DATA_CONFIG blocks). The voxel cap is MAX_NUMBER_OF_VOXELS'
    test value unless ``max_voxels`` is given (its train value, to train).
    A point-based config (PointRCNN's) has no voxel block and no dense
    head: its voxel fields are None and it carries no anchors, as a center
    head carries none."""

    def __init__(self, model_cfg, data_cfg, class_names, max_voxels=None):
        self.model_cfg = model_cfg
        self.class_names = list(class_names)
        self.num_class = len(self.class_names)
        self.point_cloud_range = [float(v) for v in data_cfg.POINT_CLOUD_RANGE]
        vox = [p for p in data_cfg.DATA_PROCESSOR
               if p.NAME in ("transform_points_to_voxels",
                             "transform_points_to_voxels_placeholder")]
        self.voxel_size = self.max_voxels = self.grid_size = None
        if vox:
            vox = vox[0]
            self.voxel_size = [float(v) for v in vox.VOXEL_SIZE]
            # a placeholder block (a dynamic VFE's) carries no voxel cap
            mv = vox.get("MAX_NUMBER_OF_VOXELS", 60000)
            self.max_voxels = int(max_voxels or (mv["test"] if isinstance(mv, dict) else mv))
            self.max_points_per_voxel = int(vox.get("MAX_POINTS_PER_VOXEL", 5))
            self.grid_size = compute_grid_size(self.point_cloud_range, self.voxel_size)
        feat_cfg = data_cfg.get("POINT_FEATURE_ENCODING", None)
        self.num_point_features = len(feat_cfg.used_feature_list) if feat_cfg else 4
        head = model_cfg.get("DENSE_HEAD", None)
        self.head_logic = None if head is None or head.get("NAME") == "CenterHead" \
            else AnchorHeadLogic(head, self.num_class, self.class_names, self.grid_size,
                                 self.point_cloud_range)

    @property
    def sparse_shape(self) -> tuple:
        """(nz + 1, ny, nx): the backbone's grid, one z level more than the
        voxel grid, as in the reference."""
        g = self.grid_size
        return (int(g[2]) + 1, int(g[1]), int(g[0]))


def _bev_backbone(b2, input_channels: int, dtype: str | None = None) -> BaseBEVBackbone:
    return BaseBEVBackbone(
        input_channels, b2.LAYER_NUMS, b2.LAYER_STRIDES, b2.NUM_FILTERS,
        b2.get("UPSAMPLE_STRIDES", ()), b2.get("NUM_UPSAMPLE_FILTERS", ()), dtype=dtype)


class _AnchorRPN(nn.Module):
    """The BEV backbone and the anchor head over a BEV map, and the anchor
    loss: what every anchor detector ends with. A detector whose class sets
    ``BEV_DTYPE`` runs its BEV convs in BACKBONE_2D.DTYPE; the others ignore
    it, as their JAX builders do (only SECOND-IoU's, SECONDNet's and
    PointPillar's pass it on, seevcn_tpu/models/detectors/second.py). A
    detector whose class sets ``SHARD_BEV`` runs its BEV backbone on W
    slabs under an active mesh of mp > 1 (``parallel.spatial``), the map
    scattered before it and gathered after it, where JAX's SECONDNetIoU
    and SECONDNet call ``constrain_bev``; the others run it replicated over
    mp, as JAX's do."""

    BEV_DTYPE = False
    SHARD_BEV = False

    def _init_head(self, cfg: DetectorConfig, bev_channels: int) -> None:
        b2 = cfg.model_cfg.BACKBONE_2D
        self.backbone_2d = _bev_backbone(b2, bev_channels,
                                         b2.get("DTYPE", None) if self.BEV_DTYPE else None)
        self.dense_head = build_anchor_head(
            cfg.model_cfg.DENSE_HEAD, cfg.head_logic, self.backbone_2d.num_bev_features,
            cfg.num_class, cfg.class_names)

    def bev_head(self, bev: torch.Tensor):
        """A BEV map (B, H, W, C) -> (BEV features, the dense head's output,
        batch_cls_preds, batch_box_preds)."""
        # a bf16 3D backbone hands a bf16 BEV over; it enters the 2D backbone
        # in the dense head's dtype (f32), whose convs cast to their compute
        # dtype where BACKBONE_2D.DTYPE sets one
        bev = bev.to(next(self.dense_head.parameters()).dtype)
        if self.SHARD_BEV and w_sharded():
            bev2d = gather_w(self.backbone_2d(scatter_w(bev), w_slabs=True))
        else:
            bev2d = self.backbone_2d(bev)
        head_out = self.dense_head(bev2d)
        cls_preds, box_preds = self.cfg.head_logic.predict_boxes(head_out)
        return bev2d, head_out, cls_preds, box_preds

    def rpn_loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The RPN's loss (assignment against gt_boxes): -> (rpn_loss, terms
        rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss)."""
        logic = self.cfg.head_logic
        return logic.loss(out["head_out"], logic.assign_targets(gt_boxes))


class AnchorDetector(_AnchorRPN):
    """The voxel anchor RPN that SECOND-IoU, SECONDNet, PV-RCNN and
    PV-RCNN++ share: MeanVFE (the voxeliser's mean) -> BACKBONE_3D ->
    HeightCompression -> BaseBEVBackbone -> the anchor head, and for the
    detectors with an RoI head the proposal NMS and, in training, the RoI
    sample against the ground truth."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        bb = cfg.model_cfg.BACKBONE_3D
        name = bb.get("NAME", "VoxelBackBone8x")
        if name not in BACKBONES:
            raise NotImplementedError(f"BACKBONE_3D {name}")
        # MODE names a TPU lowering of the same math; the port has one. The
        # JAX package's focal backbone reads no DTYPE (nor TOPK, THRESHOLD)
        kw = {} if name == "VoxelBackBone8xFocal" else {"dtype": bb.get("DTYPE", "float32")}
        self.backbone_3d = BACKBONES[name](cfg.num_point_features, **kw)
        nz = self.backbone_3d.encoded_shape(cfg.sparse_shape)[0]
        self._init_head(cfg, 128 * nz)

    def voxel_backbone(self, points: torch.Tensor, points_valid: torch.Tensor):
        """Voxelise and run the 3D backbone -> (input SparseTensor, the
        backbone's output dict)."""
        cfg = self.cfg
        feats, coords, mask = voxelize_batch(
            points, points_valid, point_cloud_range=cfg.point_cloud_range,
            voxel_size=cfg.voxel_size, max_voxels=cfg.max_voxels,
            max_points_per_voxel=cfg.max_points_per_voxel)
        st = SP.make_sparse_tensor(feats, coords, mask, cfg.sparse_shape,
                                   points.shape[0])
        return st, self.backbone_3d(st)

    def bev_rpn(self, enc: SP.SparseTensor):
        """The stride-8 sparse tensor -> (BEV features (B, H, W, C), the dense
        head's output, batch_cls_preds, batch_box_preds)."""
        return self.bev_head(height_compression(enc))

    def dense(self, points: torch.Tensor, points_valid: torch.Tensor) -> dict:
        """The single-stage part of the output dict: head_out,
        batch_cls_preds (B, A, ncls), batch_box_preds (B, A, 7),
        spatial_features_2d, ``active_voxels`` (the active count of the
        backbone's input and of each stage's output) and, for the focal
        backbone, ``focal_aux``; with ``bb``, the backbone's output."""
        st, bb = self.voxel_backbone(points, points_valid)
        enc = bb["encoded_spconv_tensor"]
        bev2d, head_out, cls_preds, box_preds = self.bev_rpn(enc)
        stages = [st] + [bb["multi_scale_3d_features"][f"x_conv{i}"]
                         for i in range(1, 5)] + [enc]
        out = {"head_out": head_out, "batch_cls_preds": cls_preds,
               "batch_box_preds": box_preds, "spatial_features_2d": bev2d,
               "active_voxels": torch.stack([s.mask.sum() for s in stages]), "bb": bb}
        if "focal_aux" in bb:
            out["focal_aux"] = bb["focal_aux"]
        return out

    def rpn(self, points: torch.Tensor, points_valid: torch.Tensor) -> dict:
        """``dense``'s dict with the proposals: ``props``, and their
        ``roi_mask``."""
        out = self.dense(points, points_valid)
        rcfg = self.cfg.model_cfg.ROI_HEAD
        props = proposal_layer(out["batch_cls_preds"], out["batch_box_preds"],
                               rcfg.NMS_CONFIG["TRAIN" if self.training else "TEST"])
        out.update(roi_mask=props["roi_mask"], props=props)
        return out

    def sample_rois(self, props: dict, gt_boxes, generator=None, roi_u=None) -> dict:
        """``sample_rois`` at the config's TARGET_CONFIG."""
        return sample_rois(props, gt_boxes, self.cfg.model_cfg.ROI_HEAD.TARGET_CONFIG,
                           generator, roi_u)


def sample_rois(props: dict, gt_boxes, target_cfg, generator=None, roi_u=None) -> dict:
    """The RoI sample of each frame of the proposals ``props`` against
    gt_boxes (B, M, 8), its priorities ``roi_u`` (B, R) where given, else
    drawn from ``generator``."""
    if gt_boxes is None:
        raise ValueError("training needs gt_boxes")
    if roi_u is None:
        roi_u = uniform(props["rois"].shape[:2], generator, gt_boxes.device)
    roi_u = roi_u.to(gt_boxes.device)
    per = [sample_rois_for_rcnn(*a, target_cfg) for a in zip(
        roi_u, props["rois"], props["roi_labels"], props["roi_scores"],
        props["roi_mask"], gt_boxes)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def focal_importance_loss(focal_aux, gt_boxes: torch.Tensor, pcr, vs) -> torch.Tensor:
    """The focal convs' box-of-points loss (focal_sparse_conv.py
    loss_box_of_pts): each valid voxel's centre importance against whether
    its centre lies in a valid ground-truth box of its frame, a BCE (the
    importance clamped to [1e-6, 1 - 1e-6]) averaged over the valid voxels
    of each focal layer, then over the layers."""
    total = 0.0
    for aux in focal_aux:
        imp = aux["importance"].clamp(1e-6, 1 - 1e-6)
        coords, mask, stride = aux["coords"].to(imp.dtype), aux["mask"], float(aux["stride"])
        dt = torch.float32 if imp.dtype == torch.float32 else imp.dtype
        p, v = [torch.tensor(a, dtype=dt, device=imp.device) for a in (pcr, vs)]
        centres = torch.stack([(coords[:, 3] + 0.5) * v[0] * stride + p[0],
                               (coords[:, 2] + 0.5) * v[1] * stride + p[1],
                               (coords[:, 1] + 0.5) * v[2] * stride + p[2]], 1)
        target = torch.zeros(imp.shape[0], dtype=torch.bool, device=imp.device)
        for b in range(gt_boxes.shape[0]):
            ok = gt_boxes[b].abs().sum(1) > 0
            inside = (points_in_boxes(centres, gt_boxes[b, :, :7].to(dt))
                      & ok[:, None]).any(0)
            target = torch.where(aux["coords"][:, 0] == b, inside, target)
        t = target.to(imp.dtype)
        bce = -(t * torch.log(imp) + (1 - t) * torch.log(1 - imp))
        w = mask.to(imp.dtype)
        total = total + (bce * w).sum() / global_count(w.sum()).clamp_min(1.0)
    return total / max(len(focal_aux), 1)


class SECONDNet(AnchorDetector):
    """Plain SECOND (second_net.py:4-34): the dense head only, over any of
    the three 3D backbones and either anchor head."""

    BEV_DTYPE = True
    SHARD_BEV = True

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """points (B, P, 3+C), points_valid (B, P) -> ``dense``'s dict (the
        same in training; the ground truth reaches only ``loss``, and
        ``generator`` and ``roi_u`` are not used: this detector draws
        nothing)."""
        out = self.dense(points, points_valid)
        out.pop("bb")
        return out

    def loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """-> (total, the terms: rpn_loss_cls, rpn_loss_loc, rpn_loss_dir,
        rpn_loss and, for the focal backbone, loss_box_of_pts)."""
        total, tb = self.rpn_loss(out, gt_boxes)
        if "focal_aux" in out:
            fl = focal_importance_loss(out["focal_aux"], gt_boxes,
                                       self.cfg.point_cloud_range, self.cfg.voxel_size)
            tb["loss_box_of_pts"] = fl
            total = total + fl
        return total, tb


class PointPillar(_AnchorRPN):
    """PointPillars (pointpillar.py): per frame the dynamic pillars (each
    pillar the mean of all its points: MAX_POINTS_PER_VOXEL is not read, as
    in the JAX package), DynamicPillarVFE over the points, pillar_scatter
    onto the BEV canvas, then BaseBEVBackbone and the anchor head. The VFE
    runs once over the batch's points, each frame's pillars numbered after
    the last frame's; in training its batch norms take their statistics
    over every point row of the batch (the reference's
    DynamicPillarVFE)."""

    BEV_DTYPE = True

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        v = cfg.model_cfg.VFE
        self.vfe = DynamicPillarVFE(
            cfg.num_point_features, tuple(v.get("NUM_FILTERS", [64])), cfg.voxel_size,
            cfg.point_cloud_range,
            use_absolute_xyz=bool(v.get("USE_ABSLOTE_XYZ", v.get("USE_ABSOLUTE_XYZ", True))),
            with_distance=bool(v.get("WITH_DISTANCE", False)))
        self._init_head(cfg, self.vfe.num_filters)

    def pillars(self, points: torch.Tensor, points_valid: torch.Tensor):
        """-> (the VFE's inputs: the batch's points in pillar order (B*P,
        3+C), their pillar rows (B*P,) (-1: dropped), the pillars' mean xyz
        (B*V, 3) and coords (B*V, 4) [b, z, y, x]; the pillars' mask
        (B*V,))."""
        cfg = self.cfg
        v = cfg.max_voxels
        pts, pid, means, coords, mask = [], [], [], [], []
        for i in range(points.shape[0]):
            r = voxelize(points[i], points_valid[i], point_cloud_range=cfg.point_cloud_range,
                         voxel_size=cfg.voxel_size, max_voxels=v)
            pts.append(points[i][r.point_order])
            pid.append(torch.where(r.point_voxel_id >= 0, r.point_voxel_id + i * v, -1))
            means.append(r.features[:, :3])
            coords.append(F.pad(r.coords, (1, 0), value=i))
            mask.append(r.mask)
        return (torch.cat(pts), torch.cat(pid), torch.cat(means), torch.cat(coords),
                torch.cat(mask))

    def scatter(self, pillar_feats: torch.Tensor, coords, mask, batch_size: int):
        g = self.cfg.grid_size
        return pillar_scatter(pillar_feats, coords, mask, batch_size, (int(g[0]), int(g[1])))

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """points (B, P, 3+C), points_valid (B, P) -> head_out,
        batch_cls_preds (B, A, ncls), batch_box_preds (B, A, 7),
        spatial_features_2d and ``active_voxels`` (the batch's active
        pillars); the same in training (the ground truth reaches only
        ``loss``; ``generator`` and ``roi_u`` are not used)."""
        b = points.shape[0]
        pts, pid, means, coords, mask = self.pillars(points, points_valid)
        feats = self.vfe(pts, pid, means, coords, b * self.cfg.max_voxels)
        bev2d, head_out, cls_preds, box_preds = self.bev_head(
            self.scatter(feats, coords, mask, b))
        return {"head_out": head_out, "batch_cls_preds": cls_preds,
                "batch_box_preds": box_preds, "spatial_features_2d": bev2d,
                "active_voxels": mask.sum()[None]}

    def loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The anchor head's loss: -> (total, rpn_loss_cls, rpn_loss_loc,
        rpn_loss_dir, rpn_loss)."""
        return self.rpn_loss(out, gt_boxes)


class SECONDNetIoU(AnchorDetector):
    """SECOND + IoU rcnn head: the rotated BEV RoI-grid pool -> SECONDHead."""

    BEV_DTYPE = True
    SHARD_BEV = True

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
        out.pop("bb")
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


def cal_scores_by_npoints(cls_scores, iou_scores, num_points_in_box,
                          cls_thresh: float = 10, iou_thresh: float = 100):
    """Blend the class and IoU scores by each box's point count
    (second_net_iou.py:38-57): a sparse box trusts its class score, a dense
    one its IoU score."""
    alpha = ((num_points_in_box - cls_thresh) / (iou_thresh - cls_thresh)).clamp(0.0, 1.0)
    return (1 - alpha) * cls_scores + alpha * iou_scores


def _rcnn_scores(out: dict, nms_cfg, points, points_valid, class_names):
    """The RCNN branch's NMS score of each RoI by SCORE_TYPE
    (second_net_iou.py:75-177): ``iou`` (the IoU head's sigmoid), ``cls``
    (the proposal's), ``weighted_iou_cls`` (SCORE_WEIGHTS' sum),
    ``num_pts_iou_cls`` (blended by the valid points in the box) or
    ``score_by_class`` (iou or cls by the box's label's class name)."""
    iou = torch.sigmoid(out["rcnn_iou"])
    cls = torch.sigmoid(out["roi_scores"])
    score_type = nms_cfg.get("SCORE_TYPE", "iou")
    if score_type == "score_by_class" and nms_cfg.get("SCORE_BY_CLASS"):
        if class_names is None:
            raise ValueError("score_by_class needs the detector's class_names")
        sbc = nms_cfg.SCORE_BY_CLASS
        table = []
        for name in class_names:
            if sbc[name] not in ("iou", "cls"):
                raise NotImplementedError(sbc[name])
            table.append(sbc[name] == "cls")
        use_cls = torch.tensor(table, device=iou.device)[
            (out["roi_labels"].long() - 1).clamp(0, len(class_names) - 1)]
        return torch.where(use_cls, cls, iou)
    if score_type in (None, "iou"):
        return iou
    if score_type == "cls":
        return cls
    if score_type == "weighted_iou_cls":
        w = nms_cfg.SCORE_WEIGHTS
        return float(w["iou"]) * iou + float(w["cls"]) * cls
    if score_type == "num_pts_iou_cls":
        if points is None:
            raise ValueError("num_pts_iou_cls needs the frame's points")
        npts = torch.stack([points_in_boxes_count(p[:, :3], b[:, :7], v)
                            for p, v, b in zip(points, points_valid, out["rois"])])
        st = nms_cfg.SCORE_THRESH
        return cal_scores_by_npoints(cls, iou, npts.to(iou.dtype), float(st["cls"]),
                                     float(st["iou"]))
    raise NotImplementedError(score_type)


def _nms_rows(bx, sc, nms_cfg, thresh: float, vd):
    """One NMS_CONFIG pass over boxes (N, 7+) scored sc (N,): -> (indices,
    keep mask) of its NMS_POST_MAXSIZE rows."""
    idx, keep, _ = nms_bev(bx[:, :7], sc, thresh=float(nms_cfg.NMS_THRESH),
                           pre_maxsize=int(nms_cfg.NMS_PRE_MAXSIZE),
                           post_maxsize=int(nms_cfg.NMS_POST_MAXSIZE),
                           score_thresh=thresh, valid_mask=vd)
    return idx, keep


def _multi_classes_nms(boxes, cls, nms_cfg, thresholds, num_class: int) -> dict:
    """model_nms_utils.multi_classes_nms: one NMS a class with its own score
    threshold, up to NMS_POST_MAXSIZE rows each, joined (num_class x post
    rows) and ordered by a stable sort on the negated scores (rows at score
    0 keep their order); label 0 and mask false where the score is 0."""
    res = {"pred_boxes": [], "pred_scores": [], "pred_labels": [], "pred_mask": []}
    for bx, cs in zip(boxes, cls):
        parts_b, parts_s, parts_l = [], [], []
        for k in range(num_class):
            idx, keep = _nms_rows(bx, cs[:, k], nms_cfg, float(thresholds[k]), None)
            parts_b.append(torch.where(keep[:, None], bx[idx], 0.0))
            parts_s.append(torch.where(keep, cs[idx, k], 0.0))
            parts_l.append(torch.full(keep.shape, k + 1, dtype=torch.int32,
                                      device=bx.device))
        sc = torch.cat(parts_s)
        order = torch.argsort(-sc, stable=True)
        sc = sc[order]
        res["pred_boxes"].append(torch.cat(parts_b)[order])
        res["pred_scores"].append(sc)
        res["pred_labels"].append(torch.where(sc > 0, torch.cat(parts_l)[order], 0))
        res["pred_mask"].append(sc > 0)
    return {k: torch.stack(v) for k, v in res.items()}


def post_processing(out: dict, post_cfg, num_class: int, has_roi_head: bool,
                    points=None, points_valid=None, class_names=None) -> dict:
    """The final NMS: per frame, pred_boxes (B, N, 7), pred_scores (B, N),
    pred_labels (B, N) int32, pred_mask (B, N). With an RCNN head, one NMS
    over the RoIs (``rois``, ``roi_labels``, ``roi_mask``) scored by
    SCORE_TYPE (``_rcnn_scores``; ``points`` and ``points_valid`` are read by
    num_pts_iou_cls, ``class_names`` by score_by_class). Without one, over
    the dense head's boxes scored by their best class's sigmoid, labelled
    by its argmax + 1: one NMS with SCORE_THRESH, or with MULTI_CLASSES_NMS
    one a class (``_multi_classes_nms``; SCORE_THRESH may then hold a
    threshold a class). Where the output carries ``batch_pred_labels``
    (CenterPoint), ``batch_cls_preds`` (B, N, 1) already holds the boxes'
    probabilities and the labels are those: one NMS over them. That is a
    deliberate departure from the JAX package, whose post-processing takes
    a second sigmoid of those probabilities and labels every box 1 (the
    argmax of one column): its kept set, order and boxes are the port's at
    SCORE_THRESH 0, its scores sigmoid(the port's)."""
    nms_cfg = post_cfg.NMS_CONFIG
    score_thresh = post_cfg.get("SCORE_THRESH", 0.1)
    if has_roi_head:
        boxes, labels, valid = out["rois"], out["roi_labels"], out["roi_mask"]
        scores = _rcnn_scores(out, nms_cfg, points, points_valid, class_names)
    elif "batch_pred_labels" in out:
        boxes, labels = out["batch_box_preds"], out["batch_pred_labels"]
        scores = out["batch_cls_preds"][..., 0]
        valid = torch.ones_like(scores, dtype=torch.bool)
    else:
        cls = torch.sigmoid(out["batch_cls_preds"])
        boxes = out["batch_box_preds"]
        if nms_cfg.get("MULTI_CLASSES_NMS", False):
            st = list(score_thresh) if isinstance(score_thresh, (list, tuple)) \
                else [score_thresh] * num_class
            return _multi_classes_nms(boxes, cls, nms_cfg, st, num_class)
        scores, labels = cls.max(-1).values, cls.argmax(-1) + 1
        valid = torch.ones_like(scores, dtype=torch.bool)
    if isinstance(score_thresh, (list, tuple)):
        raise ValueError("a SCORE_THRESH a class needs MULTI_CLASSES_NMS")
    res = {"pred_boxes": [], "pred_scores": [], "pred_labels": [], "pred_mask": []}
    for bx, sc, lb, vd in zip(boxes, scores, labels, valid):
        idx, keep = _nms_rows(bx, sc, nms_cfg, float(score_thresh), vd)
        res["pred_boxes"].append(torch.where(keep[:, None], bx[idx], 0.0))
        res["pred_scores"].append(torch.where(keep, sc[idx], 0.0))
        res["pred_labels"].append(torch.where(keep, lb[idx], 0).to(torch.int32))
        res["pred_mask"].append(keep)
    return {k: torch.stack(v) for k, v in res.items()}


def build_detector(cfg, state_dict: dict | None = None, *, max_voxels=None,
                   device="cuda"):
    """cfg: a full pcdet config (MODEL / DATA_CONFIG / CLASS_NAMES) whose
    MODEL.NAME is SECONDNet, SECONDNetIoU, PointPillar, PVRCNN,
    PVRCNNPlusPlus, CenterPoint, VoxelRCNN, PointRCNN, PartA2Net (or
    PartA2, its other name in the JAX package) or CaDDN -> (model in eval
    mode on ``device``, DetectorConfig). A given state dict (the port's key names:
    the reference's where the modules match) is loaded with strict=True;
    ``max_voxels`` overrides the voxel cap (DetectorConfig)."""
    from .caddn import CaDDN
    from .centerpoint import CenterPoint
    from .parta2 import PartA2
    from .pointrcnn import PointRCNN
    from .pvrcnn import PVRCNN, PVRCNNPlusPlus
    from .voxelrcnn import VoxelRCNN

    dev = resolve_device(device)
    detectors = {"SECONDNet": SECONDNet, "SECONDNetIoU": SECONDNetIoU,
                 "PointPillar": PointPillar, "PVRCNN": PVRCNN,
                 "PVRCNNPlusPlus": PVRCNNPlusPlus, "CenterPoint": CenterPoint,
                 "VoxelRCNN": VoxelRCNN, "PointRCNN": PointRCNN, "PartA2Net": PartA2,
                 "PartA2": PartA2, "CaDDN": CaDDN}
    if cfg.MODEL.NAME not in detectors:
        raise NotImplementedError(
            f"detector {cfg.MODEL.NAME}: the port has {', '.join(detectors)}")
    dcfg = DetectorConfig(cfg.MODEL, cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                          max_voxels=max_voxels)
    model = detectors[cfg.MODEL.NAME](dcfg)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval(), dcfg
