"""PointRCNN: forward and training loss (port of PointHeadBox,
PointRCNNHead and PointRCNN of seevcn_tpu/models/detectors/pointrcnn.py;
reference point_rcnn.py, dense_heads/point_head_box.py,
roi_heads/pointrcnn_head.py and tools/cfgs/kitti_models/pointrcnn.yaml).

PointNet2MSG per-point features -> PointHeadBox (per-point class logits
and PointResidualCoder box residuals, decoded at the argmax class's mean
size) -> the proposal NMS over the points (invalid points' logits at -1e9)
-> PointRCNNHead: for each RoI, the valid points inside it in index order,
cycled to NUM_SAMPLED_POINTS, as canonical local xyz and depth ‖p‖ /
DEPTH_NORMALIZER - 0.5 (xyz_up: Linear + ReLU), concatenated with their
point features, merge_down (Linear + ReLU), a max over the points, then
the class and box stacks (Linear + ReLU, no dropout). An RoI with no point
inside pools point 0's features with its geometry zeroed, as the JAX
package does. The RoI head reads no SA_CONFIG, USE_BN or DP_RATIO, as the
JAX package's does not. In eval the refined boxes become ``rois`` and
``rcnn_iou`` is the class logit. In training the point features reach the
RoI head detached, the RoI sample takes ``roi_u`` or draws from the
generator, and ``loss`` adds the point head's focal and box losses to the
RCNN's.

State-dict keys: OpenPCDet's for the backbone (``backbone_3d.SA_modules``,
``backbone_3d.FP_modules``) and the point head (``point_head.cls_layers``,
``point_head.box_layers``); the JAX package's module names for the RoI
head: ``roi_head.xyz_up{i}``, ``merge_down``, ``cls_fc{i}``, ``cls_out``,
``reg_fc{i}``, ``reg_out`` (Linear layers with their biases).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...geom.boxes import enlarge_box3d, points_in_boxes
from ...geom.transforms import rotate_points_along_z
from ...parallel.mesh import global_batch
from ..losses import sigmoid_focal_loss, weighted_smooth_l1
from ..modules.common import BatchNorm1d
from ..modules.pointnet2_backbone import PointNet2MSG, PointResidualCoder
from ..modules.pvrcnn_head import decode_rcnn_boxes, pvrcnn_rcnn_loss
from ..modules.roi_heads import proposal_layer
from .second import DetectorConfig, sample_rois


def _fc_head(cin: int, widths: Sequence[int], out: int) -> nn.Sequential:
    """make_fc_layers: Linear (no bias) + BN + ReLU per width, then a Linear
    to ``out`` with its bias."""
    layers = []
    for f in widths:
        layers += [nn.Linear(cin, int(f), bias=False),
                   BatchNorm1d(int(f), eps=1e-3, momentum=0.01), nn.ReLU()]
        cin = int(f)
    return nn.Sequential(*layers, nn.Linear(cin, out))


class PointHeadBox(nn.Module):
    """Per-point classification and box regression (point_head_box.py)."""

    def __init__(self, cin: int, num_class: int, cls_fc=(256, 256), reg_fc=(256, 256),
                 code_size: int = 8):
        super().__init__()
        self.cls_layers = _fc_head(cin, cls_fc, num_class)
        self.box_layers = _fc_head(cin, reg_fc, code_size)

    def forward(self, feats: torch.Tensor):
        """(B, N, C) -> (cls (B, N, ncls), reg (B, N, 8)); the batch norms'
        statistics over all B N rows."""
        b, n, c = feats.shape
        x = feats.reshape(b * n, c)
        return self.cls_layers(x).reshape(b, n, -1), self.box_layers(x).reshape(b, n, -1)


@torch.no_grad()
def roi_point_indices(rois: torch.Tensor, points: torch.Tensor, valid: torch.Tensor,
                      num_sampled: int):
    """One frame's RoI point pool selection: rois (R, 7), points (N, 3),
    valid (N,) -> (idx (R, S) int64, ok (R,)): for each RoI the valid points
    inside it in index order, cycled to S (the reference's stable argsort
    with ``arange(S) % cnt``, here a cumsum and a search); point 0 for an
    RoI with none inside (ok False)."""
    inside = points_in_boxes(points, rois) & valid[None, :]
    cum = torch.cumsum(inside, 1, dtype=torch.int32)
    cnt = cum[:, -1:]
    rank = torch.arange(num_sampled, device=points.device, dtype=torch.int32)[None] \
        % cnt.clamp_min(1) + 1
    idx = torch.searchsorted(cum, rank)
    ok = cnt[:, 0] > 0
    return torch.where(ok[:, None], idx, 0), ok


class PointRCNNHead(nn.Module):
    """Refinement over the pooled in-RoI points (pointrcnn_head.py), as the
    JAX package computes it."""

    def __init__(self, point_channels: int, num_sampled_points: int = 512,
                 depth_normalizer: float = 70.0, xyz_up=(128, 128), cls_fc=(256, 256),
                 reg_fc=(256, 256)):
        super().__init__()
        self.num_sampled_points = int(num_sampled_points)
        self.depth_normalizer = float(depth_normalizer)
        self.relu = nn.ReLU()
        self.branches = {"xyz_up": len(xyz_up), "cls": len(cls_fc), "reg": len(reg_fc)}
        c = 4
        for i, f in enumerate(xyz_up):
            self.add_module(f"xyz_up{i}", nn.Linear(c, int(f)))
            c = int(f)
        self.merge_down = nn.Linear(c + point_channels, 256)
        for name, widths, out in (("cls", cls_fc, 1), ("reg", reg_fc, 7)):
            c = 256
            for i, f in enumerate(widths):
                self.add_module(f"{name}_fc{i}", nn.Linear(c, int(f)))
                c = int(f)
            self.add_module(f"{name}_out", nn.Linear(c, out))

    def pool(self, rois: torch.Tensor, points: torch.Tensor, point_feats: torch.Tensor,
             points_valid: torch.Tensor):
        """rois (B, R, 7), points (B, N, 3), point_feats (B, N, C) -> (geometry
        (B, R, S, 4), pooled features (B, R, S, C))."""
        geo, feats = [], []
        for ro, px, pf, pv in zip(rois, points, point_feats, points_valid):
            idx, ok = roi_point_indices(ro, px, pv, self.num_sampled_points)
            sel = px[idx]                                                # (R, S, 3)
            local = rotate_points_along_z(sel - ro[:, None, :3], -ro[:, 6])
            depth = torch.linalg.norm(sel, dim=-1) / self.depth_normalizer - 0.5
            g = torch.cat([local, depth[..., None]], -1)
            geo.append(torch.where(ok[:, None, None], g, 0.0))
            feats.append(pf[idx])
        return torch.stack(geo), torch.stack(feats)

    def _stack(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.branches[name]):
            x = self.relu(getattr(self, f"{name}_fc{i}")(x))
        return getattr(self, f"{name}_out")(x)

    def head(self, geo: torch.Tensor, feats: torch.Tensor):
        """The pooled geometry and features -> (rcnn_cls (B, R), rcnn_reg (B,
        R, 7))."""
        b, r, s = geo.shape[:3]
        x = geo.reshape(b * r * s, -1)
        for i in range(self.branches["xyz_up"]):
            x = self.relu(getattr(self, f"xyz_up{i}")(x))
        x = torch.cat([x, feats.reshape(b * r * s, -1)], -1)
        x = self.relu(self.merge_down(x)).reshape(b * r, s, -1).max(1).values
        return self._stack("cls", x).reshape(b, r), self._stack("reg", x).reshape(b, r, 7)

    def forward(self, rois, points, point_feats, points_valid):
        return self.head(*self.pool(rois, points, point_feats, points_valid))


class PointRCNN(nn.Module):
    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        m = cfg.model_cfg
        bb = m.BACKBONE_3D
        self.backbone_3d = PointNet2MSG(bb.SA_CONFIG, [list(f) for f in bb.FP_MLPS],
                                        cfg.num_point_features - 3)
        c = int(bb.FP_MLPS[0][-1])
        ph = m.POINT_HEAD
        self.point_head = PointHeadBox(c, cfg.num_class, tuple(ph.CLS_FC), tuple(ph.REG_FC))
        r = m.ROI_HEAD
        pp = r.ROI_POINT_POOL
        self.roi_head = PointRCNNHead(
            c, int(pp.NUM_SAMPLED_POINTS), float(pp.get("DEPTH_NORMALIZER", 70.0)),
            tuple(r.XYZ_UP_LAYER), tuple(r.CLS_FC), tuple(r.REG_FC))
        bc = ph.TARGET_CONFIG.get("BOX_CODER_CONFIG", {})
        self.coder = PointResidualCoder(use_mean_size=bool(bc.get("use_mean_size", True)),
                                        mean_size=bc.get("mean_size", [[3.9, 1.6, 1.56]]))

    def point_stage(self, points: torch.Tensor, points_valid: torch.Tensor) -> dict:
        """The backbone and the point head: -> point_features, point_cls,
        point_reg, batch_cls_preds (B, N, ncls) and batch_box_preds (B, N,
        7), decoded at each point's argmax class."""
        feats = self.backbone_3d(points, points_valid)
        point_cls, point_reg = self.point_head(feats)
        boxes = self.coder.decode(point_reg, points[..., :3], point_cls.argmax(-1) + 1)
        return {"point_features": feats, "point_cls": point_cls, "point_reg": point_reg,
                "batch_cls_preds": point_cls, "batch_box_preds": boxes}

    def rpn(self, points: torch.Tensor, points_valid: torch.Tensor) -> dict:
        """``point_stage``'s dict with the proposals over the points (NMS of
        the decoded boxes scored by their best class logit, an invalid
        point's logits at -1e9): ``props`` and their ``roi_mask``."""
        out = self.point_stage(points, points_valid)
        cls_masked = torch.where(points_valid[..., None], out["batch_cls_preds"], -1e9)
        props = proposal_layer(cls_masked, out["batch_box_preds"],
                               self.cfg.model_cfg.ROI_HEAD.NMS_CONFIG[
                                   "TRAIN" if self.training else "TEST"])
        out.update(roi_mask=props["roi_mask"], props=props)
        return out

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """points (B, N, 3+C), points_valid (B, N) -> ``point_stage``'s dict
        with roi_mask (B, R) of the proposals, rcnn_cls (B, R) and rcnn_reg
        (B, R, 7), and the points (``_points``, ``_points_valid``) for
        ``loss``. In eval also roi_scores, roi_labels, rois (the refined
        boxes) and rcnn_iou (= rcnn_cls). In training, ``gt_boxes`` (B, M,
        8) is required and the output holds ``rcnn_targets``, the RoI sample
        with priorities ``roi_u`` (B, R) where given, else drawn from
        ``generator``."""
        out = self.rpn(points, points_valid)
        props, feats = out.pop("props"), out.pop("point_features")
        out.update(_points=points, _points_valid=points_valid)
        if self.training:
            targets = sample_rois(props, gt_boxes, self.cfg.model_cfg.ROI_HEAD.TARGET_CONFIG,
                                  generator, roi_u)
            out["rcnn_targets"] = targets
            rois = targets["rois"]
            feats = feats.detach()
        else:
            out.update(props)
            rois = props["rois"]
        rcnn_cls, rcnn_reg = self.roi_head(rois[..., :7], points[..., :3], feats,
                                           points_valid)
        out.update(rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
        if not self.training:
            out.update(rois=decode_rcnn_boxes(rois[..., :7], rcnn_reg), rcnn_iou=rcnn_cls)
        return out

    def point_targets(self, points: torch.Tensor, points_valid: torch.Tensor,
                      gt_boxes: torch.Tensor):
        """Each point's class (0: background), box row and foreground flag:
        the valid points inside a valid ground-truth box grown by 0.2 m, the
        first such box by index."""
        cls, box_id, fg = [], [], []
        for px, pv, gb in zip(points[..., :3], points_valid, gt_boxes):
            inside = points_in_boxes(px, enlarge_box3d(gb[:, :7], (0.2, 0.2, 0.2))) \
                & (gb.abs().sum(-1) > 0)[:, None]
            f = inside.any(0) & pv
            i = inside.to(torch.uint8).argmax(0)
            cls.append(torch.where(f, gb[i, 7].long(), 0))
            box_id.append(i)
            fg.append(f)
        return torch.stack(cls), torch.stack(box_id), torch.stack(fg)

    def loss(self, out: dict, gt_boxes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """-> (total, the terms: point_loss_cls (focal, over the valid points,
        normalised by the foreground count), point_loss_box (smooth-l1 of
        the residuals of the foreground points), rcnn_loss_cls,
        rcnn_loss_reg, rcnn_loss_corner, rcnn_loss, loss)."""
        points, valid = out["_points"], out["_points_valid"]
        b = global_batch(points.shape[0])      # the per-frame means' divisor
        cls_t, box_id, fg = self.point_targets(points, valid, gt_boxes)
        one_hot = F.one_hot(cls_t, self.cfg.num_class + 1)[..., 1:].to(points.dtype)
        n_fg = fg.sum(-1, keepdim=True).clamp_min(1).to(points.dtype)
        cls_loss = sigmoid_focal_loss(out["point_cls"], one_hot,
                                      valid.to(points.dtype) / n_fg).sum() / b
        gt = torch.gather(gt_boxes, 1, box_id[..., None].expand(-1, -1, gt_boxes.shape[-1]))
        reg_t = self.coder.encode(gt[..., :7], points[..., :3], gt[..., 7].long())
        reg_loss = weighted_smooth_l1(out["point_reg"], reg_t,
                                      fg.to(points.dtype) / n_fg).sum() / b
        rcnn_loss, rtb = pvrcnn_rcnn_loss(out["rcnn_cls"], out["rcnn_reg"],
                                          out["rcnn_targets"],
                                          self.cfg.model_cfg.ROI_HEAD.LOSS_CONFIG)
        total = cls_loss + reg_loss + rcnn_loss
        return total, {"point_loss_cls": cls_loss, "point_loss_box": reg_loss, **rtb,
                       "loss": total}
