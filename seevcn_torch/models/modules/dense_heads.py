"""Anchor-based dense heads (port of AnchorHeadSingle, AnchorHeadMulti,
build_anchor_head and AnchorHeadLogic of
seevcn_tpu/models/modules/dense_heads.py; reference anchor_head_single.py:7-75,
anchor_head_multi.py and anchor_head_template.py): 1x1 conv heads for
class, box and direction, single or grouped by class; anchor decoding;
target assignment (axis-aligned or ATSS) and the focal, sin-difference
smooth-L1 and direction cross-entropy losses."""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...geom.transforms import limit_period
from ...parallel.mesh import global_batch
from ..losses import sigmoid_focal_loss, weighted_cross_entropy, weighted_smooth_l1
from .anchors import (ATSSTargetAssigner, AxisAlignedTargetAssigner, generate_anchors,
                      get_direction_targets)
from .box_coder import build_box_coder
from .common import BatchNorm2d


class AnchorHeadSingle(nn.Module):
    """1x1 conv heads for class, box and direction over the BEV map."""

    def __init__(self, input_channels: int, num_class: int,
                 num_anchors_per_location: int, code_size: int,
                 num_dir_bins: int = 0):
        super().__init__()
        a = num_anchors_per_location
        self.conv_cls = nn.Conv2d(input_channels, a * num_class, 1)
        self.conv_box = nn.Conv2d(input_channels, a * code_size, 1)
        self.conv_dir_cls = nn.Conv2d(input_channels, a * num_dir_bins, 1) \
            if num_dir_bins else None

    def forward(self, bev: torch.Tensor) -> dict:
        """bev (B, H, W, C) -> head maps (B, H, W, A*...), NHWC as in the
        reference's flax head."""
        x = bev.permute(0, 3, 1, 2)
        out = {"cls_preds": self.conv_cls(x).permute(0, 2, 3, 1),
               "box_preds": self.conv_box(x).permute(0, 2, 3, 1)}
        if self.conv_dir_cls is not None:
            out["dir_cls_preds"] = self.conv_dir_cls(x).permute(0, 2, 3, 1)
        return out


class AnchorHeadMulti(nn.Module):
    """Grouped anchor heads: an optional shared 3x3 conv + BN + ReLU, then
    per group of classes (CLASS_NAMES_EACH_HEAD) an AnchorHeadSingle over
    that group's anchors, scoring only the group's classes (the reference's
    SingleHead, without its separate regression branches). The groups' outputs
    are joined on the per-location anchor axis, the layout of
    AnchorHeadLogic (the groups partition the classes in order), and a
    class outside a group reads the constant -1e4 (sigmoid 0, no
    gradient). Keys as the reference's: ``shared_conv.{0,1}``,
    ``rpn_heads.{g}.conv_cls`` / ``conv_box`` / ``conv_dir_cls``."""

    def __init__(self, input_channels: int, num_class: int, code_size: int,
                 num_dir_bins: int, per_class_anchors: Sequence[int],
                 groups: Sequence[Sequence[int]], shared_conv_channels: int = 64):
        super().__init__()
        self.num_class, self.code_size, self.num_dir_bins = num_class, code_size, num_dir_bins
        self.groups = [tuple(g) for g in groups]
        self.group_anchors = [int(sum(per_class_anchors[c] for c in g)) for g in self.groups]
        cin = input_channels
        self.shared_conv = None
        if shared_conv_channels:
            self.shared_conv = nn.Sequential(
                nn.Conv2d(cin, shared_conv_channels, 3, padding=1, bias=False),
                BatchNorm2d(shared_conv_channels, eps=1e-3, momentum=0.01), nn.ReLU())
            cin = shared_conv_channels
        self.rpn_heads = nn.ModuleList(
            AnchorHeadSingle(cin, len(g), a, code_size, num_dir_bins)
            for a, g in zip(self.group_anchors, self.groups))

    def forward(self, bev: torch.Tensor) -> dict:
        """bev (B, H, W, C) -> head maps (B, H, W, A*...), NHWC."""
        x = bev
        if self.shared_conv is not None:
            x = self.shared_conv(bev.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        b, h, w, _ = x.shape
        parts = {}
        for head, grp, a in zip(self.rpn_heads, self.groups, self.group_anchors):
            out = {k: v.reshape(b, h, w, a, -1) for k, v in head(x).items()}
            full = out["cls_preds"].new_full((b, h, w, a, self.num_class), -1e4)
            full[..., list(grp)] = out["cls_preds"]
            out["cls_preds"] = full
            for k, v in out.items():
                parts.setdefault(k, []).append(v)
        return {k: torch.cat(v, 3).reshape(b, h, w, -1) for k, v in parts.items()}


def build_anchor_head(head_cfg, logic, input_channels: int, num_class: int,
                      class_names) -> nn.Module:
    """DENSE_HEAD.NAME's module: AnchorHeadSingle or AnchorHeadMulti (whose
    CLASS_NAMES_EACH_HEAD must partition CLASS_NAMES in order)."""
    name = head_cfg.get("NAME", "AnchorHeadSingle")
    if name == "AnchorHeadMulti":
        names = list(class_names)
        groups = [list(g) for g in head_cfg.CLASS_NAMES_EACH_HEAD]
        flat = [n for g in groups for n in g]
        if flat != names:
            raise ValueError("CLASS_NAMES_EACH_HEAD must partition CLASS_NAMES in order "
                             f"(got {flat} vs {names})")
        return AnchorHeadMulti(
            input_channels, num_class, logic.box_coder.code_size, logic.num_dir_bins,
            logic.num_anchors_per_location_list,
            [[names.index(n) for n in g] for g in groups],
            int(head_cfg.get("SHARED_CONV_NUM_FILTER", 64)))
    if name != "AnchorHeadSingle":
        raise NotImplementedError(f"DENSE_HEAD {name}")
    return AnchorHeadSingle(input_channels, num_class, logic.num_anchors_per_location,
                            logic.box_coder.code_size, logic.num_dir_bins)


class AnchorHeadLogic:
    """The dense head's anchors, box decoding, target assignment and losses
    (the non-parametric part of the reference's AnchorHeadTemplate)."""

    def __init__(self, model_cfg, num_class: int, class_names: Sequence[str],
                 grid_size, point_cloud_range):
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = list(class_names)
        tcfg = model_cfg.TARGET_ASSIGNER_CONFIG
        self.box_coder = build_box_coder(
            tcfg.BOX_CODER, **tcfg.get("BOX_CODER_CONFIG", {}))
        acfg = model_cfg.ANCHOR_GENERATOR_CONFIG
        anchors, self.num_anchors_per_location_list = generate_anchors(
            acfg, grid_size, point_cloud_range, anchor_ndim=self.box_coder.code_size)
        self.anchors_flat = anchors                       # (A, ndim) numpy
        self.num_anchors_per_location = int(sum(self.num_anchors_per_location_list))
        self.use_dir = model_cfg.get("USE_DIRECTION_CLASSIFIER", False)
        self.dir_offset = float(model_cfg.get("DIR_OFFSET", 0.78539))
        self.dir_limit_offset = float(model_cfg.get("DIR_LIMIT_OFFSET", 0.0))
        self.num_dir_bins = int(model_cfg.get("NUM_DIR_BINS", 2)) if self.use_dir else 0
        self.loss_weights = model_cfg.LOSS_CONFIG.LOSS_WEIGHTS
        # each anchor class's anchors as (locations, per location, ndim), for
        # the assigner, which interleaves the classes per location again
        self._per_class_anchors = []
        for c in acfg:
            a, npl = generate_anchors([c], grid_size, point_cloud_range,
                                      anchor_ndim=self.box_coder.code_size)
            self._per_class_anchors.append(a.reshape(-1, npl[0], a.shape[-1]))
        match_height = bool(tcfg.get("MATCH_HEIGHT", False))
        if tcfg.get("NAME", "AxisAlignedTargetAssigner") == "ATSS":
            self.assigner = ATSSTargetAssigner(int(tcfg.TOPK), self.box_coder, match_height)
        else:
            self.assigner = AxisAlignedTargetAssigner(acfg, class_names, self.box_coder,
                                                      match_height=match_height)
        self._anchors = {}

    def _device_anchors(self, device):
        """(flat anchors, per-class anchors) on ``device``, made once."""
        dev = torch.device(device)
        if dev not in self._anchors:
            self._anchors[dev] = (
                torch.as_tensor(self.anchors_flat, device=dev),
                [torch.as_tensor(a, device=dev) for a in self._per_class_anchors])
        return self._anchors[dev]

    def anchors(self, device) -> torch.Tensor:
        return self._device_anchors(device)[0]

    def assign_targets(self, gt_boxes: torch.Tensor) -> dict:
        """gt_boxes (B, M, 8), zero rows padding -> the assigner's targets,
        in the head's anchor layout."""
        flat, per_class = self._device_anchors(gt_boxes.device)
        if isinstance(self.assigner, ATSSTargetAssigner):
            return self.assigner.assign(flat, gt_boxes)
        return self.assigner.assign(per_class, gt_boxes)

    def loss(self, preds: dict, targets: dict) -> tuple[torch.Tensor, dict]:
        """The RPN loss: focal classification, sin-difference smooth-L1 box
        regression and direction cross-entropy, each normalised by the
        frame's positive count and weighted by LOSS_WEIGHTS. -> (total,
        {rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss})."""
        cls_preds = preds["cls_preds"]
        b = cls_preds.shape[0]
        nb = global_batch(b)                  # the per-frame means' divisor
        cls_preds = cls_preds.reshape(b, -1, self.num_class)
        box_preds = preds["box_preds"].reshape(b, -1, self.box_coder.code_size)
        labels = targets["box_cls_labels"]
        reg_targets = targets["box_reg_targets"]

        cared = labels >= 0
        positives = labels > 0
        negatives = labels == 0
        pos_norm = positives.sum(1, keepdim=True).float().clamp_min(1.0)
        cls_weights = (negatives | positives).float() / pos_norm
        reg_weights = positives.float() / pos_norm

        cls_targets = torch.where(cared, labels, 0).long()
        if self.num_class == 1:
            cls_targets = positives.long()
        one_hot = F.one_hot(cls_targets, self.num_class + 1)[..., 1:].to(cls_preds.dtype)
        cls_loss = sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum() / nb
        cls_loss = cls_loss * float(self.loss_weights["cls_weight"])

        # sin-difference angle encoding (anchor_head_template.py:137-144)
        sin_p = torch.sin(box_preds[..., 6:7]) * torch.cos(reg_targets[..., 6:7])
        sin_t = torch.cos(box_preds[..., 6:7]) * torch.sin(reg_targets[..., 6:7])
        bp = torch.cat([box_preds[..., :6], sin_p, box_preds[..., 7:]], -1)
        bt = torch.cat([reg_targets[..., :6], sin_t, reg_targets[..., 7:]], -1)
        loc_loss = weighted_smooth_l1(
            bp, bt, reg_weights,
            code_weights=self.loss_weights["code_weights"]).sum() / nb
        loc_loss = loc_loss * float(self.loss_weights["loc_weight"])
        tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
        total = cls_loss + loc_loss

        if self.use_dir and "dir_cls_preds" in preds:
            dir_logits = preds["dir_cls_preds"].reshape(b, -1, self.num_dir_bins)
            dir_t = get_direction_targets(self.anchors(cls_preds.device)[None],
                                          reg_targets, self.dir_offset,
                                          self.num_dir_bins)
            w = positives.float()
            w = w / w.sum(-1, keepdim=True).clamp_min(1.0)
            dir_loss = weighted_cross_entropy(
                dir_logits, F.one_hot(dir_t, self.num_dir_bins).to(dir_logits.dtype),
                w).sum() / nb
            dir_loss = dir_loss * float(self.loss_weights["dir_weight"])
            tb["rpn_loss_dir"] = dir_loss
            total = total + dir_loss
        tb["rpn_loss"] = total
        return total, tb

    def predict_boxes(self, preds: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (batch_cls_preds (B, A, ncls), batch_box_preds (B, A, 7+C))."""
        cls_preds = preds["cls_preds"]
        b = cls_preds.shape[0]
        anchors = self.anchors(cls_preds.device)[None]
        cls_preds = cls_preds.reshape(b, -1, self.num_class)
        box_preds = preds["box_preds"].reshape(b, -1, self.box_coder.code_size)
        boxes = self.box_coder.decode(box_preds, anchors)
        if self.use_dir and "dir_cls_preds" in preds:
            dir_labels = preds["dir_cls_preds"].reshape(
                b, -1, self.num_dir_bins).argmax(-1)
            period = 2 * math.pi / self.num_dir_bins
            rot = limit_period(boxes[..., 6] - self.dir_offset,
                               self.dir_limit_offset, period)
            boxes = torch.cat([boxes[..., :6], (rot + self.dir_offset + period
                                                * dir_labels.to(boxes.dtype))[..., None],
                               boxes[..., 7:]], dim=-1)
        return cls_preds, boxes
