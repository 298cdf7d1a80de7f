"""Anchor-based dense head, eval side (port of AnchorHeadSingle and
AnchorHeadLogic.predict_boxes of seevcn_tpu/models/modules/dense_heads.py;
reference anchor_head_single.py:7-75 and anchor_head_template.py)."""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...geom.transforms import limit_period
from .anchors import generate_anchors
from .box_coder import build_box_coder


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


class AnchorHeadLogic:
    """Anchors and box decoding of the dense head (the eval part of the
    reference's AnchorHeadTemplate). Target assignment and losses are
    training and are not ported."""

    def __init__(self, model_cfg, num_class: int, class_names: Sequence[str],
                 grid_size, point_cloud_range):
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.class_names = list(class_names)
        tcfg = model_cfg.TARGET_ASSIGNER_CONFIG
        self.box_coder = build_box_coder(
            tcfg.BOX_CODER, **tcfg.get("BOX_CODER_CONFIG", {}))
        anchors, self.num_anchors_per_location_list = generate_anchors(
            model_cfg.ANCHOR_GENERATOR_CONFIG, grid_size, point_cloud_range,
            anchor_ndim=self.box_coder.code_size)
        self.anchors_flat = anchors                       # (A, ndim) numpy
        self.num_anchors_per_location = int(sum(self.num_anchors_per_location_list))
        self.use_dir = model_cfg.get("USE_DIRECTION_CLASSIFIER", False)
        self.dir_offset = float(model_cfg.get("DIR_OFFSET", 0.78539))
        self.dir_limit_offset = float(model_cfg.get("DIR_LIMIT_OFFSET", 0.0))
        self.num_dir_bins = int(model_cfg.get("NUM_DIR_BINS", 2)) if self.use_dir else 0
        self._anchors = {}

    def anchors(self, device) -> torch.Tensor:
        dev = torch.device(device)
        if dev not in self._anchors:
            self._anchors[dev] = torch.as_tensor(self.anchors_flat, device=dev)
        return self._anchors[dev]

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
