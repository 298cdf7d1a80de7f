"""Mask R-CNN and HTC in torch (port of seevcn_tpu/models/seg2d/maskrcnn.py).

The plain Mask R-CNN that bench.py's mask stage runs: ResNet-FPN (P2..P6)
-> RPN -> proposals -> RoIAlign 7x7 -> box head -> per-class decode + NMS
-> RoIAlign 14x14 on the final boxes -> mask head -> 28x28 instance masks.
Every stage keeps the reference's fixed shapes: 1,024 pre-NMS proposals,
``num_proposals`` RoIs, ``max_detections`` output slots, suppressed boxes
left in their slots at score 0.

HTC's four parts, each a field of ``Seg2DConfig``: ``cascade_stages`` box
heads at increasing IoU thresholds (``box_head``, ``box_head_s1``, ...),
each stage relabelling the previous stage's refined boxes, the eval forward
averaging the stages' class probabilities on the final boxes;
``semantic_branch``, the fused stride-8 semantic head whose feature map is
RoI-aligned and added to every head's RoI features; ``mask_info_flow``, a
mask head a stage, each fed the previous one's pre-upsample feature;
``dcn_stages``, deformable second convs in the marked backbone stages.

Training (``forward(..., train=True)`` and ``loss``) is the reference's
MaskRCNNLogic as plain functions: RPN targets over all anchors, proposals
on the detached RPN outputs, a fixed-size RoI sample (the ground truth
appended to the proposals), RoIAlign 7x7 into the box head and 14x14 on
the sampled RoIs into the mask head, and the RPN, box and mask losses. The
random priorities of the two samples are arguments (U[0, 1) of the anchors'
or the candidates' length, fg and bg), drawn from a ``torch.Generator`` of
the model's device unless given; the tests pass JAX's own draws. Every
top-k is a stable descending sort, lower indices first among equal keys,
as ``jax.lax.top_k``.

The image enters NHWC (B, H, W, 3) as in the reference. The convolutions
run NCHW; RoIAlign gathers from each FPN map laid out (H, W, C) and returns
(R, S, S, C), so the box head flattens its input in the reference's HWC
order. Module attribute names mirror the flax tree's, flax's automatic names
included (``BatchNorm_0``, ``Conv_0``...), so ``seg2d_state_dict_from_flax``
is a walk of that tree.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...geom.boxes import boxes_iou_normal
from ...ops.nms import _greedy_suppress
from ..losses import binary_cross_entropy_with_logits, weighted_smooth_l1
from ..modules.common import BatchNorm2d, DeformConv2d

# box-delta variance weights (Detectron defaults)
BOX_W = (10.0, 10.0, 5.0, 5.0)
NUM_ANCHORS = 3                       # aspect ratios per location


@dataclass
class Seg2DConfig:
    """A copy of the reference's Seg2DConfig (maskrcnn.py:329-371)."""
    image_size: tuple = (384, 512)            # static (H, W)
    num_classes: int = 1                      # foreground classes
    class_ids: tuple = (3,)                   # COCO category per class (car)
    max_gt: int = 16
    rpn_pos_iou: float = 0.7
    rpn_neg_iou: float = 0.3
    rpn_batch: int = 256
    rpn_fg_fraction: float = 0.5
    pre_nms_topk: int = 1024
    proposal_nms_thresh: float = 0.7
    num_proposals: int = 256
    roi_batch: int = 128
    roi_fg_fraction: float = 0.25
    roi_fg_iou: float = 0.5
    test_score_thresh: float = 0.05
    test_nms_thresh: float = 0.5
    max_detections: int = 64
    strides: tuple = (4, 8, 16, 32, 64)
    stage_sizes: tuple = (2, 2, 2, 2)
    stage_channels: tuple = (64, 128, 256, 512)
    fpn_channels: int = 256
    dcn_stages: tuple = (False, False, False, False)
    box_hidden: int = 1024
    mask_channels: int = 256
    mask_convs: int = 4
    cascade_stages: int = 1
    cascade_ious: tuple = (0.5, 0.6, 0.7)
    cascade_weights: tuple = (1.0, 0.5, 0.25)
    semantic_branch: bool = False
    semantic_convs: int = 2
    semantic_loss_weight: float = 0.2
    mask_info_flow: bool = False
    extra: dict = field(default_factory=dict)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """flax's padding="SAME" on one axis of size ``n`` for a kernel ``k`` at
    stride ``s``: (low, high), the low side taking the floor of half."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Conv2d padded as flax's default padding="SAME", from the input's
    shape. A stride-2 conv on an even size pads (0, 1) for a 3x3 kernel and
    (2, 3) for a 7x7 one, which torch's symmetric padding cannot express."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (
            same_padding(n, k, s) for n, k, s in
            zip(x.shape[-2:], self.kernel_size, self.stride))
        if (top, left) == (bottom, right):
            return F.conv2d(x, self.weight, self.bias, self.stride, (top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), self.weight,
                        self.bias, self.stride)


def _bn(channels: int) -> BatchNorm2d:
    # flax nn.BatchNorm: eps 1e-5, momentum 0.9 (torch's 0.1), the running
    # variance moved by the biased batch variance
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    """Two 3x3 convs with BN, and a 1x1 projection of the residual where the
    shape changes (the reference's ``residual.shape != y.shape``). With
    ``dcn`` the second conv is deformable (mmdet's with_dcn), and the
    children take the names flax's tree gives them: ``DeformConv2d_0``,
    and the projection becomes ``Conv_1``, not ``Conv_2``."""

    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 dcn: bool = False):
        super().__init__()
        self.Conv_0 = SameConv2d(in_channels, channels, 3, stride, bias=False)
        self.BatchNorm_0 = _bn(channels)
        self.second, self.proj = ("DeformConv2d_0", "Conv_1") if dcn else ("Conv_1", "Conv_2")
        self.add_module(self.second, DeformConv2d(channels, channels, 3) if dcn
                        else SameConv2d(channels, channels, 3, bias=False))
        self.BatchNorm_1 = _bn(channels)
        self.project = in_channels != channels or stride != 1
        if self.project:
            self.add_module(self.proj, SameConv2d(in_channels, channels, 1, stride,
                                                  bias=False))
            self.BatchNorm_2 = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(getattr(self, self.second)(y))
        residual = self.BatchNorm_2(getattr(self, self.proj)(x)) if self.project else x
        return F.relu(y + residual)


class ResNetFPN(nn.Module):
    """ResNet-18-style backbone + FPN: (B, 3, H, W) -> [P2..P6], NCHW,
    strides 4..64. The blocks of a stage marked in ``dcn_stages`` take a
    deformable second conv ((False, True, True, True) is the reference HTC's
    dconv_c3-c5)."""

    def __init__(self, stage_sizes=(2, 2, 2, 2), stage_channels=(64, 128, 256, 512),
                 fpn_channels: int = 256, dcn_stages=(False, False, False, False)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.stem = SameConv2d(3, 64, 7, 2, bias=False)
        self.BatchNorm_0 = _bn(64)
        cin = 64
        for i, (n, ch) in enumerate(zip(stage_sizes, stage_channels)):
            for j in range(n):
                self.add_module(f"stage{i}_block{j}", BasicBlock(
                    cin, ch, stride=2 if (j == 0 and i > 0) else 1,
                    dcn=bool(dcn_stages[i])))
                cin = ch
        for i, ch in enumerate(stage_channels):
            self.add_module(f"lat{i}", nn.Conv2d(ch, fpn_channels, 1))
        for i in range(len(stage_channels)):
            self.add_module(f"post{i}", SameConv2d(fpn_channels, fpn_channels, 3))

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.BatchNorm_0(self.stem(images)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        cs = []
        for i, n in enumerate(self.stage_sizes):
            for j in range(n):
                x = getattr(self, f"stage{i}_block{j}")(x)
            cs.append(x)                       # C2..C5, strides 4, 8, 16, 32
        laterals = [getattr(self, f"lat{i}")(c) for i, c in enumerate(cs)]
        ps = [laterals[-1]]
        for lat in laterals[-2::-1]:
            # jax.image.resize(..., "nearest") samples at half-pixel centres
            up = F.interpolate(ps[0], size=lat.shape[-2:], mode="nearest-exact")
            ps.insert(0, lat + up)
        ps = [getattr(self, f"post{i}")(p) for i, p in enumerate(ps)]
        return ps + [ps[-1][:, :, ::2, ::2]]  # P6: a 1x1 max-pool at stride 2


class RPNHead(nn.Module):
    """Shared-conv RPN head on one level: (B, C, H, W) -> objectness
    (B, H*W*A) and deltas (B, H*W*A, 4), in the reference's (y, x, anchor)
    order."""

    def __init__(self, channels: int, num_anchors: int = NUM_ANCHORS):
        super().__init__()
        self.conv = SameConv2d(channels, channels, 3)
        self.obj = nn.Conv2d(channels, num_anchors, 1)
        self.box = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feat: torch.Tensor):
        x = F.relu(self.conv(feat))
        obj = self.obj(x).permute(0, 2, 3, 1)
        box = self.box(x).permute(0, 2, 3, 1)
        b = obj.shape[0]
        return obj.reshape(b, -1), box.reshape(b, -1, 4)


class BoxHead(nn.Module):
    """(R, 7, 7, C) RoI features -> class logits (R, K + 1), deltas (R, K, 4)."""

    def __init__(self, in_features: int, num_classes: int, hidden: int = 1024):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = nn.Linear(in_features, hidden)
        self.fc2 = nn.Linear(hidden, hidden)
        self.cls = nn.Linear(hidden, num_classes + 1)
        self.box = nn.Linear(hidden, num_classes * 4)

    def forward(self, roi_feats: torch.Tensor):
        x = roi_feats.reshape(roi_feats.shape[0], -1)      # HWC order
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls(x), self.box(x).reshape(-1, self.num_classes, 4)


class MaskHead(nn.Module):
    """(R, 14, 14, C) RoI features -> (mask logits (R, 28, 28, K), the
    pre-upsample feature (R, 14, 14, channels)): 3x3 convs, a 2x2 stride-2
    transposed conv (``up``) and 1x1 logits. A head with ``res_conv``
    (HTC's info flow, the heads after the first) adds relu(res_conv(
    prev_feat)), the previous stage's feature through a 1x1 conv, to its
    input first (mmdet HTCMaskHead's conv_res)."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 256,
                 n_convs: int = 4, res_conv: bool = False):
        super().__init__()
        self.n_convs = n_convs
        if res_conv:
            self.res_conv = nn.Conv2d(channels, channels, 1)
        for i in range(n_convs):
            self.add_module(f"conv{i}", SameConv2d(
                in_channels if i == 0 else channels, channels, 3))
        self.up = nn.ConvTranspose2d(channels, channels, 2, stride=2)
        self.logits = nn.Conv2d(channels, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor, prev_feat: torch.Tensor | None = None):
        x = roi_feats.permute(0, 3, 1, 2)
        if prev_feat is not None:
            x = x + F.relu(self.res_conv(prev_feat.permute(0, 3, 1, 2)))
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        feat = x
        x = F.relu(self.up(x))
        return self.logits(x).permute(0, 2, 3, 1), feat.permute(0, 2, 3, 1)


class SemanticHead(nn.Module):
    """HTC's fused semantic branch (mmdet FusedSemanticHead): each FPN level
    (B, C, H_l, W_l) through a 1x1 lateral, resized to P3's grid (stride 8)
    and summed; 3x3 convs with ReLU; 1x1 logits over K + 1 classes. ->
    (logits (B, K + 1, H_3, W_3), the fused feature (B, channels, H_3,
    W_3)). The resizes are the reference's ``jax.image.resize(...,
    "bilinear")``: half-pixel, and a shrink (P2's) antialiased as JAX's is."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 256,
                 n_convs: int = 2, n_levels: int = 5):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_levels):
            self.add_module(f"lat{i}", nn.Conv2d(in_channels, channels, 1))
        for i in range(n_convs):
            self.add_module(f"conv{i}", SameConv2d(channels, channels, 3))
        self.logits = nn.Conv2d(channels, num_classes + 1, 1)

    def forward(self, feats):
        size = feats[1].shape[-2:]
        x = 0.0
        for i, f in enumerate(feats):
            lat = getattr(self, f"lat{i}")(f)
            if lat.shape[-2:] != size:
                shrink = lat.shape[-2] > size[0] or lat.shape[-1] > size[1]
                lat = F.interpolate(lat, size=size, mode="bilinear", align_corners=False,
                                    antialias=shrink)
            x = x + lat
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.logits(x), x


# ---------------------------------------------------------------------------
# anchors / box deltas
# ---------------------------------------------------------------------------
def generate_anchors_2d(image_size, strides=(4, 8, 16, 32, 64),
                        scales=(32, 64, 128, 256, 512),
                        ratios=(0.5, 1.0, 2.0)):
    """Per-level anchors (x1, y1, x2, y2) for a static image size, numpy,
    ceil(H/stride) x ceil(W/stride) x len(ratios) a level in (y, x, ratio)
    order."""
    h, w = image_size
    per_level = []
    for stride, scale in zip(strides, scales):
        fh, fw = -(-h // stride), -(-w // stride)
        ys = (np.arange(fh) + 0.5) * stride
        xs = (np.arange(fw) + 0.5) * stride
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        anchors = []
        for r in ratios:
            aw, ah = scale * np.sqrt(1.0 / r), scale * np.sqrt(r)
            anchors.append(np.stack([cx - aw / 2, cy - ah / 2,
                                     cx + aw / 2, cy + ah / 2], axis=-1))
        a = np.stack(anchors, axis=2).reshape(-1, 4)   # (fh*fw*A, 4)
        per_level.append(a.astype(np.float32))
    return per_level


def encode_deltas(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """xyxy boxes on xyxy anchors (..., 4) -> weighted (dx, dy, dw, dh); the
    widths and heights of both are floored at 1e-3, so a zero-width box
    encodes finite."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bw = (boxes[..., 2] - boxes[..., 0]).clamp_min(1e-3)
    bh = (boxes[..., 3] - boxes[..., 1]).clamp_min(1e-3)
    bx = boxes[..., 0] + bw / 2
    by = boxes[..., 1] + bh / 2
    aw, ah = aw.clamp_min(1e-3), ah.clamp_min(1e-3)
    return torch.stack([BOX_W[0] * (bx - ax) / aw, BOX_W[1] * (by - ay) / ah,
                        BOX_W[2] * torch.log(bw / aw),
                        BOX_W[3] * torch.log(bh / ah)], dim=-1)


def decode_deltas(deltas: torch.Tensor, anchors: torch.Tensor, image_size):
    """Weighted (dx, dy, dw, dh) on xyxy anchors -> xyxy boxes clipped to
    the image; dw, dh are clipped to [-8, 4] before the exp."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    bx = deltas[..., 0] / BOX_W[0] * aw + ax
    by = deltas[..., 1] / BOX_W[1] * ah + ay
    bw = torch.exp(torch.clamp(deltas[..., 2] / BOX_W[2], -8, 4)) * aw
    bh = torch.exp(torch.clamp(deltas[..., 3] / BOX_W[3], -8, 4)) * ah
    h, w = image_size
    return torch.stack([torch.clamp(bx - bw / 2, 0, w - 1),
                        torch.clamp(by - bh / 2, 0, h - 1),
                        torch.clamp(bx + bw / 2, 0, w - 1),
                        torch.clamp(by + bh / 2, 0, h - 1)], dim=-1)


# ---------------------------------------------------------------------------
# RoIAlign over FPN levels
# ---------------------------------------------------------------------------
def _bilinear(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """fmap (H, W, C), xy (..., 2) -> (..., C): four gathered taps; a tap
    outside the map reads 0."""
    h, w = fmap.shape[:2]
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = fmap[yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(inb[..., None], v, 0.0)

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return top * (1 - wy) + bot * wy


def _roi_grid(rois: torch.Tensor, out_size: int):
    """The out_size x out_size cell centres of each RoI (R, 4) in image
    pixels -> ((R, S, S, 2) xy, width, height), the sides floored at 1e-3."""
    rw = (rois[:, 2] - rois[:, 0]).clamp_min(1e-3)
    rh = (rois[:, 3] - rois[:, 1]).clamp_min(1e-3)
    steps = (torch.arange(out_size, device=rois.device, dtype=rois.dtype)
             + 0.5) / out_size
    gx = rois[:, 0, None] + steps[None, :] * rw[:, None]   # (R, S)
    gy = rois[:, 1, None] + steps[None, :] * rh[:, None]
    grid = torch.stack(torch.broadcast_tensors(gx[:, None, :], gy[:, :, None]),
                       dim=-1)                             # (R, S, S, 2)
    return grid, rw, rh


def roi_align(feats, strides, rois: torch.Tensor, out_size: int) -> torch.Tensor:
    """Multi-level RoIAlign: feats, the (H_l, W_l, C) maps of one image
    (P2..P5); rois (R, 4) xyxy in image pixels -> (R, S, S, C). One sample
    at each cell centre, at ``grid / stride - 0.5`` on the map. The level,
    floor(4 + log2(sqrt(wh) / 224)) clipped to 2..5, is applied as a one-hot
    mix over the levels, as in the reference."""
    grid, rw, rh = _roi_grid(rois, out_size)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(rw * rh) / 224.0))
    lvl = lvl.clamp(2, 5).long() - 2
    onehot = F.one_hot(lvl, len(feats)).to(rois.dtype)      # (R, L)
    out = 0.0
    for li, (fmap, stride) in enumerate(zip(feats, strides)):
        sampled = _bilinear(fmap, grid / stride - 0.5)
        out = out + sampled * onehot[:, li, None, None, None]
    return out


def roi_align_single(fmap: torch.Tensor, stride: int, rois: torch.Tensor,
                     out_size: int) -> torch.Tensor:
    """Single-level RoIAlign (no level assignment) of one (H, W, C) map ->
    (R, S, S, C): how the semantic branch's stride-8 feature enters the RoI
    features."""
    return _bilinear(fmap, _roi_grid(rois, out_size)[0] / stride - 0.5)


# ---------------------------------------------------------------------------
# proposals and detections (MaskRCNNLogic's inference side)
# ---------------------------------------------------------------------------
def _top(scores: torch.Tensor, k: int):
    """The k largest values and their indices, lower indices first among
    equal values (as jax.lax.top_k); torch.topk leaves ties unordered."""
    top, idx = torch.sort(scores, descending=True, stable=True)
    return top[:k], idx[:k]


def proposals(cfg: Seg2DConfig, anchors: torch.Tensor, rpn_obj: torch.Tensor,
              rpn_box: torch.Tensor):
    """One image's RPN output (N,), (N, 4) -> (num_proposals, 4) boxes, their
    validity and sigmoid scores: the top ``pre_nms_topk`` by objectness,
    decoded, greedy NMS at ``proposal_nms_thresh``, the kept rows first."""
    k = cfg.pre_nms_topk
    scores, order = _top(rpn_obj, k)
    boxes = decode_deltas(rpn_box[order], anchors[order], cfg.image_size)
    keep = _greedy_suppress(boxes_iou_normal(boxes, boxes),
                            torch.isfinite(scores), cfg.proposal_nms_thresh)
    pos = torch.arange(k, device=rpn_obj.device)
    sel = torch.argsort(torch.where(keep, pos, k + pos))[:cfg.num_proposals]
    return boxes[sel], keep[sel], torch.sigmoid(scores[sel])


def decode_detections(cfg: Seg2DConfig, rois: torch.Tensor, roi_valid: torch.Tensor,
                      cls_logits: torch.Tensor, box_deltas: torch.Tensor):
    """Per class: softmax, decode, a stable descending sort, greedy NMS at
    ``test_nms_thresh`` over scores above ``test_score_thresh`` (a
    suppressed box keeps its slot at score 0); then the top
    ``max_detections`` over all classes -> boxes (D, 4), scores (D,),
    classes (D,) int32."""
    probs = torch.softmax(cls_logits, dim=-1)              # (R, K+1)
    boxes, scores, classes = [], [], []
    for k in range(cfg.num_classes):
        boxes_k = decode_deltas(box_deltas[:, k], rois, cfg.image_size)
        score_k = torch.where(roi_valid, probs[:, k + 1], 0.0)
        s, order = _top(score_k, score_k.shape[0])
        b = boxes_k[order]
        keep = _greedy_suppress(boxes_iou_normal(b, b), s > cfg.test_score_thresh,
                                cfg.test_nms_thresh)
        boxes.append(b)
        scores.append(torch.where(keep, s, 0.0))
        classes.append(torch.full(order.shape, k, dtype=torch.int32,
                                  device=order.device))
    top, idx = _top(torch.cat(scores), cfg.max_detections)
    return torch.cat(boxes)[idx], top, torch.cat(classes)[idx]


# ---------------------------------------------------------------------------
# training targets and losses (MaskRCNNLogic's training side)
# ---------------------------------------------------------------------------
def _one_hot(idx: torch.Tensor, k: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over k classes; an index outside [0, k) (the
    background's class - 1 = -1) reads all zeros, as jax.nn.one_hot."""
    return (idx[..., None] == torch.arange(k, device=idx.device)).to(torch.float32)


def rpn_targets(cfg: Seg2DConfig, anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor, u_fg: torch.Tensor, u_bg: torch.Tensor):
    """One image's RPN targets: gt_boxes (G, 4), gt_valid (G,), u_fg and
    u_bg (N,) U[0, 1) priorities -> (labels (N,) f32, deltas (N, 4), weights
    (N,) f32, fg (N,) bool). An anchor is positive at IoU >= rpn_pos_iou or
    as its ground truth's best anchor, negative below rpn_neg_iou; up to
    rpn_batch * rpn_fg_fraction positives and the rest of rpn_batch
    negatives are kept, the highest priorities first.

    The best-anchor marks are the reference's scatter with duplicate
    indices, ``zeros.at[best_anchor].set(gt_valid)``: a padding row's IoU is
    -1 everywhere, so it marks anchor 0 False, and where rows share an
    anchor the last row's value stands, as XLA's scatter on the CPU leaves
    it."""
    n, g = anchors.shape[0], gt_boxes.shape[0]
    iou = torch.where(gt_valid[None, :], boxes_iou_normal(anchors, gt_boxes), -1.0)
    best_gt = iou.argmax(1)
    best_iou = iou.amax(1)
    last = torch.full((n,), -1, dtype=torch.int64, device=anchors.device)
    last.scatter_reduce_(0, iou.argmax(0), torch.arange(g, device=anchors.device),
                         reduce="amax")
    force = (last >= 0) & gt_valid[last.clamp_min(0)]
    pos = (best_iou >= cfg.rpn_pos_iou) | force
    neg = (best_iou < cfg.rpn_neg_iou) & ~pos

    n_fg = int(cfg.rpn_batch * cfg.rpn_fg_fraction)
    fg = torch.zeros_like(pos)
    fg[_top(torch.where(pos, u_fg, -1.0), n_fg)[1]] = True
    fg &= pos
    bg = torch.zeros_like(neg)
    bg[_top(torch.where(neg, u_bg, -1.0), cfg.rpn_batch - n_fg)[1]] = True
    bg &= neg
    deltas = encode_deltas(gt_boxes[best_gt], anchors)
    return fg.to(torch.float32), deltas, (fg | bg).to(torch.float32), fg


def sample_rois(cfg: Seg2DConfig, props: torch.Tensor, prop_valid: torch.Tensor,
                gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                gt_valid: torch.Tensor, u_fg: torch.Tensor, u_bg: torch.Tensor):
    """One image's RoI sample of roi_batch rows from the proposals with the
    ground truth appended (P + G candidates; u_fg, u_bg their U[0, 1)
    priorities) -> (rois (S, 4), classes (S,) int32 (0 background),
    deltas (S, 4), is_fg (S,), matched (S,) the ground-truth row of each).

    The first roi_batch * roi_fg_fraction rows are the foreground picks
    (IoU >= roi_fg_iou), the rest the background picks (IoU in [0,
    roi_fg_iou)), each by priority. Where a stratum runs short its keys
    read -1 and the picks go on in index order: those rows still enter the
    sample, as background (class 0), and the box loss's cross-entropy
    averages over them, as in the reference."""
    boxes = torch.cat([props, gt_boxes])
    valid = torch.cat([prop_valid, gt_valid])
    iou = torch.where(gt_valid[None, :], boxes_iou_normal(boxes, gt_boxes), -1.0)
    best_gt = iou.argmax(1)
    best_iou = torch.where(valid, iou.amax(1), -1.0)
    fg = best_iou >= cfg.roi_fg_iou
    bg = (best_iou >= 0.0) & ~fg

    n_fg = int(cfg.roi_batch * cfg.roi_fg_fraction)
    fg_idx = _top(torch.where(fg, u_fg, -1.0), n_fg)[1]
    bg_idx = _top(torch.where(bg, u_bg, -1.0), cfg.roi_batch - n_fg)[1]
    idx = torch.cat([fg_idx, bg_idx])
    is_fg = torch.cat([fg[fg_idx], torch.zeros_like(fg[bg_idx])])
    rois, matched = boxes[idx], best_gt[idx]
    cls = torch.where(is_fg, gt_labels[matched] + 1, 0).to(torch.int32)
    return rois, cls, encode_deltas(gt_boxes[matched], rois), is_fg, matched


def rpn_loss(rpn_obj, rpn_box, labels, deltas, weights, fg):
    """Binary cross-entropy over the sampled anchors (mean by their count)
    plus smooth-L1 (beta 1/9) over the positives (mean by their count)."""
    cls = binary_cross_entropy_with_logits(rpn_obj, labels)
    cls = (cls * weights).sum() / weights.sum().clamp_min(1.0)
    reg = weighted_smooth_l1(rpn_box, deltas, fg.to(torch.float32), beta=1.0 / 9)
    reg = reg.sum() / fg.sum().clamp_min(1)
    return cls + reg, {"rpn_cls": cls, "rpn_reg": reg}


def box_loss(cfg: Seg2DConfig, cls_logits, box_deltas, cls_tgt, delta_tgt, is_fg):
    """Softmax cross-entropy over all sampled RoIs (mean) plus smooth-L1
    (beta 1) of the target class's deltas over the foreground RoIs."""
    onehot = _one_hot(cls_tgt, cfg.num_classes + 1)
    cls_loss = -(F.log_softmax(cls_logits, dim=-1) * onehot).sum(-1).mean()
    sel = _one_hot(cls_tgt - 1, cfg.num_classes)
    pred = (box_deltas * sel[..., None]).sum(1)
    fg_w = is_fg.to(torch.float32)
    reg = weighted_smooth_l1(pred, delta_tgt, fg_w, beta=1.0)
    reg_loss = reg.sum() / fg_w.sum().clamp_min(1.0)
    return cls_loss + reg_loss, {"box_cls": cls_loss, "box_reg": reg_loss}


def mask_targets(gt_masks: torch.Tensor, rois: torch.Tensor, matched: torch.Tensor,
                 mask_size: int = 28) -> torch.Tensor:
    """Each RoI's matched ground-truth mask (gt_masks (G, H, W)) sampled
    bilinearly at the mask_size x mask_size cell centres of the RoI, in
    image pixels (no half-pixel shift, unlike RoIAlign's), thresholded at
    0.5 -> (R, S, S) f32. The taps are gathered from the mask by index, and
    the four are mixed in ``_bilinear``'s order, so a value on 0.5 falls as
    the reference's does."""
    h, w = gt_masks.shape[1:]
    rw = (rois[:, 2] - rois[:, 0]).clamp_min(1e-3)
    rh = (rois[:, 3] - rois[:, 1]).clamp_min(1e-3)
    steps = (torch.arange(mask_size, device=rois.device, dtype=rois.dtype)
             + 0.5) / mask_size
    gx = rois[:, 0, None] + steps[None, :] * rw[:, None]   # (R, S)
    gy = rois[:, 1, None] + steps[None, :] * rh[:, None]
    x, y = torch.broadcast_tensors(gx[:, None, :], gy[:, :, None])   # (R, S, S)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    m = matched[:, None, None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = gt_masks[m, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(inb, v, 0.0)

    top = tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx
    bot = tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx
    return (top * (1 - wy) + bot * wy >= 0.5).to(torch.float32)


def assign_rois(rois: torch.Tensor, roi_valid: torch.Tensor, gt_boxes: torch.Tensor,
                gt_labels: torch.Tensor, gt_valid: torch.Tensor, fg_iou: float):
    """Targets of the given RoIs (R, 4) at a cascade stage's IoU threshold,
    with no new sample (Cascade R-CNN relabels the refined boxes) ->
    (classes (R,) int32 (0 background), deltas (R, 4), is_fg (R,), matched
    (R,) the best ground-truth row). A padding ground-truth row reads IoU
    -1; among equal IoUs the lowest row wins."""
    iou = torch.where(gt_valid[None, :], boxes_iou_normal(rois, gt_boxes), -1.0)
    best_gt = iou.argmax(1)
    best_iou = torch.where(roi_valid, iou.amax(1), -1.0)
    is_fg = best_iou >= fg_iou
    cls = torch.where(is_fg, gt_labels[best_gt] + 1, 0).to(torch.int32)
    return cls, encode_deltas(gt_boxes[best_gt], rois), is_fg, best_gt


def refine_rois(cfg: Seg2DConfig, rois: torch.Tensor, cls_logits: torch.Tensor,
                box_deltas: torch.Tensor) -> torch.Tensor:
    """Each RoI decoded with the deltas of its most probable foreground
    class (the first among equal probabilities) -> the next cascade stage's
    boxes (R, 4), detached, as proposals are."""
    k = torch.softmax(cls_logits, dim=-1)[:, 1:].argmax(-1)
    deltas = (box_deltas * _one_hot(k, cfg.num_classes)[..., None]).sum(1)
    return decode_deltas(deltas, rois, cfg.image_size).detach()


def semantic_loss(cfg: Seg2DConfig, sem_logits, gt_labels, gt_valid, gt_masks):
    """HTC's semantic cross-entropy: sem_logits (B, h, w, K + 1) against the
    union of the valid instance masks (gt_masks (B, G, H, W) >= 0.5, each
    pixel the largest label + 1 over the instances covering it, else 0),
    resized to (h, w) as ``jax.image.resize(..., "nearest")`` does
    (half-pixel centres: ``nearest-exact``); mean over the pixels."""
    lab = torch.where(gt_valid[:, :, None, None],
                      (gt_masks >= 0.5).to(torch.int32) * (gt_labels[:, :, None, None] + 1),
                      0)
    tgt = lab.amax(1).to(torch.float32)[:, None]            # (B, 1, H, W)
    tgt = F.interpolate(tgt, size=sem_logits.shape[1:3], mode="nearest-exact")[:, 0]
    onehot = _one_hot(tgt.to(torch.int64), cfg.num_classes + 1)
    return -(F.log_softmax(sem_logits, dim=-1) * onehot).sum(-1).mean()


def mask_loss(cfg: Seg2DConfig, mask_logits, mask_tgt, cls_tgt, is_fg):
    """Binary cross-entropy of the target class's 28x28 logits, averaged
    over the foreground RoIs' pixels."""
    sel = _one_hot(cls_tgt - 1, cfg.num_classes)                 # (R, K)
    logit = (mask_logits * sel[:, None, None, :]).sum(-1)        # (R, S, S)
    bce = binary_cross_entropy_with_logits(logit, mask_tgt)
    fg_w = is_fg.to(torch.float32)[:, None, None]
    return (bce * fg_w).sum() / (fg_w.sum() * bce.shape[1] * bce.shape[2]).clamp_min(1.0)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
class MaskRCNN(nn.Module):
    """Mask R-CNN, with HTC's parts where the config asks for them: the eval
    forward, and the training forward and loss."""

    def __init__(self, cfg: Seg2DConfig):
        super().__init__()
        self.cfg = cfg
        self.n_stage = max(int(cfg.cascade_stages), 1)
        # info flow: one mask head a cascade stage, chained
        self.n_mask = self.n_stage if cfg.mask_info_flow and self.n_stage > 1 else 1
        self.backbone = ResNetFPN(cfg.stage_sizes, cfg.stage_channels,
                                  cfg.fpn_channels, cfg.dcn_stages)
        self.rpn = RPNHead(cfg.fpn_channels)
        # stage 0 keeps the plain model's names, so its checkpoints load
        for s in range(self.n_stage):
            self.add_module(_stage_name("box_head", s), BoxHead(
                7 * 7 * cfg.fpn_channels, cfg.num_classes, cfg.box_hidden))
        for s in range(self.n_mask):
            self.add_module(_stage_name("mask_head", s), MaskHead(
                cfg.fpn_channels, cfg.num_classes, cfg.mask_channels, cfg.mask_convs,
                res_conv=s > 0))
        if cfg.semantic_branch:
            self.semantic_head = SemanticHead(cfg.fpn_channels, cfg.num_classes,
                                              cfg.fpn_channels, cfg.semantic_convs)
        anchors = np.concatenate(generate_anchors_2d(cfg.image_size,
                                                     strides=cfg.strides))
        self.register_buffer("anchors", torch.from_numpy(anchors),
                             persistent=False)

    @property
    def box_heads(self) -> list:
        return [getattr(self, _stage_name("box_head", s)) for s in range(self.n_stage)]

    @property
    def mask_heads(self) -> list:
        return [getattr(self, _stage_name("mask_head", s)) for s in range(self.n_mask)]

    def features(self, images: torch.Tensor):
        """images (B, H, W, 3) -> (FPN maps P2..P6 (B, C, H_l, W_l), RPN
        objectness (B, N), RPN deltas (B, N, 4)), N over all five levels."""
        feats = self.backbone(images.permute(0, 3, 1, 2))
        objs, deltas = zip(*[self.rpn(f) for f in feats])
        return feats, torch.cat(objs, dim=1), torch.cat(deltas, dim=1)

    @staticmethod
    def roi_maps(feats, i: int) -> list[torch.Tensor]:
        """Image i's P2..P5 laid out (H, W, C), as ``roi_align`` reads them."""
        return [f[i].permute(1, 2, 0).contiguous() for f in feats[:4]]

    def _aligner(self, feats, sem_feat, i: int):
        """-> align(rois, size): RoIAlign on image i's P2..P5, plus, with the
        semantic branch, the stride-8 semantic feature's single-level
        RoIAlign."""
        maps, strides = self.roi_maps(feats, i), self.cfg.strides[:4]
        sem = None if sem_feat is None else sem_feat[i].permute(1, 2, 0).contiguous()

        def align(rois, size):
            f = roi_align(maps, strides, rois, size)
            return f if sem is None else f + roi_align_single(sem, 8, rois, size)

        return align

    def _mask_chain(self, f14: torch.Tensor, upto: int) -> torch.Tensor:
        """Mask heads 0..upto on the same RoI features, each fed the previous
        one's pre-upsample feature -> head ``upto``'s logits."""
        last = None
        for head in self.mask_heads[:upto]:
            last = head(f14, last)[1]
        return self.mask_heads[upto](f14, last)[0]

    def forward(self, images: torch.Tensor, gt_boxes=None, gt_labels=None,
                gt_valid=None, gt_masks=None, train: bool = False,
                generator: torch.Generator | None = None,
                roi_u: torch.Tensor | None = None) -> dict:
        """images (B, H, W, 3) -> {rpn_obj (B, N), rpn_box (B, N, 4), ...},
        and with the semantic branch semantic_logits (B, H/8, W/8, K + 1).

        Eval (``train`` False): det_boxes (B, D, 4), det_scores (B, D),
        det_cls (B, D) int32, det_masks (B, D, 28, 28), the sigmoid of each
        detection's class logits (averaged over the stages' mask heads
        under info flow). A cascade refines the proposals through its
        stages, scores the final boxes with every stage's head and decodes
        with the log of their mean probabilities.

        Training (the module in training mode): gt_boxes (B, G, 4) xyxy,
        gt_labels (B, G) int, gt_valid (B, G) bool; gt_masks is taken for
        the reference's signature and read by ``loss``. -> rois (B, S, 4),
        roi_cls_tgt (B, S) int32, roi_delta_tgt (B, S, 4), roi_fg (B, S),
        roi_matched (B, S), cls_logits (B, S, K + 1), box_deltas (B, S, K,
        4), mask_logits (B, S, 28, 28, K), and for each cascade stage s > 0
        ``cascade_s{s}``: {cls_logits, box_deltas, cls_tgt, delta_tgt, fg,
        rois, matched} on that stage's refined and relabelled boxes, and its
        mask_logits under info flow. ``roi_u`` (B, 2, P + G), the fg and bg
        priorities of each image's candidates, is drawn from ``generator``
        unless given."""
        feats, rpn_obj, rpn_box = self.features(images)
        out = {"rpn_obj": rpn_obj, "rpn_box": rpn_box}
        sem_feat = None
        if self.cfg.semantic_branch:
            sem_logits, sem_feat = self.semantic_head(feats)
            out["semantic_logits"] = sem_logits.permute(0, 2, 3, 1)
        if train:
            if not self.training:
                raise ValueError("train=True needs the module in training mode "
                                 "(batch norm on the batch's statistics)")
            return {**out, **self._train_heads(feats, sem_feat, rpn_obj, rpn_box, gt_boxes,
                                               gt_labels, gt_valid, generator, roi_u)}
        cfg = self.cfg
        dets = []
        for i in range(images.shape[0]):
            align = self._aligner(feats, sem_feat, i)
            rois, valid, _ = proposals(cfg, self.anchors, rpn_obj[i], rpn_box[i])
            f7 = align(rois, 7)
            cls_logits, box_deltas = self.box_head(f7)
            if self.n_stage > 1:
                for head in self.box_heads[1:]:
                    rois = refine_rois(cfg, rois, cls_logits, box_deltas)
                    f7 = align(rois, 7)
                    cls_logits, box_deltas = head(f7)
                probs = [torch.softmax(cls_logits, dim=-1)] + [
                    torch.softmax(head(f7)[0], dim=-1) for head in self.box_heads[:-1]]
                # softmax(log p) is p: the plain decode on the mean probabilities
                cls_logits = torch.log(sum(probs) / len(probs) + 1e-9)
            boxes, scores, classes = decode_detections(cfg, rois, valid,
                                                       cls_logits, box_deltas)
            f14 = align(boxes, 14)
            pick = classes.long()[:, None, None, None]
            last, probs = None, []
            for head in self.mask_heads:
                logits, last = head(f14, last)
                probs.append(torch.sigmoid(
                    logits.gather(-1, pick.expand(*logits.shape[:3], 1))[..., 0]))
            dets.append((boxes, scores, classes, sum(probs) / len(probs)))
        for key, parts in zip(("det_boxes", "det_scores", "det_cls", "det_masks"),
                              zip(*dets)):
            out[key] = torch.stack(parts)
        return out

    def _train_heads(self, feats, sem_feat, rpn_obj, rpn_box, gt_boxes, gt_labels,
                     gt_valid, generator, roi_u) -> dict:
        cfg = self.cfg
        b = rpn_obj.shape[0]
        if roi_u is None:
            roi_u = torch.rand((b, 2, cfg.num_proposals + gt_boxes.shape[1]),
                               generator=generator, device=rpn_obj.device)
        aligners, samples = [], []
        for i in range(b):
            props, valid, _ = proposals(cfg, self.anchors, rpn_obj[i].detach(),
                                        rpn_box[i].detach())
            samples.append(sample_rois(cfg, props, valid, gt_boxes[i], gt_labels[i],
                                       gt_valid[i], roi_u[i, 0], roi_u[i, 1]))
            aligners.append(self._aligner(feats, sem_feat, i))
        out = {k: torch.stack(v) for k, v in zip(
            ("rois", "roi_cls_tgt", "roi_delta_tgt", "roi_fg", "roi_matched"),
            zip(*samples))}

        def heads(head, rois, size):
            """``head`` on the RoIs (B, S, 4), each aligned in its image."""
            res = head(torch.cat([aligners[i](rois[i], size) for i in range(b)]))
            if isinstance(res, tuple):
                return tuple(r.reshape(b, -1, *r.shape[1:]) for r in res)
            return res.reshape(b, -1, *res.shape[1:])

        out["cls_logits"], out["box_deltas"] = heads(self.box_head, out["rois"], 7)
        # each cascade stage refines the previous stage's boxes, relabels
        # them at its own IoU threshold, every RoI valid, and runs its head
        stage = out
        for s in range(1, self.n_stage):
            prev = (stage["rois"], stage["cls_logits"], stage["box_deltas"])
            rois = torch.stack([refine_rois(cfg, *(t[i] for t in prev)) for i in range(b)])
            targets = [assign_rois(rois[i], torch.ones_like(rois[i, :, 0], dtype=torch.bool),
                                   gt_boxes[i], gt_labels[i], gt_valid[i], cfg.cascade_ious[s])
                       for i in range(b)]
            stage = {k: torch.stack(v) for k, v in zip(
                ("cls_tgt", "delta_tgt", "fg", "matched"), zip(*targets))}
            stage["rois"] = rois
            stage["cls_logits"], stage["box_deltas"] = heads(self.box_heads[s], rois, 7)
            out[f"cascade_s{s}"] = stage
        # mask stage s on stage s's RoIs; under info flow heads 0..s-1 run
        # first on the same RoIs, feature only, and the gradient flows
        # through the chain (mmdet HTCRoIHead._mask_forward_train)
        for s in range(self.n_mask):
            where = out if s == 0 else out[f"cascade_s{s}"]
            where["mask_logits"] = heads(lambda f14: self._mask_chain(f14, s),
                                         where["rois"], 14)
        return out

    def loss(self, out: dict, gt_boxes, gt_labels, gt_valid, gt_masks,
             generator: torch.Generator | None = None,
             rpn_u: torch.Tensor | None = None):
        """The training forward's output and the ground truth (gt_masks (B,
        G, H, W) f32) -> (total, {rpn_cls, rpn_reg, box_cls, box_reg, mask,
        ...}), each term averaged over the batch. A cascade weighs stage s's
        box loss by ``cascade_weights[s]`` (stage 0's too) and reports it
        as box_cls_s{s} and box_reg_s{s}; under info flow the mask losses
        take the same weights, mask_s{s} on each stage's own RoIs; the
        semantic branch adds its cross-entropy at ``semantic_loss_weight``
        as ``semantic``. ``rpn_u`` (B, 2, N), the anchors' fg and bg
        priorities, is drawn from ``generator`` unless given."""
        cfg = self.cfg
        b = out["rpn_obj"].shape[0]
        if rpn_u is None:
            rpn_u = torch.rand((b, 2, self.anchors.shape[0]), generator=generator,
                               device=out["rpn_obj"].device)
        c_w = cfg.cascade_weights
        w0 = c_w[0] if self.n_stage > 1 else 1.0
        total, tb = 0.0, {}

        def add(key, v):
            tb[key] = tb.get(key, 0.0) + v / b

        for i in range(b):
            labels, deltas, w, fg = rpn_targets(cfg, self.anchors, gt_boxes[i],
                                                gt_valid[i], rpn_u[i, 0], rpn_u[i, 1])
            li, tbi = rpn_loss(out["rpn_obj"][i], out["rpn_box"][i], labels, deltas,
                               w, fg)
            total = total + li / b
            bi, tbb = box_loss(cfg, out["cls_logits"][i], out["box_deltas"][i],
                               out["roi_cls_tgt"][i], out["roi_delta_tgt"][i],
                               out["roi_fg"][i])
            total = total + w0 * bi / b
            for s in range(1, self.n_stage):
                cs = out[f"cascade_s{s}"]
                bs, tbs = box_loss(cfg, cs["cls_logits"][i], cs["box_deltas"][i],
                                   cs["cls_tgt"][i], cs["delta_tgt"][i], cs["fg"][i])
                total = total + c_w[s] * bs / b
                for k, v in tbs.items():
                    add(f"{k}_s{s}", v)
            mt = mask_targets(gt_masks[i], out["rois"][i], out["roi_matched"][i])
            ml = mask_loss(cfg, out["mask_logits"][i], mt, out["roi_cls_tgt"][i],
                           out["roi_fg"][i])
            total = total + (w0 if self.n_mask > 1 else 1.0) * ml / b
            for s in range(1, self.n_mask):
                cs = out[f"cascade_s{s}"]
                mt_s = mask_targets(gt_masks[i], cs["rois"][i], cs["matched"][i])
                ml_s = mask_loss(cfg, cs["mask_logits"][i], mt_s, cs["cls_tgt"][i],
                                 cs["fg"][i])
                total = total + c_w[s] * ml_s / b
                add(f"mask_s{s}", ml_s)
            for k, v in {**tbi, **tbb, "mask": ml}.items():
                add(k, v)
        if "semantic_logits" in out:
            ce = semantic_loss(cfg, out["semantic_logits"], gt_labels, gt_valid, gt_masks)
            total = total + cfg.semantic_loss_weight * ce
            tb["semantic"] = ce
        return total, tb


def _stage_name(head: str, s: int) -> str:
    return head if s == 0 else f"{head}_s{s}"
