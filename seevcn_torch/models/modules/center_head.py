"""CenterPoint's head: class heatmaps and dense box regression (port of
seevcn_tpu/models/modules/center_head.py; reference
pcdet/models/dense_heads/center_head.py:48-355).

A 3x3 shared conv with BN and ReLU, then for each target (``hm`` the class
heatmap, ``center`` the offset 2, ``center_z`` 1, ``dim`` 3, ``rot`` the
heading's cos and sin) one 3x3 conv with ReLU and a 3x3 output conv; the
branches have no BN, and the heatmap's output bias starts at -2.19, as in
the JAX package. Maps are NHWC at the module's ends. Training targets are a
Gaussian splat at each box's integer centre pixel (the max over boxes),
with the penalty-reduced focal loss on the heatmap and an L1 loss on the
regression at the centre pixels. Decoding keeps the 3x3 local maxima of
the heatmap's sigmoid and takes the top k over (H * W * C), class-minor,
by a stable descending sort, so that ties (the suppressed cells are exact
zeros) keep the lower index as ``jax.lax.top_k`` does.

Module names are the JAX package's (``shared_conv``, ``shared_bn``,
``sep.{name}_conv0``, ``sep.{name}_out``); the shared conv and the branch
convs carry biases, as flax's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_mean
from .common import BatchNorm2d

#: the head's targets and their channels, the class heatmap first
HEADS = (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2))
#: the heatmap output's initial bias (the focal prior)
HM_INIT_BIAS = -2.19


class SeparateHead(nn.Module):
    """Per-target conv branches over a BEV map: for each head one 3x3 conv
    (``head_conv`` channels) with ReLU, then a 3x3 conv to its channels."""

    def __init__(self, in_channels: int, heads: dict, head_conv: int = 64):
        super().__init__()
        self.heads = dict(heads)
        for name, ch in self.heads.items():
            self.add_module(f"{name}_conv0", nn.Conv2d(in_channels, head_conv, 3, padding=1))
            out = nn.Conv2d(head_conv, ch, 3, padding=1)
            nn.init.constant_(out.bias, HM_INIT_BIAS if name == "hm" else 0.0)
            self.add_module(f"{name}_out", out)
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> dict:
        """(B, C, H, W) -> {name: (B, H, W, ch)}."""
        out = {}
        for name in self.heads:
            h = self.relu(getattr(self, f"{name}_conv0")(x))
            out[name] = getattr(self, f"{name}_out")(h).permute(0, 2, 3, 1)
        return out


class CenterHead(nn.Module):
    """The shared conv (64 channels, as the JAX package fixes it) with BN
    and ReLU, then the ``SeparateHead``."""

    def __init__(self, in_channels: int, num_class: int, shared_ch: int = 64):
        super().__init__()
        self.shared_conv = nn.Conv2d(in_channels, shared_ch, 3, padding=1)
        self.shared_bn = BatchNorm2d(shared_ch, eps=1e-3, momentum=0.01)
        self.sep = SeparateHead(shared_ch, {"hm": num_class, **dict(HEADS)})
        self.relu = nn.ReLU()

    def forward(self, bev: torch.Tensor) -> dict:
        """(B, H, W, C) -> {hm (B, H, W, num_class), center, center_z, dim,
        rot}. The convs read a contiguous NCHW copy: on the NHWC map's
        channels-last view cuDNN's f32 shared conv (512 -> 64 at 100 x 88)
        took 54.18 ms against 0.31 ms (NVIDIA H100, chip_smoke.py phase
        17)."""
        x = self.relu(self.shared_bn(self.shared_conv(bev.permute(0, 3, 1, 2).contiguous())))
        return self.sep(x)


# --- targets ------------------------------------------------------------------


def gaussian_radius(dx, dy, min_overlap: float = 0.1):
    """CornerNet's radius heuristic (centernet_utils.gaussian_radius): the
    smallest of the three quadratics' roots."""
    b1 = dy + dx
    c1 = dx * dy * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0))) / 2
    b2 = 2 * (dx + dy)
    c2 = (1 - min_overlap) * dx * dy
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * 4 * c2, min=0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (dx + dy)
    c3 = (min_overlap - 1) * dx * dy
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def make_center_targets(gt_boxes: torch.Tensor, gt_mask: torch.Tensor, grid_hw,
                        point_cloud_range, voxel_size, stride: int, num_class: int,
                        min_radius: float = 2.0):
    """One frame's ground truth (M, 8) and its validity (M,) -> the heatmap
    (H, W, C), the regression targets (M, 8) [the offset of the centre
    from its pixel (2), z, log dims (3), cos and sin of the heading], the
    centre pixels (M, 2) [y, x], clipped onto the map, and whether each box
    is a valid one whose centre lies on the map (M,). Each box splats a
    Gaussian (sigma (2 r + 1) / 6, r the CornerNet radius, at least
    ``min_radius`` pixels) at its integer centre pixel into its class's
    channel; the heatmap keeps the max over boxes."""
    h, w = grid_hw
    dt = gt_boxes.dtype
    pcr = torch.tensor(point_cloud_range, dtype=dt, device=gt_boxes.device)
    vs = torch.tensor(voxel_size, dtype=dt, device=gt_boxes.device)
    fx = (gt_boxes[:, 0] - pcr[0]) / (vs[0] * stride)
    fy = (gt_boxes[:, 1] - pcr[1]) / (vs[1] * stride)
    xi = torch.floor(fx).to(torch.int32).clamp(0, w - 1)
    yi = torch.floor(fy).to(torch.int32).clamp(0, h - 1)
    inb = gt_mask & (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)

    dxp = gt_boxes[:, 3] / (vs[0] * stride)
    dyp = gt_boxes[:, 4] / (vs[1] * stride)
    radius = torch.clamp(gaussian_radius(dyp, dxp), min=min_radius)
    sigma = (2 * radius + 1) / 6.0
    ys = torch.arange(h, dtype=dt, device=gt_boxes.device)[:, None]
    xs = torch.arange(w, dtype=dt, device=gt_boxes.device)[None, :]
    xf, yf = xi.to(dt)[:, None, None], yi.to(dt)[:, None, None]
    g = torch.exp(-((xs - xf) ** 2 + (ys - yf) ** 2) / (2 * sigma[:, None, None] ** 2))
    g = torch.where(inb[:, None, None], g, 0.0)                        # (M, H, W)
    cls_ids = (gt_boxes[:, 7].to(torch.int32) - 1).clamp(0, num_class - 1)
    onehot = F.one_hot(cls_ids.long(), num_class).to(dt)               # (M, C)
    heat = (g[..., None] * onehot[:, None, None, :]).amax(0).clamp_min(0.0)

    reg = torch.stack([
        fx - xi.to(dt), fy - yi.to(dt), gt_boxes[:, 2],
        torch.log(gt_boxes[:, 3].clamp_min(1e-3)),
        torch.log(gt_boxes[:, 4].clamp_min(1e-3)),
        torch.log(gt_boxes[:, 5].clamp_min(1e-3)),
        torch.cos(gt_boxes[:, 6]), torch.sin(gt_boxes[:, 6])], 1)
    return heat, reg, torch.stack([yi, xi], 1), inb


def centernet_focal_loss(pred_hm: torch.Tensor, gt_hm: torch.Tensor,
                         alpha: float = 2.0, beta: float = 4.0) -> torch.Tensor:
    """The penalty-reduced focal loss (loss_utils.FocalLossCenterNet) of
    heatmap logits against targets, summed and divided by the positives
    (targets >= 1 - 1e-4; at least 1)."""
    p = torch.clamp(torch.sigmoid(pred_hm), 1e-4, 1 - 1e-4)
    pos = gt_hm >= 1.0 - 1e-4
    pos_loss = -torch.log(p) * (1 - p) ** alpha
    neg_loss = -torch.log(1 - p) * p ** alpha * (1 - gt_hm) ** beta
    loss = torch.where(pos, pos_loss, neg_loss)
    return loss.sum() / pos.sum().to(loss.dtype).clamp_min(1.0)


def center_head_loss(preds: dict, gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                     grid_hw, point_cloud_range, voxel_size, stride: int,
                     num_class: int):
    """The head's maps (B, H, W, ·) against the ground truth (B, M, 8) ->
    (heatmap loss, regression loss), each the mean over frames: per frame
    the focal loss, and the L1 of the 8 regression channels at the valid
    boxes' centre pixels, summed and divided by the valid boxes (at least
    1)."""
    hm_l, reg_l = [], []
    for b in range(gt_boxes.shape[0]):
        heat, reg, yx, ok = make_center_targets(
            gt_boxes[b], gt_mask[b], grid_hw, point_cloud_range, voxel_size, stride,
            num_class)
        hm_l.append(centernet_focal_loss(preds["hm"][b], heat))
        maps = torch.cat([preds[k][b] for k in ("center", "center_z", "dim", "rot")], -1)
        l1 = (maps[yx[:, 0].long(), yx[:, 1].long()] - reg).abs().sum(-1)
        okf = ok.to(l1.dtype)
        reg_l.append((l1 * okf).sum() / okf.sum().clamp_min(1.0))
    return global_mean(torch.stack(hm_l)), global_mean(torch.stack(reg_l))


def decode_center_boxes(preds: dict, point_cloud_range, voxel_size, stride: int,
                        k: int = 500):
    """The heatmap's 3x3 local maxima (|sigmoid - its 3x3 max| < 1e-6, the
    max pool padded with -inf), the top k of them over (H * W * C),
    class-minor, by a stable descending sort -> boxes (B, k, 7), their
    probabilities (B, k) and labels (B, k) int32 (1-based); k is at most H
    * W * C."""
    hm = torch.sigmoid(preds["hm"])                                     # (B, H, W, C)
    pooled = F.max_pool2d(hm.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    hm = torch.where((hm - pooled).abs() < 1e-6, hm, 0.0)
    b, h, w, c = hm.shape
    flat = hm.reshape(b, -1)
    k = min(k, flat.shape[1])
    scores, idx = torch.sort(flat, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :k], idx[:, :k]
    cls, pix = idx % c, idx // c
    yi, xi = pix // w, pix % w
    frame = torch.arange(b, device=hm.device)[:, None]

    def gather(m):
        return m[frame, yi, xi]

    center = gather(preds["center"])
    cz = gather(preds["center_z"])[..., 0]
    dim = torch.exp(gather(preds["dim"]))
    rot = gather(preds["rot"])
    heading = torch.atan2(rot[..., 1], rot[..., 0])
    dt = center.dtype
    pcr = torch.tensor(point_cloud_range, dtype=dt, device=hm.device)
    vs = torch.tensor(voxel_size, dtype=dt, device=hm.device)
    x = (xi.to(dt) + center[..., 0]) * vs[0] * stride + pcr[0]
    y = (yi.to(dt) + center[..., 1]) * vs[1] * stride + pcr[1]
    boxes = torch.stack([x, y, cz, dim[..., 0], dim[..., 1], dim[..., 2], heading], -1)
    return boxes, scores, (cls + 1).to(torch.int32)
