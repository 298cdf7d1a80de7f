"""CaDDN, the camera-only detector (Categorical Depth Distribution Network):
forward and training loss (port of seevcn_tpu/models/detectors/caddn.py;
reference detectors/caddn.py, backbones_3d/vfe/image_vfe.py and its ffn /
f2v modules, tools/cfgs/kitti_models/CaDDN.yaml).

Image features (B, h, w, C) at stride 4 and a categorical depth
distribution over the LID bins (softmax over D + 1 bins, the last, "beyond
range", dropped) -> each voxel of the lidar grid samples its frustum cell,
the product of the pixel's feature and the bin's probability ->
Conv2DCollapse (the z levels stacked into channels, a 1x1 conv block) ->
BaseBEVBackbone -> AnchorHeadSingle. The image backbone is FFN.DDN.NAME's:
``DDNDeepLabV3`` (``modules/ddn.py``, with a CHANNEL_REDUCE conv block and
the DDN focal loss of LOSS.NAME DDNLoss), or else ``ImageBackbone``, a
three-conv pyramid for small configs, with a 1x1 depth head and a
cross-entropy depth loss over the pixels with depth.

The sampling follows the JAX package, not OpenPCDet: the voxel centres map
to the rectified camera frame by fixed axes (x_r = -y, y_r = -z, z_r = x),
not by the frame's calibration, and each takes its nearest pixel (the
projection truncated), not ``grid_sample``'s bilinear mix (ROADMAP §3).

State-dict keys: the JAX package's module names (``ddn`` in torchvision's
DeepLabV3 names, ``channel_reduce``, ``image_backbone``, ``depth_head``,
``collapse``), then OpenPCDet's ``backbone_2d`` and ``dense_head``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_count
from ..losses import weighted_cross_entropy
from ..modules.common import conv_block2d
from ..modules.ddn import DDNDeepLabV3, ddn_focal_loss
from .second import _AnchorRPN


def lid_bin_edges(depth_min: float, depth_max: float, num_bins: int) -> np.ndarray:
    """The num_bins + 1 edges of the linear-increasing discretisation (the
    CaDDN paper's eq. 2), f64."""
    i = np.arange(num_bins + 1, dtype=np.float64)
    delta = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    return depth_min + delta * i * (i + 1) / 2


def depth_to_lid_bin(depth: torch.Tensor, depth_min: float, depth_max: float,
                     num_bins: int) -> torch.Tensor:
    """Depth -> LID bin index (int64), the reference's bin_depths(target=True):
    a depth below depth_min (the 0 of a pixel without depth), at or beyond
    depth_max, or not finite is bin ``num_bins``, "beyond range".

    The JAX package's expression in its order, rounded as its jitted model
    rounds it, so that a depth on a bin edge lands in JAX's bin: XLA folds
    the division by the constant ``delta`` into a product with its
    reciprocal, rounded to the depth's dtype, and its f32 sqrt is
    correctly rounded, where torch's vectorised CPU sqrt is not (it takes
    sqrt(1056.2498779) to 32.499996, not 32.5): the sqrt is taken in f64
    and rounded, which is the correctly rounded f32 sqrt."""
    delta = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
    recip = (1.0 / torch.tensor(delta, dtype=depth.dtype)).item()
    x = (2 * (depth - depth_min) * recip + 0.25).clamp_min(0.0)
    idx = torch.floor(-0.5 + torch.sqrt(x.double()).to(x.dtype)).to(torch.int64)
    invalid = ~torch.isfinite(depth) | (depth < depth_min) | (idx < 0) | (idx >= num_bins)
    return torch.where(invalid, num_bins, idx.clamp(0, num_bins))


def voxel_centres_rect(point_cloud_range, voxel_size, grid_size, device) -> torch.Tensor:
    """(nx * ny * nz, 4) homogeneous voxel centres in the rectified camera
    frame, x major, z minor: (i + 0.5) * size + start in f32 on each axis,
    then the fixed lidar -> rect axes (x_r = -y, y_r = -z, z_r = x)."""
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32, device=device)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=device)
    axes = [(torch.arange(int(n), dtype=torch.float32, device=device) + 0.5) * vs[i] + pcr[i]
            for i, n in enumerate(grid_size)]
    x, y, z = torch.meshgrid(*axes, indexing="ij")
    rect = torch.stack([-y, -z, x], dim=-1).reshape(-1, 3)
    return torch.cat([rect, torch.ones_like(rect[:, :1])], dim=1)


def frustum_indices(calib_p2: torch.Tensor, hom: torch.Tensor, feat_hw, stride: int,
                    depth_min: float, depth_max: float, num_bins: int):
    """Each voxel's frustum cell in each frame: calib_p2 (B, 3, 4), hom (V,
    4) from ``voxel_centres_rect`` -> (vi, ui, db, ok), each (B, V): the
    feature pixel's row and column, the depth bin, and whether the voxel
    projects in front of the camera, onto the map and into a bin.

    The pixel is the projection ``hom @ P2^T`` divided by the depth and by
    the stride, truncated toward 0 (JAX's astype(int32)). An f32 coordinate
    near a pixel edge can round across it on another device or in another
    dot's summation order (XLA's CPU dot against torch's): these are the
    choices a comparison pins (tests/test_torch_caddn.py, chip_smoke.py's
    ``selection_choices``)."""
    h, w = feat_hw
    uvw = hom @ calib_p2.transpose(-1, -2)                      # (B, V, 3)
    depth = uvw[..., 2]
    u = uvw[..., 0] / depth.clamp_min(1e-3) / stride
    v = uvw[..., 1] / depth.clamp_min(1e-3) / stride
    dbin = depth_to_lid_bin(depth, depth_min, depth_max, num_bins)
    ok = (depth > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h) & (dbin < num_bins)
    ui = u.to(torch.int32).clamp(0, w - 1)
    vi = v.to(torch.int32).clamp(0, h - 1)
    return vi, ui, dbin.clamp(0, num_bins - 1), ok


def frustum_to_voxels(feat: torch.Tensor, ddist: torch.Tensor, vi, ui, db, ok) -> torch.Tensor:
    """feat (B, h, w, C), ddist (B, h, w, D) and the cells of
    ``frustum_indices`` -> voxel features (B, V, C): ddist[vi, ui, db] *
    feat[vi, ui], 0 where not ``ok``.

    JAX builds the whole frustum (B, h, w, D, C), the outer product, and
    then gathers from it: 629 MB an image at CaDDN.yaml's widths. Gathering
    the two factors first and multiplying gives each element as the same
    single f32 product, so the forward is JAX's bit for bit; the backward's
    scatter-add (autograd's index_put with accumulate) sums a pixel's
    voxels in another order."""
    b, h, w, c = feat.shape
    pix = vi.long() * w + ui.long()                             # (B, V)
    bi = torch.arange(b, device=feat.device)[:, None]
    f = feat.reshape(b, h * w, c)[bi, pix]                       # (B, V, C)
    d = ddist.reshape(b, h * w, ddist.shape[-1])[bi, pix, db.long()]
    return torch.where(ok, d, 0.0)[..., None] * f


class ImageBackbone(nn.Module):
    """A three-conv pyramid standing in for DeepLabV3 (stride 4): conv
    blocks of ``channels`` / 2 at stride 2, ``channels`` at stride 2, then
    ``channels``. NHWC in and out."""

    def __init__(self, channels: int = 64):
        super().__init__()
        self.c1 = nn.Sequential(*conv_block2d(3, channels // 2, stride=2))
        self.c2 = nn.Sequential(*conv_block2d(channels // 2, channels, stride=2))
        self.c3 = nn.Sequential(*conv_block2d(channels, channels))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.c3(self.c2(self.c1(images.permute(0, 3, 1, 2)))).permute(0, 2, 3, 1)


class CaDDN(_AnchorRPN):
    """CaDDN on images (B, H, W, 3) in [0, 1] and their P2 (B, 3, 4)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        ffn = cfg.model_cfg.VFE.FFN
        disc = ffn.DISCRETIZE
        self.num_bins = int(disc["num_bins"])
        self.depth_min, self.depth_max = float(disc["depth_min"]), float(disc["depth_max"])
        ddn_cfg = ffn.get("DDN", {})
        self.channel_reduce = None
        if ddn_cfg.get("NAME") == "DDNDeepLabV3":
            args = ddn_cfg.get("ARGS", {})
            width = int(args.get("width", 64))
            self.ddn = DDNDeepLabV3(self.num_bins + 1, ddn_cfg.get("BACKBONE_NAME", "ResNet101"),
                                    width, bool(args.get("use_pretrained_norm", True)))
            c = 4 * width
            cr = ffn.get("CHANNEL_REDUCE")
            if cr:
                self.channel_reduce = nn.Sequential(*conv_block2d(
                    c, int(cr["out_channels"]), kernel=int(cr.get("kernel_size", 1)),
                    stride=int(cr.get("stride", 1)), padding=int(cr.get("padding", 0))))
                c = int(cr["out_channels"])
        else:
            self.image_backbone = ImageBackbone(64)
            self.depth_head = nn.Conv2d(64, self.num_bins + 1, 1)
            c = 64
        nz = int(cfg.grid_size[2])
        bev = int(cfg.model_cfg.MAP_TO_BEV.NUM_BEV_FEATURES)
        self.collapse = nn.Sequential(*conv_block2d(c * nz, bev, kernel=1, padding=0))
        self._init_head(cfg, bev)
        self._hom = None

    def image_features(self, images: torch.Tensor):
        """images (B, H, W, 3) -> (features (B, h, w, C), depth logits (B, h,
        w, D + 1)), NHWC."""
        if hasattr(self, "ddn"):
            feat, logits = self.ddn(images)
            if self.channel_reduce is not None:
                feat = self.channel_reduce(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            return feat, logits
        feat = self.image_backbone(images)
        return feat, self.depth_head(feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def voxel_hom(self, device) -> torch.Tensor:
        """The grid's homogeneous rect voxel centres (``voxel_centres_rect``),
        made once a device."""
        if self._hom is None or self._hom.device != device:
            cfg = self.cfg
            self._hom = voxel_centres_rect(cfg.point_cloud_range, cfg.voxel_size,
                                           cfg.grid_size, device)
        return self._hom

    def frustum_bev(self, feat: torch.Tensor, depth_logits: torch.Tensor,
                    calib_p2: torch.Tensor, stride: int) -> torch.Tensor:
        """Image features and depth logits -> the BEV map (B, C nz, ny, nx)
        before the collapse conv: the frustum sampled at every voxel, z
        levels stacked into channels c major (Conv2DCollapse's flatten)."""
        b, h, w, c = feat.shape
        # softmax over all D + 1 bins, then the "beyond range" slot dropped
        # (depth_ffn.create_frustum_features): mass can leak out of range
        ddist = torch.softmax(depth_logits, dim=-1)[..., :self.num_bins]
        hom = self.voxel_hom(feat.device).to(calib_p2.dtype)
        vi, ui, db, ok = frustum_indices(calib_p2, hom, (h, w), stride, self.depth_min,
                                         self.depth_max, self.num_bins)
        vox = frustum_to_voxels(feat, ddist, vi, ui, db, ok)
        nx, ny, nz = (int(g) for g in self.cfg.grid_size)
        return vox.view(b, nx, ny, nz, c).permute(0, 4, 3, 2, 1).reshape(b, c * nz, ny, nx)

    def forward(self, images: torch.Tensor, calib_p2: torch.Tensor,
                gt_boxes: torch.Tensor | None = None, generator=None,
                roi_u: torch.Tensor | None = None) -> dict:
        """images (B, H, W, 3), calib_p2 (B, 3, 4) -> head_out,
        batch_cls_preds, batch_box_preds and depth_logits (B, h, w, D + 1).
        The same in training (the ground truth reaches only ``loss``;
        ``generator`` and ``roi_u`` are not used: this detector draws
        nothing)."""
        feat, depth_logits = self.image_features(images)
        stride = images.shape[1] // feat.shape[1]
        bev = self.collapse(self.frustum_bev(feat, depth_logits, calib_p2, stride))
        _, head_out, cls_preds, box_preds = self.bev_head(bev.permute(0, 2, 3, 1))
        return {"head_out": head_out, "batch_cls_preds": cls_preds,
                "batch_box_preds": box_preds, "depth_logits": depth_logits}

    def depth_loss(self, depth_logits: torch.Tensor, depth_maps: torch.Tensor,
                   gt_boxes2d: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """The depth supervision: the depth maps (B, H, W) strided to the
        logits' resolution (``[::s, ::s]``, not pooled) and binned, then
        DDNLoss's focal loss with the fg / bg balancer over ``gt_boxes2d``
        (B, N, 4), or without LOSS a cross-entropy over the pixels with a
        depth above 0. -> (loss, terms)."""
        ffn = self.cfg.model_cfg.VFE.FFN
        nb = self.num_bins
        b, h, w, _ = depth_logits.shape
        stride = depth_maps.shape[1] // h
        gt_d = depth_maps[:, ::stride, ::stride][:, :h, :w]
        bins = depth_to_lid_bin(gt_d, self.depth_min, self.depth_max, nb).clamp(0, nb)
        loss_cfg = ffn.get("LOSS")
        if loss_cfg is not None and loss_cfg.get("NAME") == "DDNLoss":
            args = loss_cfg.get("ARGS", {})
            return ddn_focal_loss(
                depth_logits, bins, gt_boxes2d, alpha=float(args.get("alpha", 0.25)),
                gamma=float(args.get("gamma", 2.0)),
                fg_weight=float(args.get("fg_weight", 13.0)),
                bg_weight=float(args.get("bg_weight", 1.0)), downsample_factor=stride,
                weight=float(args.get("weight", 3.0)))
        valid = (gt_d > 0).to(depth_logits.dtype)
        one_hot = F.one_hot(bins, nb + 1).to(depth_logits.dtype)
        ddn = weighted_cross_entropy(depth_logits.reshape(b, -1, nb + 1),
                                     one_hot.reshape(b, -1, nb + 1), valid.reshape(b, -1))
        ddn_loss = ddn.sum() / global_count(valid.sum()).clamp_min(1.0)
        return ddn_loss, {"ddn_loss": ddn_loss}

    def loss(self, out: dict, gt_boxes: torch.Tensor, depth_maps: torch.Tensor | None = None,
             gt_boxes2d: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """-> (total, terms rpn_loss_cls, rpn_loss_loc, rpn_loss_dir, rpn_loss
        and, given depth maps, ddn_loss (and fg_loss, bg_loss with DDNLoss
        and 2D boxes)): the RPN's loss plus the depth loss."""
        total, tb = self.rpn_loss(out, gt_boxes)
        if depth_maps is not None:
            ddn_loss, ddn_tb = self.depth_loss(out["depth_logits"], depth_maps, gt_boxes2d)
            tb.update(ddn_tb)
            total = total + ddn_loss
        return total, tb
