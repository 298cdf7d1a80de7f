"""The depth distribution network (DDN) of CaDDN: DeepLabV3 over a dilated
ResNet, and its focal loss with the foreground balancer (port of
seevcn_tpu/models/modules/ddn.py; reference image_vfe_modules/ffn/ddn/
ddn_deeplabv3.py, ddn_template.py and ffn/ddn_loss/{ddn_loss,balancer}.py).

Modules carry torchvision's ``deeplabv3_resnet{50,101}`` names, so that the
state dict of such a model (``utils/ckpt.py:deeplabv3_state_dict_from_torch``)
loads with ``strict=True``: ``backbone.conv1``, ``backbone.layer{s}.{b}.
conv{1,2,3}`` / ``bn{1,2,3}`` / ``downsample.{0,1}``, ``classifier.0`` the
ASPP (``convs.{0..3}``, ``convs.4`` the pooling branch, ``project``),
``classifier.1``-``3`` the 3x3 head conv, its BN and ReLU, ``classifier.4``
the logits. Two departures from torchvision follow the JAX package: the
ASPP projection has no Dropout(0.5), and the logits are resized
bilinearly to the stride-4 features (layer1's), not to the image.

Images and outputs are NHWC, as in the JAX package; NCHW inside. Every
ReLU is an ``nn.ReLU`` module (torchvision's ``relu``), so that a check
can record or pin its signs. Batch norm
is ``common.BatchNorm2d`` (eps 1e-5, torch momentum 0.1 = flax's 0.9; the
training variance the mean of squared deviations).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import dp_world, global_mean, stats_world
from .common import BatchNorm2d, global_moments

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: torchvision's ResNet depths, and the one-block variant of the tests
RESNET_LAYERS = {"ResNet50": (3, 4, 6, 3), "ResNet101": (3, 4, 23, 3),
                 "ResNetTiny": (1, 1, 1, 1)}


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck: 1x1 -> 3x3 (stride, dilation) -> 1x1
    (x4), with a strided 1x1 + BN downsample on the shortcut."""

    def __init__(self, cin: int, planes: int, stride: int = 1, dilation: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        d = dilation
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=d, dilation=d,
                               bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, planes * 4, 1, stride=stride, bias=False),
            _bn(planes * 4)) if has_downsample else None
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return self.relu(y + r)


class ResNetDeepLab(nn.Module):
    """ResNet with layer3 and layer4 dilated (output stride 8):
    -> (layer1's features at stride 4, layer4's at stride 8), NCHW."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), width: int = 64):
        super().__init__()
        w = width
        self.conv1 = nn.Conv2d(3, w, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(w)
        self.relu = nn.ReLU()
        # (planes, first block's stride, dilation) of torchvision's
        # replace_stride_with_dilation = [False, True, True]
        spec = [(w, 1, 1), (w * 2, 2, 1), (w * 4, 1, 2), (w * 8, 1, 4)]
        cin = w
        for si, ((planes, stride, dil), n) in enumerate(zip(spec, layers), start=1):
            blocks = []
            for bi in range(n):
                first = bi == 0
                # the dilated stages' first block keeps the previous
                # dilation on its 3x3 (torchvision): dil // 2, at least 1.
                # Every stage's first block changes the channel count, so
                # it always carries a downsample
                blocks.append(Bottleneck(cin, planes, stride=stride if first else 1,
                                         dilation=max(dil // 2, 1) if first else dil,
                                         has_downsample=first))
                cin = planes * 4
            self.add_module(f"layer{si}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        x = self.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        f4 = x = self.layer1(x)
        x = self.layer4(self.layer3(self.layer2(x)))
        return f4, x


class _ConvBNReLU(nn.Sequential):
    def __init__(self, cin: int, cout: int, kernel: int = 1, dilation: int = 1):
        super().__init__(nn.Conv2d(cin, cout, kernel, padding=dilation * (kernel // 2),
                                   dilation=dilation, bias=False),
                         _bn(cout), nn.ReLU())


class _PoolBatchNorm(BatchNorm2d):
    """The pooling branch's batch norm: over B values a channel in
    training, which is one at batch 1; torch's batch_norm refuses that and
    flax gives the bias (the variance 0), so the training forward is
    written out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if stats_world() > 1:
            mean, var = global_moments(x, [0, 2, 3])
        else:
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), unbiased=False)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach() * m)
            self.running_var.mul_(1 - m).add_(var.detach() * m)
            self.num_batches_tracked.add_(1)
        y = (x - mean[None, :, None, None]) * torch.rsqrt(var + self.eps)[None, :, None, None]
        return y * self.weight[None, :, None, None] + self.bias[None, :, None, None]


class _ASPPPooling(nn.Sequential):
    """Global mean -> 1x1 conv -> BN -> ReLU, broadcast over the map
    (torchvision's ASPPPooling)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.AdaptiveAvgPool2d(1), nn.Conv2d(cin, cout, 1, bias=False),
                         _PoolBatchNorm(cout, eps=1e-5, momentum=0.1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, *x.shape[2:])


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (torchvision's, rates 12 / 24 / 36):
    a 1x1 branch, three dilated 3x3 branches, the pooling branch,
    concatenated and projected to ``channels`` (no Dropout, as in the JAX
    package)."""

    def __init__(self, cin: int, channels: int = 256, rates: Sequence[int] = (12, 24, 36)):
        super().__init__()
        self.convs = nn.ModuleList([_ConvBNReLU(cin, channels)]
                                   + [_ConvBNReLU(cin, channels, 3, r) for r in rates]
                                   + [_ASPPPooling(cin, channels)])
        self.project = _ConvBNReLU(channels * (len(rates) + 2), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


class DDNDeepLabV3(nn.Module):
    """DeepLabV3 depth distribution network: images (B, H, W, 3) in [0, 1]
    -> (features (B, H/4, W/4, 4 width), depth logits (B, H/4, W/4,
    num_classes)), NHWC.

    With ``pretrained_norm`` the image is normalised by ImageNet's mean and
    std with every exact zero (a padded pixel's channel) kept at zero, per
    element as in the JAX package."""

    def __init__(self, num_classes: int, backbone_name: str = "ResNet101", width: int = 64,
                 pretrained_norm: bool = True):
        super().__init__()
        self.pretrained_norm = pretrained_norm
        self.backbone = ResNetDeepLab(RESNET_LAYERS[backbone_name], width)
        c = 4 * width
        self.classifier = nn.Sequential(
            ASPP(32 * width, c),                       # layer4: 8 width x 4
            nn.Conv2d(c, c, 3, padding=1, bias=False), _bn(c), nn.ReLU(),
            nn.Conv2d(c, num_classes, 1))

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        mean = images.new_tensor(IMAGENET_MEAN)
        std = images.new_tensor(IMAGENET_STD)
        return torch.where(images == 0, 0.0, (images - mean) / std)

    def forward(self, images: torch.Tensor):
        x = self.normalize(images) if self.pretrained_norm else images
        f4, f8 = self.backbone(x.permute(0, 3, 1, 2))
        logits = self.classifier(f8)
        # jax.image.resize(..., "bilinear") upsampling: half-pixel centres,
        # the edge pixel read past the border
        logits = F.interpolate(logits, size=f4.shape[-2:], mode="bilinear",
                               align_corners=False)
        return f4.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------- #
# the DDN loss: focal loss over the depth bins and the fg / bg balancer
# --------------------------------------------------------------------------- #

def fg_mask_from_boxes2d(gt_boxes2d: torch.Tensor, shape, downsample_factor: int = 1):
    """(B, N, 4) x1 y1 x2 y2 pixel boxes -> (B, H, W) bool foreground at the
    downsampled resolution (loss_utils.compute_fg_mask): a pixel is inside
    from floor(x1 / s) to below ceil(x2 / s); boxes with no extent (the
    zero padding rows) mark nothing."""
    b, h, w = shape
    boxes = gt_boxes2d / downsample_factor
    x1, y1 = torch.floor(boxes[..., 0]), torch.floor(boxes[..., 1])
    x2, y2 = torch.ceil(boxes[..., 2]), torch.ceil(boxes[..., 3])
    valid = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
    ys = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[None, :, None, None]
    xs = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, None, :, None]
    inside = ((xs >= x1[:, None, None, :]) & (xs < x2[:, None, None, :])
              & (ys >= y1[:, None, None, :]) & (ys < y2[:, None, None, :]))
    return (inside & valid[:, None, None, :]).any(-1)


def ddn_focal_loss(depth_logits: torch.Tensor, depth_targets: torch.Tensor,
                   gt_boxes2d: torch.Tensor | None = None, *, alpha: float = 0.25,
                   gamma: float = 2.0, fg_weight: float = 13.0, bg_weight: float = 1.0,
                   downsample_factor: int = 1, weight: float = 3.0):
    """kornia's FocalLoss(alpha, gamma, reduction='none') over the bins,
    then the Balancer (foreground pixels weighted ``fg_weight``, the rest
    ``bg_weight``, each sum over all B H W pixels) and LOSS.ARGS' weight.
    depth_logits (B, H, W, D + 1), depth_targets (B, H, W) bin indices.
    -> (total, terms ddn_loss and, with boxes, fg_loss and bg_loss)."""
    logp = F.log_softmax(depth_logits, dim=-1)
    logpt = torch.gather(logp, -1, depth_targets.long()[..., None])[..., 0]
    pt = torch.exp(logpt)
    loss = -alpha * (1.0 - pt) ** gamma * logpt                 # (B, H, W)
    tb = {}
    if gt_boxes2d is not None:
        fg = fg_mask_from_boxes2d(gt_boxes2d, loss.shape, downsample_factor)
        wloss = loss * torch.where(fg, fg_weight, bg_weight)
        n = float(loss.numel() * dp_world())
        fg_loss = torch.where(fg, wloss, 0.0).sum() / n
        bg_loss = torch.where(fg, 0.0, wloss).sum() / n
        total = (fg_loss + bg_loss) * weight
        tb.update(fg_loss=fg_loss * weight, bg_loss=bg_loss * weight)
    else:
        total = global_mean(loss) * weight
    tb["ddn_loss"] = total
    return total, tb
