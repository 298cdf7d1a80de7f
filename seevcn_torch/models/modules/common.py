"""Shared layers of the detector (port of the eval side of
seevcn_tpu/models/modules/common.py)."""
from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over (N, C) rows of a fixed-capacity buffer, in eval: the
    running statistics, eps 1e-3 (the reference's BatchNorm1d on voxel
    features, spconv_backbone.py:73), computed in f32 as the reference
    writes it, and zero on invalid rows."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__(channels, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("MaskedBatchNorm is ported for eval only")
        y = (x.float() - self.running_mean) * torch.rsqrt(self.running_var + self.eps) \
            * self.weight + self.bias
        return torch.where(mask[:, None], y, 0.0)


def conv_block2d(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1) -> list[nn.Module]:
    """ConvBlock2d: Conv2d (no bias) + BN (eps 1e-3, momentum 0.01) + ReLU,
    as a list of layers, so a reference nn.Sequential keeps its key names."""
    return [nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                      bias=False),
            nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01), nn.ReLU()]


def deconv_block2d(cin: int, cout: int, stride: int = 1) -> list[nn.Module]:
    """DeconvBlock2d: ConvTranspose2d (kernel = stride, no bias) + BN + ReLU."""
    return [nn.ConvTranspose2d(cin, cout, stride, stride=stride, bias=False),
            nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01), nn.ReLU()]
