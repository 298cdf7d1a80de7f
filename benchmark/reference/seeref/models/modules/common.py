"""Layers the detector and the VCN share: batch norms that normalise in the
parameters' dtype, the masked batch norm of the sparse backbone, and the
conv-BN-ReLU blocks of the BEV backbone (keys as OpenPCDet's)."""
from __future__ import annotations

import torch
from torch import nn


class _Promoting:
    """A batch norm whose input is first promoted to its parameters' dtype
    (a bf16 conv's output is normalised in f32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.promote_types(x.dtype, self.weight.dtype)))


class BatchNorm1d(_Promoting, nn.BatchNorm1d):
    pass


class BatchNorm2d(_Promoting, nn.BatchNorm2d):
    pass


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm1d (eps 1e-3) over the valid rows of (N, C) voxel features:
    in training the mean and the biased variance of the valid rows only,
    zero on the rows that are not valid."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__(channels, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        if self.training:
            v = x[mask]
            mean, var = v.mean(0), v.var(0, unbiased=False)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[:, None], y, 0.0)


def conv_block2d(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1) -> list[nn.Module]:
    """Conv2d (no bias) + BN (eps 1e-3, momentum 0.01) + ReLU, as a list, so
    that an nn.Sequential keeps OpenPCDet's key names."""
    return [nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False),
            BatchNorm2d(cout, eps=1e-3, momentum=0.01), nn.ReLU()]


def deconv_block2d(cin: int, cout: int, stride: int = 1) -> list[nn.Module]:
    """ConvTranspose2d (kernel = stride, no bias) + BN + ReLU."""
    return [nn.ConvTranspose2d(cin, cout, stride, stride=stride, bias=False),
            BatchNorm2d(cout, eps=1e-3, momentum=0.01), nn.ReLU()]
