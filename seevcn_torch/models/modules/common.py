"""Shared layers of the detector (port of seevcn_tpu/models/modules/common.py).

Batch norm in training keeps the reference's statistics: it normalises with
the batch's mean and biased variance, as torch does, and moves the running
statistics by flax's rule, ``ra = 0.99 ra + 0.01 batch`` with the **biased**
variance. torch's own update uses the unbiased one; the forward and the
gradients are the same either way, only the running variance would differ.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


@torch.no_grad()
def _update_running(bn, mean: torch.Tensor, var: torch.Tensor) -> None:
    m = bn.momentum
    bn.running_mean.mul_(1 - m).add_(mean.detach() * m)
    bn.running_var.mul_(1 - m).add_(var.detach() * m)
    bn.num_batches_tracked.add_(1)


class _FlaxStatsBatchNorm:
    """Training forward of a BatchNorm{1,2}d with flax's running update."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.dim())]
        _update_running(self, x.mean(dims), x.var(dims, unbiased=False))
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BatchNorm1d(_FlaxStatsBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxStatsBatchNorm, nn.BatchNorm2d):
    pass


class MaskedBatchNorm(nn.BatchNorm1d):
    """BatchNorm over (N, C) rows of a fixed-capacity buffer, eps 1e-3 (the
    reference's BatchNorm1d on voxel features, spconv_backbone.py:73),
    computed in f32 as the reference writes it, and zero on invalid rows. In
    training the mean and the biased variance are taken over the valid rows
    only, so padding cannot reach the statistics."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__(channels, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            m = mask.to(x.dtype)[:, None]
            cnt = m.sum().clamp_min(1.0)
            mean = (x * m).sum(0) / cnt
            var = (((x - mean) ** 2) * m).sum(0) / cnt
            _update_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return torch.where(mask[:, None], y, 0.0)


def conv_block2d(cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1) -> list[nn.Module]:
    """ConvBlock2d: Conv2d (no bias) + BN (eps 1e-3, momentum 0.01) + ReLU,
    as a list of layers, so a reference nn.Sequential keeps its key names."""
    return [nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding,
                      bias=False),
            BatchNorm2d(cout, eps=1e-3, momentum=0.01), nn.ReLU()]


def deconv_block2d(cin: int, cout: int, stride: int = 1) -> list[nn.Module]:
    """DeconvBlock2d: ConvTranspose2d (kernel = stride, no bias) + BN + ReLU."""
    return [nn.ConvTranspose2d(cin, cout, stride, stride=stride, bias=False),
            BatchNorm2d(cout, eps=1e-3, momentum=0.01), nn.ReLU()]
