"""Shared layers of the detector and the mask network (port of
seevcn_tpu/models/modules/common.py).

Batch norm in training keeps the reference's statistics: it normalises with
the batch's mean and biased variance, as torch does, and moves the running
statistics by flax's rule, ``ra = 0.99 ra + 0.01 batch`` with the **biased**
variance. torch's own update uses the unbiased one; the forward and the
gradients are the same either way, only the running variance would differ.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dcn import modulated_deform_conv2d


# flax's truncated_normal draws a standard normal cut at +-2; this is its
# standard deviation, by which lecun_normal divides to keep 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init (variance_scaling(1, "fan_in",
    "truncated_normal")): a normal truncated at two standard deviations,
    variance 1 / fan_in, drawn by inverting its CDF from ``generator``."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator) * (1.0 - 2.0 * lo) + lo
    z = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp(-2.0, 2.0)
    return z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


@torch.no_grad()
def _update_running(bn, mean: torch.Tensor, var: torch.Tensor) -> None:
    m = bn.momentum
    bn.running_mean.mul_(1 - m).add_(mean.detach() * m)
    bn.running_var.mul_(1 - m).add_(var.detach() * m)
    bn.num_batches_tracked.add_(1)


class _FlaxStatsBatchNorm:
    """Training forward of a BatchNorm{1,2}d with flax's running update; an
    input of a narrower dtype than the parameters (a bf16 conv's output) is
    normalised in theirs, as flax promotes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
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
    computed in f32 as the reference writes it (in f64 for a model in
    double), and zero on invalid rows. In
    training the mean and the biased variance are taken over the valid rows
    only, so padding cannot reach the statistics."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__(channels, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
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


class DeformConv2d(nn.Module):
    """A deformable conv that predicts its own offsets (and, when
    ``modulated``, its modulation), as the reference's ``DeformConv2d``
    (mmcv's DeformConvPack / ModulatedDeformConvPack): NCHW in and out, the
    sampling in ``ops/dcn.py``. ``offset_conv`` is a k x k conv at the
    layer's stride, padded k // 2, with a bias; it starts at zero, so the
    layer starts as a plain convolution (v2's modulation at sigmoid(0) =
    0.5). ``weight`` is the flax ``kernel``, held as a Conv2d's (Cout, Cin,
    k, k); v2's mask is the sigmoid of the last DG * K offset channels."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int = 3,
                 stride: int = 1, deform_groups: int = 1, modulated: bool = False,
                 use_bias: bool = False):
        super().__init__()
        k = kernel_size
        self.stride, self.deform_groups, self.modulated = stride, deform_groups, modulated
        n_off = deform_groups * k * k * (3 if modulated else 2)
        self.offset_conv = nn.Conv2d(in_channels, n_off, k, stride, padding=k // 2)
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        self.weight = nn.Parameter(torch.empty(channels, in_channels, k, k))
        self.bias = nn.Parameter(torch.zeros(channels)) if use_bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        n = self.deform_groups * k * k * 2
        om = self.offset_conv(x).permute(0, 2, 3, 1)
        mask = torch.sigmoid(om[..., n:]) if self.modulated else None
        out = modulated_deform_conv2d(
            x.permute(0, 2, 3, 1), om[..., :n], mask, self.weight.permute(2, 3, 1, 0),
            self.bias, stride=self.stride, padding=k // 2,
            deform_groups=self.deform_groups)
        return out.permute(0, 3, 1, 2)
