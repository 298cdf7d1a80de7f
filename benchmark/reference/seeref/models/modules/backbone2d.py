"""OpenPCDet's BaseBEVBackbone (base_bev_backbone.py): per level a strided
3x3 conv and LAYER_NUMS[i] 3x3 convs (conv-BN-ReLU, no bias) after a
ZeroPad2d, then an upsample per level (a transposed conv of kernel and
stride s) and a channel concat. ``dtype`` (BACKBONE_2D.DTYPE) is the convs'
compute dtype only; batch norm runs on f32 parameters."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import conv_block2d, deconv_block2d


class BaseBEVBackbone(nn.Module):
    def __init__(self, input_channels: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[float] = (),
                 num_upsample_filters: Sequence[int] = (), dtype: str | None = None):
        super().__init__()
        self.compute_dtype = None if dtype is None else getattr(torch, str(dtype))
        self.layer_strides = [int(s) for s in layer_strides]
        self.upsample_strides = [float(s) for s in upsample_strides]
        levels = len(layer_nums)
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        cin = input_channels
        for i, n in enumerate(layer_nums):
            # ZeroPad2d(1) + unpadded conv, as the reference builds it
            layers = [nn.ZeroPad2d(1), *conv_block2d(cin, num_filters[i],
                                                     stride=layer_strides[i],
                                                     padding=0)]
            for _ in range(n):
                layers += conv_block2d(num_filters[i], num_filters[i])
            self.blocks.append(nn.Sequential(*layers))
            if upsample_strides:
                s = upsample_strides[i]
                if s >= 1:
                    up = deconv_block2d(num_filters[i], num_upsample_filters[i], int(s))
                else:
                    k = int(round(1 / s))
                    up = conv_block2d(num_filters[i], num_upsample_filters[i], kernel=k,
                                      stride=k, padding=0)
                self.deblocks.append(nn.Sequential(*up))
            cin = num_filters[i]
        joined = int(sum(num_upsample_filters[:levels])) if upsample_strides \
            else int(sum(num_filters))
        if len(upsample_strides) > levels:
            self.deblocks.append(nn.Sequential(*deconv_block2d(
                joined, joined, int(upsample_strides[-1]))))
        self.num_bev_features = int(sum(num_upsample_filters)) if num_upsample_filters \
            else int(num_filters[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H', W', num_bev_features), NHWC at both ends;
        NCHW inside."""
        x = x.permute(0, 3, 1, 2)
        ups = []
        for i, block in enumerate(self.blocks):
            x = self._run(block, x)
            ups.append(self._run(self.deblocks[i], x) if len(self.deblocks) else x)
        out = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if len(self.deblocks) > len(self.blocks):
            out = self._run(self.deblocks[-1], out)
        return out.permute(0, 2, 3, 1)

    def _run(self, seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """The layers of ``seq`` in order, each conv in the compute dtype."""
        dt = self.compute_dtype
        if dt is None:
            return seq(x)
        for layer in seq:
            if isinstance(layer, nn.ConvTranspose2d):
                x = F.conv_transpose2d(x.to(dt), layer.weight.to(dt), None, layer.stride)
            elif isinstance(layer, nn.Conv2d):
                x = F.conv2d(x.to(dt), layer.weight.to(dt), None, layer.stride, layer.padding)
            else:
                x = layer(x)
        return x
