"""Dense 2D BEV backbone (port of seevcn_tpu/models/modules/backbone2d.py;
reference base_bev_backbone.py:6-112): per level a strided 3x3 conv and
LAYER_NUMS[i] 3x3 convs (conv-BN-ReLU, no bias), then a transposed-conv
upsample per level and a channel concat. Keys as the reference's
(``blocks.0.1.weight`` after its ZeroPad2d at index 0)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .common import conv_block2d, deconv_block2d


class BaseBEVBackbone(nn.Module):
    def __init__(self, input_channels: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[float] = (),
                 num_upsample_filters: Sequence[int] = ()):
        super().__init__()
        if len(upsample_strides) != len(layer_nums) \
                or any(s < 1 for s in upsample_strides):
            raise NotImplementedError(
                "BaseBEVBackbone is ported with one upsample of stride >= 1 "
                "per level")
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
            s = int(upsample_strides[i])
            self.deblocks.append(nn.Sequential(*deconv_block2d(
                num_filters[i], num_upsample_filters[i], s)))
            cin = num_filters[i]
        self.num_bev_features = int(sum(num_upsample_filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H', W', sum(NUM_UPSAMPLE_FILTERS)), NHWC at
        both ends as in the reference; NCHW inside."""
        x = x.permute(0, 3, 1, 2)
        ups = []
        for block, deblock in zip(self.blocks, self.deblocks):
            x = block(x)
            ups.append(deblock(x))
        return torch.cat(ups, dim=1).permute(0, 2, 3, 1)
