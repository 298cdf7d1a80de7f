"""Dense 2D BEV backbone (port of seevcn_tpu/models/modules/backbone2d.py;
reference base_bev_backbone.py:6-112): per level a strided 3x3 conv and
LAYER_NUMS[i] 3x3 convs (conv-BN-ReLU, no bias), then an upsample per
level and a channel concat. An upsample stride s >= 1 is a transposed conv
of kernel and stride s; s < 1 a conv of kernel and stride round(1 / s),
unpadded; with one more upsample stride than levels, a final transposed
conv over the concat follows (``deblocks.{levels}``); with none, the
levels' own outputs are joined. Keys as the reference's
(``blocks.0.1.weight`` after its ZeroPad2d at index 0).

``dtype`` (BACKBONE_2D.DTYPE, e.g. "bfloat16") is the convs' compute dtype
only, as flax's ``nn.Conv(dtype=...)`` in the JAX package: each conv and
transposed conv casts its input and weight to it and gives its output in
it; the batch norms run in f32 on f32 parameters and statistics, so every
block's output is f32 again. The parameters stay f32.

On W slabs (``forward(x, w_slabs=True)``, under an active mesh of mp > 1:
each rank holds W / mp columns of the map, ``parallel.spatial``) every conv
takes its W padding from its neighbours' edge columns (``halo_w``) and keeps
its H padding: a 3x3 conv padded 1 at stride 1 takes one column from each
side, at stride 2 (output column j reads input columns 2j - 1 .. 2j + 1)
one from the left and none from the right; the transposed-conv upsamples
(kernel = stride), the k-strided downsamples and the channel concat are
local. The batch norms take their statistics over every rank, as they do
under any mesh (``mesh.stats_sum``). W must split into whole,
stride-aligned slabs at every level, W divisible by mp times the product
of the strides, where XLA would pad an uneven shard: any other W raises
ValueError."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import active_mesh
from ...parallel.spatial import halo_w
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

    def forward(self, x: torch.Tensor, w_slabs: bool = False) -> torch.Tensor:
        """(B, H, W, C) -> (B, H', W', num_bev_features), NHWC at both ends
        as in the reference; NCHW inside. ``w_slabs``: ``x`` is this rank's
        W slab of the map under the active mesh's mp axis, and so is the
        output."""
        if w_slabs:
            self._check_slabs(x.shape[2])
        x = x.permute(0, 3, 1, 2)
        ups = []
        for i, block in enumerate(self.blocks):
            x = self._run(block, x, w_slabs)
            ups.append(self._run(self.deblocks[i], x, w_slabs) if len(self.deblocks) else x)
        out = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if len(self.deblocks) > len(self.blocks):
            out = self._run(self.deblocks[-1], out, w_slabs)
        return out.permute(0, 2, 3, 1)

    def _check_slabs(self, w: int) -> None:
        """ValueError unless a slab of ``w`` columns splits at every level's
        stride (and every k-strided downsample's k) into whole columns."""
        mp = active_mesh().mp
        for i, s in enumerate(self.layer_strides):
            if w % s:
                raise ValueError(f"BaseBEVBackbone level {i}: a W slab of {w} columns (W "
                                 f"{w * mp} over mp {mp}) does not divide by its stride {s}")
            w //= s
            if self.upsample_strides and self.upsample_strides[i] < 1:
                k = int(round(1 / self.upsample_strides[i]))
                if w % k:
                    raise ValueError(f"BaseBEVBackbone level {i}: a W slab of {w} columns "
                                     f"(W {w * mp} over mp {mp}) does not divide by its "
                                     f"downsample {k}")

    def _run(self, seq: nn.Sequential, x: torch.Tensor, w_slabs: bool = False) -> torch.Tensor:
        """The layers of ``seq`` in order, each conv in the compute dtype;
        on W slabs each conv's W padding from the neighbours."""
        dt = self.compute_dtype
        if dt is None and not w_slabs:
            return seq(x)
        cast = (lambda t: t) if dt is None else (lambda t: t.to(dt))     # noqa: E731
        pad_w = None                  # the W padding of a ZeroPad2d before a conv
        for layer in seq:
            if isinstance(layer, nn.ConvTranspose2d):
                x = F.conv_transpose2d(cast(x), cast(layer.weight), None, layer.stride)
            elif isinstance(layer, nn.Conv2d):
                padding = layer.padding
                if w_slabs:
                    (kw, sw), pw = (layer.kernel_size[1], layer.stride[1]), \
                        layer.padding[1] if pad_w is None else pad_w
                    x = halo_w(x, pw, max(0, kw - sw - pw), dim=3)
                    padding, pad_w = (layer.padding[0], 0), None
                x = F.conv2d(cast(x), cast(layer.weight), None, layer.stride, padding)
            elif w_slabs and isinstance(layer, nn.ZeroPad2d):
                left, _, top, bottom = layer.padding
                x, pad_w = F.pad(x, (0, 0, top, bottom)), left
            else:
                x = layer(x)
        return x
