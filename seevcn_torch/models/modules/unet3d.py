"""UNetV2, Part-A2's sparse encoder-decoder (port of
seevcn_tpu/models/modules/unet3d.py; reference
pcdet/models/backbones_3d/spconv_unet.py:49-212).

The encoder is VoxelBackBone8x's, with its module and key names. The
decoder runs four UR blocks from stage 4 back to stage 1: a lateral
residual block (``conv_up_t{i}``), the bottom-up features concatenated
before the lateral ones, a merge conv (``conv_up_m{i}``) plus the channel
reduction of the concatenation, then the inverse sparse conv onto the
previous stage's rows (``inv_conv{i}``, i = 4, 3, 2), or at stage 1 a
submanifold conv (``conv5``). The inverse convs land on the rows of the
tensor the strided conv read, which the reference's shared indice keys
give it; the port's strided convs keep every active output, so every
stage tensor holds exactly its active voxels (the reference's BACKBONE_3D
MODE names TPU lowerings of the same math and is not read).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import sparse as SP
from .backbone3d import (BACKBONES, SparseBasicBlock, SparseConvWeight, SpConvLayer,
                         VoxelBackBone8x)
from .common import MaskedBatchNorm


class SpInverseConvLayer(nn.Module):
    """Inverse sparse conv + masked BN + ReLU onto a target's rows; children
    ``0`` (conv) and ``1`` (BN), as spconv's SparseSequential."""

    def __init__(self, cin: int, cout: int, kernel_size=3, stride=1, padding=0):
        super().__init__()
        self.add_module("0", SparseConvWeight(cin, cout, kernel_size))
        self.add_module("1", MaskedBatchNorm(cout))
        self.stride, self.padding = stride, padding

    def forward(self, st: SP.SparseTensor, target: SP.SparseTensor) -> SP.SparseTensor:
        conv = self._modules["0"]
        out = SP.sparse_inverse_conv3d(st, conv.rulebook(), target, conv.kernel_size,
                                       self.stride, self.padding)
        f = torch.relu(self._modules["1"](out.features, out.mask).to(st.features.dtype))
        return out._replace(features=f)


def channel_reduction(st: SP.SparseTensor, out_channels: int) -> SP.SparseTensor:
    """(N, C) -> (N, out_channels): channel c summed into group c // (C /
    out_channels), the reference's ``view(n, out, -1).sum(2)``."""
    n, c = st.features.shape
    if c % out_channels:
        raise ValueError(f"{c} channels do not reduce to {out_channels}")
    return st._replace(features=st.features.reshape(n, out_channels, -1).sum(2))


class UNetV2(VoxelBackBone8x):
    """VoxelBackBone8x's encoder and the UR decoder. Output: the encoder's
    dict (``encoded_spconv_tensor`` at stride 8, ``multi_scale_3d_features``)
    and ``point_features``, the decoder's 16 channels on the input's rows
    (stride 1)."""

    #: (stage, channels, out channels, the strided conv's padding) of the
    #: inverse-conv UR blocks, deepest first
    UR = ((4, 64, 64, (0, 1, 1)), (3, 64, 32, 1), (2, 32, 16, 1))

    def __init__(self, input_channels: int = 4, dtype: str = "float32"):
        super().__init__(input_channels, dtype)
        for i, c, cout, pad in self.UR:
            self.add_module(f"conv_up_t{i}", SparseBasicBlock(c))
            self.add_module(f"conv_up_m{i}", SpConvLayer(2 * c, c, padding=1))
            self.add_module(f"inv_conv{i}", SpInverseConvLayer(c, cout, 3, 2, pad))
        self.conv_up_t1 = SparseBasicBlock(16)
        self.conv_up_m1 = SpConvLayer(32, 16, padding=1)
        self.conv5 = nn.ModuleList([SpConvLayer(16, 16, padding=1)])

    def ur_block(self, i: int, lateral: SP.SparseTensor, bottom: SP.SparseTensor):
        """The UR block of stage ``i`` up to its last conv: -> the merged
        tensor (on the lateral's rows) that ``inv_conv{i}`` or ``conv5``
        reads."""
        trans = getattr(self, f"conv_up_t{i}")(lateral)
        cat = trans._replace(features=torch.cat([bottom.features, trans.features], 1))
        m = getattr(self, f"conv_up_m{i}")(cat)
        red = channel_reduction(cat, m.features.shape[1])
        return m._replace(features=m.features + red.features)

    def decode(self, ms3d: dict) -> SP.SparseTensor:
        """The stage tensors x_conv1-4 -> the stride-1 point features."""
        x = ms3d["x_conv4"]
        for i, _, _, _ in self.UR:
            merged = self.ur_block(i, ms3d[f"x_conv{i}"], x)
            x = getattr(self, f"inv_conv{i}")(merged, ms3d[f"x_conv{i - 1}"])
        return self.conv5[0](self.ur_block(1, ms3d["x_conv1"], x))

    def forward(self, st: SP.SparseTensor) -> dict:
        out = super().forward(st)
        out["point_features"] = self.decode(out["multi_scale_3d_features"])
        return out


BACKBONES["UNetV2"] = UNetV2
