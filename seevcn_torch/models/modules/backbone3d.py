"""VoxelBackBone8x on the rulebook sparse convs (port of the rulebook path of
seevcn_tpu/models/modules/backbone3d.py; reference spconv_backbone.py:69-180).

Channel plan: in -> 16 -> 16 | s2 32 (x3) | s2 64 (x3) | s2 (z pad 0) 64 (x3)
| (3,1,1) s(2,1,1) 128. Weights keep the reference's spconv 2.x layout
(out, kz, ky, kx, in) and key names (``conv2.0.0.weight``, ...).

``dtype="bfloat16"`` stores the activations in bf16 between layers, as the
reference's dense modes do: each conv multiplies bf16 inputs and weights
with f32 accumulation and rounds its result to bf16 once; batch norm runs
in f32 and its result is rounded to bf16. In training each masked batch
norm takes its statistics over the valid rows. The strided convs keep every
active output (the reference's dense modes never truncate; its rulebook
mode keeps the lowest keys up to the input's row count, the same set
whenever nothing overflows).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops import sparse as SP
from .common import MaskedBatchNorm


class SparseConvWeight(nn.Module):
    """The weight of one SubMConv3d / SparseConv3d, spconv 2.x layout."""

    def __init__(self, cin: int, cout: int, kernel_size):
        super().__init__()
        self.kernel_size = SP._as3(kernel_size)
        self.weight = nn.Parameter(torch.empty(cout, *self.kernel_size, cin))
        nn.init.normal_(self.weight, std=(cin * self.weight[0, ..., 0].numel()) ** -0.5)

    def rulebook(self, dtype=None) -> torch.Tensor:
        """(K, cin, cout) with K in the rulebook's z-major offset order, in
        ``dtype`` (the parameter's by default)."""
        w = self.weight.permute(1, 2, 3, 4, 0)
        return w.reshape(-1, w.shape[3], w.shape[4]).to(dtype or w.dtype)


class SpConvLayer(nn.Module):
    """One sparse conv + masked BN + ReLU; children ``0`` (conv) and ``1``
    (BN), as in the reference's spconv.SparseSequential."""

    def __init__(self, cin: int, cout: int, kernel_size=3, stride=1, padding=0,
                 subm: bool = True):
        super().__init__()
        self.add_module("0", SparseConvWeight(cin, cout, kernel_size))
        self.add_module("1", MaskedBatchNorm(cout))
        self.stride, self.padding, self.subm = stride, padding, subm

    def forward(self, st: SP.SparseTensor) -> SP.SparseTensor:
        conv, bn = self._modules["0"], self._modules["1"]
        dtype = st.features.dtype
        # the f32 parameter goes in; the conv casts it to the features' dtype,
        # so its weight gradient reaches the parameter without a bf16 rounding
        w = conv.rulebook()
        if self.subm:
            out = SP.subm_conv3d(st, w, conv.kernel_size, self.padding)
        else:
            out = SP.sparse_conv3d(st, w, conv.kernel_size, self.stride,
                                   self.padding, out_capacity=SP.ALL)
        f = torch.relu(bn(out.features, out.mask).to(dtype))
        return out._replace(features=f)


class VoxelBackBone8x(nn.Module):
    def __init__(self, input_channels: int = 4, dtype: str = "float32"):
        super().__init__()
        if dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"BACKBONE_3D.DTYPE {dtype}")
        self.dtype = getattr(torch, dtype)
        self.conv_input = SpConvLayer(input_channels, 16, padding=1)
        self.conv1 = nn.ModuleList([SpConvLayer(16, 16, padding=1)])
        for name, cin, cout, pad in (("conv2", 16, 32, 1), ("conv3", 32, 64, 1),
                                     ("conv4", 64, 64, (0, 1, 1))):
            setattr(self, name, nn.ModuleList([
                SpConvLayer(cin, cout, stride=2, padding=pad, subm=False),
                SpConvLayer(cout, cout, padding=1),
                SpConvLayer(cout, cout, padding=1)]))
        self.conv_out = SpConvLayer(64, 128, kernel_size=(3, 1, 1),
                                    stride=(2, 1, 1), padding=0, subm=False)

    @staticmethod
    def encoded_shape(spatial_shape) -> tuple:
        """(nz, ny, nx) of the stride-8 output for an input grid."""
        s = spatial_shape
        for pad in (1, 1, (0, 1, 1)):
            s = SP.conv_out_shape(s, 3, 2, pad)
        return SP.conv_out_shape(s, (3, 1, 1), (2, 1, 1), 0)

    def forward(self, st: SP.SparseTensor) -> dict:
        x = self.conv_input(st._replace(features=st.features.to(self.dtype)))
        feats = {}
        for i, stage in enumerate((self.conv1, self.conv2, self.conv3,
                                   self.conv4), start=1):
            for layer in stage:
                x = layer(x)
            feats[f"x_conv{i}"] = x
        return {"encoded_spconv_tensor": self.conv_out(x),
                "encoded_spconv_tensor_stride": 8,
                "multi_scale_3d_features": feats,
                "multi_scale_3d_strides": {"x_conv1": 1, "x_conv2": 2,
                                           "x_conv3": 4, "x_conv4": 8}}
