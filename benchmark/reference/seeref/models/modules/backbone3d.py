"""VoxelBackBone8x (OpenPCDet spconv_backbone.py) on the dense-grid sparse
convs of ``ops/sparse.py``.

Channel plan: in -> 16 -> 16 | s2 32 (x3) | s2 64 (x3) | s2 (z pad 0) 64 (x3)
| (3,1,1) s(2,1,1) 128. Weights in spconv 2.x's layout (out, kz, ky, kx, in)
under OpenPCDet's key names (``conv2.0.0.weight``). With ``dtype=
"bfloat16"`` the activations are bf16 between layers: each conv takes bf16
inputs and weights, batch norm runs in f32 and is rounded to bf16. In
training each masked batch norm takes its statistics over the active sites.
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


def _conv(st: SP.SparseTensor, conv: SparseConvWeight, stride, padding,
          subm: bool) -> SP.SparseTensor:
    # the f32 parameter goes in; the conv casts it to the features' dtype,
    # so its weight gradient reaches the parameter without a bf16 rounding
    w = conv.rulebook()
    if subm:
        return SP.subm_conv3d(st, w, conv.kernel_size, padding)
    return SP.sparse_conv3d(st, w, conv.kernel_size, stride, padding,
                            out_capacity=SP.ALL)


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
        out = _conv(st, self._modules["0"], self.stride, self.padding, self.subm)
        f = torch.relu(self._modules["1"](out.features, out.mask).to(st.features.dtype))
        return out._replace(features=f)


class _Backbone8x(nn.Module):
    """What the three backbones share: the dtype of the activations, the
    stride-8 output shape and the output dict."""

    def _init_dtype(self, dtype: str) -> None:
        if dtype not in ("float32", "bfloat16"):
            raise NotImplementedError(f"BACKBONE_3D.DTYPE {dtype}")
        self.dtype = getattr(torch, dtype)

    @staticmethod
    def encoded_shape(spatial_shape) -> tuple:
        """(nz, ny, nx) of the stride-8 output for an input grid."""
        s = spatial_shape
        for pad in (1, 1, (0, 1, 1)):
            s = SP.conv_out_shape(s, 3, 2, pad)
        return SP.conv_out_shape(s, (3, 1, 1), (2, 1, 1), 0)

    def _input(self, st: SP.SparseTensor) -> SP.SparseTensor:
        # bf16 activations where asked; else the parameters' dtype (f64 for
        # a model in double, as the parity tests run it)
        dtype = self.dtype if self.dtype == torch.bfloat16 \
            else self.conv_input._modules["0"].weight.dtype
        return st._replace(features=st.features.to(dtype))

    def _run(self, st: SP.SparseTensor, stages) -> dict:
        x = self.conv_input(self._input(st))
        feats = {}
        for i, stage in enumerate(stages, start=1):
            for layer in stage:
                x = layer(x)
            feats[f"x_conv{i}"] = x
        out = {"encoded_spconv_tensor": self.conv_out(x),
               "encoded_spconv_tensor_stride": 8,
               "multi_scale_3d_features": feats,
               "multi_scale_3d_strides": {"x_conv1": 1, "x_conv2": 2,
                                          "x_conv3": 4, "x_conv4": 8}}
        return out

    def forward(self, st: SP.SparseTensor) -> dict:
        return self._run(st, (self.conv1, self.conv2, self.conv3, self.conv4))


def _down(cin: int, cout: int, pad=1) -> SpConvLayer:
    return SpConvLayer(cin, cout, stride=2, padding=pad, subm=False)


class VoxelBackBone8x(_Backbone8x):
    def __init__(self, input_channels: int = 4, dtype: str = "float32"):
        super().__init__()
        self._init_dtype(dtype)
        self.conv_input = SpConvLayer(input_channels, 16, padding=1)
        self.conv1 = nn.ModuleList([SpConvLayer(16, 16, padding=1)])
        for name, cin, cout, pad in (("conv2", 16, 32, 1), ("conv3", 32, 64, 1),
                                     ("conv4", 64, 64, (0, 1, 1))):
            setattr(self, name, nn.ModuleList([
                _down(cin, cout, pad), SpConvLayer(cout, cout, padding=1),
                SpConvLayer(cout, cout, padding=1)]))
        self.conv_out = SpConvLayer(64, 128, kernel_size=(3, 1, 1),
                                    stride=(2, 1, 1), padding=0, subm=False)
