"""The sparse 3D backbones on the rulebook sparse convs (port of the rulebook
path of seevcn_tpu/models/modules/backbone3d.py; reference
spconv_backbone.py:69-293 and spconv_backbone_focal.py:101-176):
VoxelBackBone8x, VoxelResBackBone8x (residual submanifold blocks) and
VoxelBackBone8xFocal (focal sparse convs after stages 1-3).

Channel plan: in -> 16 -> 16 | s2 32 (x3) | s2 64 (x3) | s2 (z pad 0) 64 (x3)
| (3,1,1) s(2,1,1) 128 (VoxelResBackBone8x: 128 from stage 4). Weights keep
the reference's spconv 2.x layout (out, kz, ky, kx, in) and key names
(``conv2.0.0.weight``, a residual block's ``conv2.1.conv1.weight`` and
``.bn1``, a focal conv's ``conv1.0.conv.0.weight`` and ``.conv_imp``).

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


class SparseBasicBlock(nn.Module):
    """The residual submanifold block (spconv_backbone.py:33-66): conv1 +
    bn1 + ReLU, conv2 + bn2, the input added, ReLU, zero on invalid rows.
    The convs have no bias, as the JAX package's."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SparseConvWeight(channels, channels, 3)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConvWeight(channels, channels, 3)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, st: SP.SparseTensor) -> SP.SparseTensor:
        dtype = st.features.dtype
        out = _conv(st, self.conv1, 1, 1, True)
        out = out._replace(features=torch.relu(self.bn1(out.features, out.mask).to(dtype)))
        out = _conv(out, self.conv2, 1, 1, True)
        f = torch.relu(self.bn2(out.features, out.mask).to(dtype) + st.features)
        return out._replace(features=torch.where(st.mask[:, None], f, torch.zeros(
            (), dtype=f.dtype, device=f.device)))


class FocalSparseConv(nn.Module):
    """The focal sparse conv (focal_sparse_conv.py:9-169, arXiv:2204.12463)
    as the JAX package computes it: a submanifold conv + BN + ReLU
    (``conv``), gated by the sigmoid of the centre channel of a 27-channel
    submanifold importance conv (``conv_imp``); then the TOPK most important
    voxels (a stable descending sort: ties to the lower row) whose
    importance clears THRESHOLD each spawn the neighbours whose own
    importance clears it, carrying the gated features times that
    importance. The neighbour offsets are the JAX package's
    ``_offsets((3, 3, 3))`` without the centre, 0 to 2 on each axis (its
    rulebook's, not centred). Candidates already active are dropped through
    the rulebook's lookup; of equal keys the first in a stable key order is
    kept; the new voxels join the input's and all are sorted by key again.
    Output rows: the input's + TOPK x 26. Returns (SparseTensor, {
    "importance", "coords", "mask"}) of the input's rows, for
    ``focal_importance_loss``."""

    def __init__(self, cin: int, channels: int, topk: int = 128, threshold: float = 0.5):
        super().__init__()
        self.conv = SpConvLayer(cin, channels, padding=1)
        self.conv_imp = SparseConvWeight(cin, 27, 3)
        self.topk, self.threshold = int(topk), float(threshold)

    def forward(self, st: SP.SparseTensor):
        feats = self.conv(st).features
        dev = feats.device
        imps = SP.subm_conv3d(st, self.conv_imp.rulebook(st.features.dtype), 3, 1).features
        center_imp = torch.sigmoid(imps[:, 13])
        zero = torch.zeros((), dtype=center_imp.dtype, device=dev)
        feats = feats * torch.where(st.mask, center_imp, zero)[:, None].to(feats.dtype)

        nz, ny, nx = st.spatial_shape
        score = torch.where(st.mask, center_imp, -1.0)
        k = min(self.topk, score.shape[0])
        top = torch.sort(score, descending=True, stable=True).indices[:k]
        offs = SP._offsets((3, 3, 3), dev)
        noncenter = torch.cat([torch.arange(13, device=dev), torch.arange(14, 27, device=dev)])
        p_coords = st.coords[top].long()
        p_feats = feats[top]
        p_imps = torch.sigmoid(imps[top][:, noncenter])                    # (K, 26)
        p_ok = st.mask[top] & (score[top] > self.threshold)
        n_zyx = p_coords[:, None, 1:4] + offs[noncenter][None]
        dims = torch.tensor([nz, ny, nx], device=dev)
        inb = ((n_zyx >= 0) & (n_zyx < dims)).all(-1)
        cand_ok = inb & p_ok[:, None] & (p_imps > self.threshold)
        ckey = ((p_coords[:, 0:1] * nz + n_zyx[..., 0]) * ny + n_zyx[..., 1]) * nx \
            + n_zyx[..., 2]
        in_keys = SP.linear_key(st.coords, st.spatial_shape, st.mask)
        _, exists = SP._lookup(in_keys, ckey.reshape(-1))
        cand_ok = cand_ok & ~exists.view(cand_ok.shape)
        ckey = torch.where(cand_ok, ckey, SP._BIG).reshape(-1)
        cand_feats = (p_feats[:, None, :] * p_imps[..., None].to(p_feats.dtype)).reshape(
            ckey.shape[0], -1)

        extra = k * 26
        order = torch.argsort(ckey, stable=True)
        skey = ckey[order]
        head = torch.ones_like(skey, dtype=torch.bool)
        head[1:] = skey[1:] != skey[:-1]
        sel = order[head & (skey < SP._BIG)]
        pad = extra - sel.shape[0]
        new_keys = torch.cat([ckey[sel], ckey.new_full((pad,), SP._BIG)])
        new_feats = torch.cat([cand_feats[sel], cand_feats.new_zeros((pad, feats.shape[1]))])
        new_mask = new_keys < SP._BIG
        kk = torch.where(new_mask, new_keys, 0)
        new_coords = torch.stack([kk // (nx * ny * nz), kk // (nx * ny) % nz,
                                  kk // nx % ny, kk % nx], 1).to(st.coords.dtype)

        all_keys = torch.cat([in_keys, new_keys])
        perm = torch.argsort(all_keys, stable=True)
        merged = SP.SparseTensor(torch.cat([feats, new_feats])[perm],
                                 torch.cat([st.coords, new_coords])[perm],
                                 torch.cat([st.mask, new_mask])[perm], st.spatial_shape,
                                 st.batch_size)
        return merged, {"importance": center_imp, "coords": st.coords, "mask": st.mask}


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
        feats, aux = {}, []
        for i, stage in enumerate(stages, start=1):
            for layer in stage:
                if isinstance(layer, FocalSparseConv):
                    x, a = layer(x)
                    aux.append({**a, "stride": 2 ** (i - 1)})
                else:
                    x = layer(x)
            feats[f"x_conv{i}"] = x
        out = {"encoded_spconv_tensor": self.conv_out(x),
               "encoded_spconv_tensor_stride": 8,
               "multi_scale_3d_features": feats,
               "multi_scale_3d_strides": {"x_conv1": 1, "x_conv2": 2,
                                          "x_conv3": 4, "x_conv4": 8}}
        if aux:
            out["focal_aux"] = aux
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


class VoxelResBackBone8x(_Backbone8x):
    """VoxelResBackBone8x (spconv_backbone.py:183-293): two residual blocks
    a stage, 128 channels from stage 4."""

    def __init__(self, input_channels: int = 4, dtype: str = "float32"):
        super().__init__()
        self._init_dtype(dtype)
        self.conv_input = SpConvLayer(input_channels, 16, padding=1)
        self.conv1 = nn.ModuleList([SparseBasicBlock(16), SparseBasicBlock(16)])
        for name, cin, cout, pad in (("conv2", 16, 32, 1), ("conv3", 32, 64, 1),
                                     ("conv4", 64, 128, (0, 1, 1))):
            setattr(self, name, nn.ModuleList([
                _down(cin, cout, pad), SparseBasicBlock(cout), SparseBasicBlock(cout)]))
        self.conv_out = SpConvLayer(128, 128, kernel_size=(3, 1, 1),
                                    stride=(2, 1, 1), padding=0, subm=False)


class VoxelBackBone8xFocal(_Backbone8x):
    """VoxelBackBone8x with a focal sparse conv in stages 1-3, in the JAX
    package's order (after ``conv_input``, after the first submanifold conv
    of stages 2 and 3); its output also holds ``focal_aux``, each focal
    layer's importances with its stride (1, 2, 4)."""

    def __init__(self, input_channels: int = 4, topk: int = 128, threshold: float = 0.5):
        super().__init__()
        self._init_dtype("float32")
        focal = lambda c: FocalSparseConv(c, c, topk, threshold)    # noqa: E731
        self.conv_input = SpConvLayer(input_channels, 16, padding=1)
        self.conv1 = nn.ModuleList([focal(16), SpConvLayer(16, 16, padding=1)])
        for name, cin, cout in (("conv2", 16, 32), ("conv3", 32, 64)):
            setattr(self, name, nn.ModuleList([
                _down(cin, cout), SpConvLayer(cout, cout, padding=1), focal(cout),
                SpConvLayer(cout, cout, padding=1)]))
        self.conv4 = nn.ModuleList([_down(64, 64, (0, 1, 1)), SpConvLayer(64, 64, padding=1),
                                    SpConvLayer(64, 64, padding=1)])
        self.conv_out = SpConvLayer(64, 128, kernel_size=(3, 1, 1),
                                    stride=(2, 1, 1), padding=0, subm=False)


BACKBONES = {"VoxelBackBone8x": VoxelBackBone8x, "VoxelResBackBone8x": VoxelResBackBone8x,
             "VoxelBackBone8xFocal": VoxelBackBone8xFocal}
