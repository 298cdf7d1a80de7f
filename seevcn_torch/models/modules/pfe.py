"""Point feature extraction: the voxel set abstraction of PV-RCNN (port of
seevcn_tpu/models/modules/pfe.py; reference pcdet/models/backbones_3d/pfe/
voxel_set_abstraction.py:124-411 and pointnet2_stack_modules.py:
StackSAModuleMSG).

Per frame: FPS keypoints from the raw points (a cloud of more than 2^15
points is first deduped to one point a 0.35 m hash cell), then at each
keypoint the bilinear BEV feature, and set-abstraction groups over the raw
points and over the voxel centres of each named backbone stage; the
concatenation goes through Linear + BN + ReLU to NUM_OUTPUT_FEATURES.

Each frame's supports are its valid rows, in their row order: the ball
query takes the first members by index, so that order is part of the
result. The raw points keep the input's order; a backbone stage's rows are
key-sorted (b, z, y, x), as the voxeliser emits them, a submanifold conv
keeps them and a strided conv produces them, which is the order the JAX
package's ``SP.as_sparse`` hands its VSA.

Module and key names are OpenPCDet's (``SA_layers``, ``SA_rawpoints``,
``vsa_point_feature_fusion``, each SA layer's ``mlps``); the batch norms
keep the JAX package's eps 1e-3 and running-average rate. SAMPLE_METHOD
SPC and VectorPoolAggregationModuleMSG (PV-RCNN++) are not ported.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sparse as SP
from ...ops.pointnet2 import ball_query_multi, group_features, masked_max_pool
from ...ops.sampling import farthest_point_sample, grid_subsample
from .common import BatchNorm1d
from .roi_heads import bilinear_sample

#: the stage strides of VoxelBackBone8x, DOWNSAMPLE_FACTOR's default
STAGE_STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
#: the stage widths of VoxelBackBone8x
STAGE_CHANNELS = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64, "x_conv4": 64}
#: clouds larger than this are grid-deduped before the keypoint FPS
PRE_CAP = 1 << 15


def _shared_mlp(cin: int, widths: Sequence[int]) -> nn.Sequential:
    """1x1 Conv2d (no bias) + BN + ReLU per width, as the reference's
    ``shared_mlps``; the conv runs as a product over the flattened rows."""
    layers = []
    for f in widths:
        layers += [nn.Conv2d(cin, int(f), 1, bias=False),
                   BatchNorm1d(int(f), eps=1e-3, momentum=0.01), nn.ReLU()]
        cin = int(f)
    return nn.Sequential(*layers)


def _run_mlp(mlp: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """(rows, cin) through a ``_shared_mlp``; batch norm over all rows."""
    for layer in mlp:
        x = F.linear(x, layer.weight.flatten(1)) if isinstance(layer, nn.Conv2d) \
            else layer(x)
    return x


class SALayer(nn.Module):
    """Multi-radius set abstraction (StackSAModuleMSG with max pooling): for
    each radius, the ball query's group of [xyz relative to the query,
    features] through a shared MLP, max-pooled over the valid members; the
    radii's outputs concatenated. All radii share one distance pass."""

    def __init__(self, in_channels: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.mlps = nn.ModuleList(_shared_mlp(3 + in_channels, m) for m in mlps)
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, frames) -> torch.Tensor:
        """frames: per frame (new_xyz (K, 3), support_xyz (N, 3), features
        (N, C) or None), K the same in every frame -> (B, K, out_channels).
        Every support row is valid. The MLPs run on all frames' groups at
        once, so a batch norm's statistics cover the whole batch, empty
        slots (zeros) included, as in the reference."""
        groups = []
        for q, sup, feats in frames:
            sel = ball_query_multi(q, sup, self.radii, self.nsamples)
            groups.append([(group_features(i, v, q, sup, feats), v) for i, v in sel])
        b, k = len(frames), frames[0][0].shape[0]
        outs = []
        for s, mlp in enumerate(self.mlps):
            g = torch.cat([grp[s][0] for grp in groups])            # (B*K, ns, c)
            v = torch.cat([grp[s][1] for grp in groups])
            x = _run_mlp(mlp, g.reshape(-1, g.shape[-1]))
            outs.append(masked_max_pool(x.reshape(g.shape[0], g.shape[1], -1), v)
                        .reshape(b, k, -1))
        return torch.cat(outs, -1)


def build_sa_layer(sa_cfg, in_channels: int) -> SALayer:
    """An SA_LAYER entry -> SALayer (StackSAModuleMSG)."""
    name = sa_cfg.get("NAME", "StackSAModuleMSG")
    if name != "StackSAModuleMSG":
        raise NotImplementedError(f"SA layer {name} (PV-RCNN++)")
    return SALayer(in_channels, sa_cfg["POOL_RADIUS"], sa_cfg["NSAMPLE"],
                   sa_cfg["MLPS"])


class VoxelSetAbstraction(nn.Module):
    def __init__(self, pfe_cfg, point_cloud_range, voxel_size,
                 num_bev_features: int, num_rawpoint_features: int):
        super().__init__()
        if pfe_cfg.get("SAMPLE_METHOD", "FPS") != "FPS":
            raise NotImplementedError(
                f"PFE SAMPLE_METHOD {pfe_cfg.SAMPLE_METHOD} (PV-RCNN++)")
        self.cfg = pfe_cfg
        self.num_keypoints = int(pfe_cfg.NUM_KEYPOINTS)
        self.pre_cell = float(pfe_cfg.get("FPS_PRE_GRID_CELL", 0.35))
        self.point_cloud_range = [float(v) for v in point_cloud_range]
        self.voxel_size = [float(v) for v in voxel_size]
        self.sources = list(pfe_cfg.FEATURES_SOURCE)
        c_in = num_bev_features if "bev" in self.sources else 0
        self.layer_names = [n for n in self.sources if n.startswith("x_conv")]
        self.SA_layers = nn.ModuleList()
        for name in self.layer_names:
            layer = build_sa_layer(pfe_cfg.SA_LAYER[name], STAGE_CHANNELS[name])
            self.SA_layers.append(layer)
            c_in += layer.out_channels
        if "raw_points" in self.sources:
            self.SA_rawpoints = build_sa_layer(pfe_cfg.SA_LAYER["raw_points"],
                                               num_rawpoint_features - 3)
            c_in += self.SA_rawpoints.out_channels
        self.num_point_features_before_fusion = c_in
        self.num_point_features = int(pfe_cfg.NUM_OUTPUT_FEATURES)
        self.vsa_point_feature_fusion = nn.Sequential(
            nn.Linear(c_in, self.num_point_features, bias=False),
            BatchNorm1d(self.num_point_features, eps=1e-3, momentum=0.01), nn.ReLU())

    @torch.no_grad()
    def sample_keypoints(self, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(B, P, 3+) points, (B, P) validity -> (B, K, 3) keypoints: FPS
        from the first valid point; over a cloud of more than 2^15 points,
        FPS over ``grid_subsample``'s representatives (FPS_PRE_GRID_CELL,
        0.35 m; 0 opts out)."""
        xyz = points[..., :3]
        if self.pre_cell > 0 and xyz.shape[1] > PRE_CAP:
            sel = [grid_subsample(p, v, self.pre_cell, PRE_CAP)
                   for p, v in zip(xyz, valid)]
            xyz = torch.stack([p[i] for p, (i, _) in zip(xyz, sel)])
            valid = torch.stack([ok for _, ok in sel])
        idx = farthest_point_sample(xyz, self.num_keypoints, valid)
        return torch.gather(xyz, 1, idx[..., None].expand(*idx.shape, 3))

    def bev_features(self, keypoints: torch.Tensor, bev: torch.Tensor,
                     bev_stride: int) -> torch.Tensor:
        """(B, K, 3), bev (B, H, W, C) -> (B, K, C), bilinear at each
        keypoint's BEV pixel."""
        pcr, vs = self.point_cloud_range, self.voxel_size
        org = keypoints.new_tensor(pcr[:2])
        size = keypoints.new_tensor(vs[:2])
        xy = (keypoints[..., :2] - org) / size / bev_stride
        return torch.stack([bilinear_sample(f, p) for f, p in zip(bev, xy)])

    def raw_point_features(self, keypoints, points, valid) -> torch.Tensor:
        """SA over each frame's valid raw points -> (B, K, C)."""
        frames = [(kp, p[v, :3], p[v, 3:] if p.shape[-1] > 3 else None)
                  for kp, p, v in zip(keypoints, points, valid)]
        return self.SA_rawpoints(frames)

    def stage_centres(self, name: str, st: SP.SparseTensor) -> torch.Tensor:
        """(N, 3) metric centres of a stage's voxels (coords [b, z, y, x])."""
        sa_cfg = self.cfg.SA_LAYER[name]
        ds = float(sa_cfg.get("DOWNSAMPLE_FACTOR", STAGE_STRIDES[name]))
        dtype = self.vsa_point_feature_fusion[0].weight.dtype
        pcr = st.coords.new_tensor(self.point_cloud_range, dtype=dtype)
        vs = st.coords.new_tensor(self.voxel_size, dtype=dtype)
        c = st.coords.to(dtype)
        return torch.stack([(c[:, 3 - i] + 0.5) * vs[i] * ds + pcr[i]
                            for i in range(3)], 1)

    def stage_features(self, name: str, keypoints: torch.Tensor,
                       st: SP.SparseTensor) -> torch.Tensor:
        """SA over each frame's valid voxels of stage ``name`` -> (B, K, C)."""
        centres = self.stage_centres(name, st)
        feats = st.features.to(centres.dtype)
        frames = []
        for b, kp in enumerate(keypoints):
            rows = st.mask & (st.coords[:, 0] == b)
            frames.append((kp, centres[rows], feats[rows]))
        return self.SA_layers[self.layer_names.index(name)](frames)

    def forward(self, points, points_valid, bev, bev_stride: int,
                multi_scale_3d: dict) -> dict:
        """points (B, P, 3+), points_valid (B, P), bev (B, H, W, C),
        multi_scale_3d: name -> SparseTensor. -> keypoints (B, K, 3),
        point_features (B, K, NUM_OUTPUT_FEATURES) and
        point_features_before_fusion (B, K, C), the sources concatenated in
        the order bev, raw_points, then the stages as FEATURES_SOURCE lists
        them."""
        keypoints = self.sample_keypoints(points, points_valid)
        feats = []
        if "bev" in self.sources:
            feats.append(self.bev_features(keypoints, bev, bev_stride))
        if "raw_points" in self.sources:
            feats.append(self.raw_point_features(keypoints, points, points_valid))
        for name in self.layer_names:
            feats.append(self.stage_features(name, keypoints, multi_scale_3d[name]))
        before = torch.cat(feats, -1)
        b, k, c = before.shape
        x = self.vsa_point_feature_fusion(before.reshape(b * k, c)).reshape(b, k, -1)
        return {"keypoints": keypoints, "point_features": x,
                "point_features_before_fusion": before}
