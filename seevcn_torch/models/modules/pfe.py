"""Point feature extraction: the voxel set abstraction of PV-RCNN and
PV-RCNN++ (port of seevcn_tpu/models/modules/pfe.py; reference
pcdet/models/backbones_3d/pfe/voxel_set_abstraction.py:124-411 and
pointnet2_stack_modules.py: StackSAModuleMSG, VectorPoolAggregationModuleMSG).

Per frame: keypoints from the raw points, then at each keypoint the
bilinear BEV feature, and set-abstraction groups over the raw points and
over the voxel centres of each named backbone stage; the concatenation goes
through Linear + BN + ReLU to NUM_OUTPUT_FEATURES. SAMPLE_METHOD FPS takes
the keypoints by FPS (a cloud of more than 2^15 points is first deduped to
one point a 0.35 m hash cell); SPC (PV-RCNN++) keeps the points near a
proposal, dedupes them the same way and runs the sector FPS.

Each frame's supports are its valid rows, in their row order: the ball
query takes the first members by index, so that order is part of the
result. The raw points keep the input's order; a backbone stage's rows are
key-sorted (b, z, y, x), as the voxeliser emits them, a submanifold conv
keeps them and a strided conv produces them, which is the order the JAX
package's ``SP.as_sparse`` hands its VSA. The ball query's distance form
follows the support width JAX's layer sees (its padded row count), which
each caller passes as ``width``.

An SA layer is StackSAModuleMSG (``SALayer``: max-pooled shared MLPs) or
VectorPoolAggregationModuleMSG (``VectorPoolAggregationMSG``: per-bin means
of a local sub-voxel grid, with the JAX package's documented departure from
the reference, the ``voxel_avg_pool`` mean in place of
``local_interpolation``). Module and key names are OpenPCDet's
(``SA_layers``, ``SA_rawpoints``, ``vsa_point_feature_fusion``, each SA
layer's ``mlps``, a VectorPool layer's ``layers`` and ``msg_post_mlps``, a
group's ``post_mlps``) and the JAX package's where OpenPCDet has none (a
group's ``reduce``); the batch norms keep the JAX package's eps 1e-3 and
running-average rate.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sparse as SP
from ...ops.pointnet2 import ball_query_multi, group_features, masked_max_pool
from ...ops.sampling import (farthest_point_sample, grid_subsample,
                             sample_points_with_roi_mask, sector_fps_sample)
from .common import BatchNorm1d
from .roi_heads import bilinear_sample

#: the stage strides of VoxelBackBone8x, DOWNSAMPLE_FACTOR's default
STAGE_STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}
#: the stage widths of VoxelBackBone8x
STAGE_CHANNELS = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64, "x_conv4": 64}
#: clouds larger than this are grid-deduped before the keypoint FPS
PRE_CAP = 1 << 15


def voxel_centres(coords: torch.Tensor, stride: float, voxel_size, point_cloud_range,
                  dtype) -> torch.Tensor:
    """(N, 4) voxel coords [b, z, y, x] of a stage at ``stride`` -> (N, 3)
    metric centres in ``dtype``."""
    pcr = coords.new_tensor(point_cloud_range, dtype=dtype)
    vs = coords.new_tensor(voxel_size, dtype=dtype)
    c = coords.to(dtype)
    return torch.stack([(c[:, 3 - i] + 0.5) * vs[i] * stride + pcr[i] for i in range(3)], 1)


def _shared_mlp(cin: int, widths: Sequence[int]) -> nn.Sequential:
    """1x1 Conv2d (no bias) + BN + ReLU per width, as the reference's
    ``shared_mlps``; the conv runs as a product over the flattened rows."""
    layers = []
    for f in widths:
        layers += [nn.Conv2d(cin, int(f), 1, bias=False),
                   BatchNorm1d(int(f), eps=1e-3, momentum=0.01), nn.ReLU()]
        cin = int(f)
    return nn.Sequential(*layers)


def _linear_bn_relu(cin: int, widths: Sequence[int]) -> nn.Sequential:
    """Linear (no bias) + BN + ReLU per width, as the JAX package's Dense +
    BatchNorm + relu stacks."""
    layers = []
    for f in widths:
        layers += [nn.Linear(cin, int(f), bias=False),
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

    def forward(self, frames, width: int) -> torch.Tensor:
        """frames: per frame (new_xyz (K, 3), support_xyz (N, 3), features
        (N, C) or None), K the same in every frame; ``width``: the support
        width of JAX's layer -> (B, K, out_channels). Every support row is
        valid. The MLPs run on all frames' groups at once, so a batch
        norm's statistics cover the whole batch, empty slots (zeros)
        included, as in the reference."""
        groups = []
        for q, sup, feats in frames:
            sel = ball_query_multi(q, sup, self.radii, self.nsamples, width=width)
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


class VectorPoolAggregation(nn.Module):
    """One VectorPool group (the reference's VectorPoolAggregationModule,
    pv_rcnn_plusplus.yaml GROUP_CFG_*): the first ``nsample`` supports
    within ``max_neighbor_distance`` of a query are binned into an n0 x n1 x
    n2 sub-voxel grid centred on it; each bin's mean of [relative xyz,
    reduced features] (zeros for an empty bin), flattened in bin order,
    goes through POST_MLPS. The features are reduced to
    ``num_reduced_channels`` by the group's own Linear unless they have
    that width already.

    The per-bin sums are a product with the members' one-hot bins; against
    JAX's einsum only the order of the f32 sums differs."""

    def __init__(self, in_channels: int, num_local_voxel: Sequence[int],
                 max_neighbor_distance: float, nsample: int, post_mlps: Sequence[int],
                 num_reduced_channels: int):
        super().__init__()
        self.num_local_voxel = tuple(int(v) for v in num_local_voxel)
        self.radius = float(max_neighbor_distance)
        self.nsample = int(nsample)
        self.reduce = nn.Linear(in_channels, num_reduced_channels, bias=False) \
            if in_channels and in_channels != num_reduced_channels else None
        c = (num_reduced_channels if in_channels else 0) + 3
        self.post_mlps = _linear_bn_relu(math.prod(self.num_local_voxel) * c, post_mlps)
        self.out_channels = int(post_mlps[-1])

    def reduced(self, feats: torch.Tensor | None) -> torch.Tensor | None:
        """(N, C) support features -> (N, NUM_REDUCED_CHANNELS)."""
        return feats if feats is None or self.reduce is None else self.reduce(feats)

    def bin_means(self, q, sup, feats, idx, valid) -> torch.Tensor:
        """One frame's ball query (idx, valid (K, nsample)) over supports
        ``sup`` (N, 3) with reduced ``feats`` (N, C') or None -> (K, nbins *
        (3 + C')), the bins' means in bin order."""
        n0, n1, n2 = self.num_local_voxel
        nbins = n0 * n1 * n2
        safe = idx.clamp(0, sup.shape[0] - 1)
        rel = sup[safe, :3] - q[:, None, :3]                              # (K, S, 3)
        g = rel if feats is None else torch.cat([rel, feats[safe]], -1)
        g = torch.where(valid[..., None], g, 0.0)
        # as JAX: (rel + r) / (2 r) in f32, times n_d, truncated toward 0
        r = rel.new_tensor(self.radius)
        pos = (rel + r) / rel.new_tensor(2.0 * self.radius)
        ib = [(pos[..., d] * n).to(torch.int32).clamp(0, n - 1)
              for d, n in enumerate(self.num_local_voxel)]
        bins = torch.where(valid, (ib[0] * n1 + ib[1]) * n2 + ib[2], nbins).long()
        onehot = F.one_hot(bins, nbins + 1)[..., :nbins].to(g.dtype)     # (K, S, nb)
        sums = torch.bmm(onehot.transpose(1, 2), g)                      # (K, nb, C)
        counts = onehot.sum(1)
        return (sums / counts.clamp_min(1.0)[..., None]).reshape(q.shape[0], -1)

    def post(self, means: list, b: int, k: int) -> torch.Tensor:
        """The frames' bin means -> POST_MLPS over all of them at once (one
        batch norm over the batch) -> (B, K, out_channels)."""
        return self.post_mlps(torch.cat(means)).reshape(b, k, -1)

    def forward(self, frames, width: int) -> torch.Tensor:
        """frames as ``SALayer.forward``'s -> (B, K, out_channels)."""
        means = []
        for q, sup, feats in frames:
            idx, valid = ball_query_multi(q, sup, (self.radius,), (self.nsample,),
                                          width=width)[0]
            means.append(self.bin_means(q, sup, self.reduced(feats), idx, valid))
        return self.post(means, len(frames), frames[0][0].shape[0])


class VectorPoolAggregationMSG(nn.Module):
    """VectorPoolAggregationModuleMSG: NUM_GROUPS VectorPool groups over
    one support set (``layers``), concatenated, then MSG_POST_MLPS
    (``msg_post_mlps``). The groups share one distance pass."""

    def __init__(self, in_channels: int, group_cfgs, msg_post_mlps: Sequence[int],
                 num_reduced_channels: int):
        super().__init__()
        self.layers = nn.ModuleList()
        for gc in group_cfgs:
            ns = int(gc.get("NEIGHBOR_NSAMPLE", -1))
            self.layers.append(VectorPoolAggregation(
                in_channels, gc["NUM_LOCAL_VOXEL"], gc["MAX_NEIGHBOR_DISTANCE"],
                ns if ns > 0 else 32, gc["POST_MLPS"], num_reduced_channels))
        c = sum(layer.out_channels for layer in self.layers)
        self.msg_post_mlps = _linear_bn_relu(c, msg_post_mlps)
        self.out_channels = int(msg_post_mlps[-1]) if len(msg_post_mlps) else c

    def forward(self, frames, width: int) -> torch.Tensor:
        """frames as ``SALayer.forward``'s -> (B, K, out_channels)."""
        radii = [layer.radius for layer in self.layers]
        nsamples = [layer.nsample for layer in self.layers]
        means = [[] for _ in self.layers]
        for q, sup, feats in frames:
            sel = ball_query_multi(q, sup, radii, nsamples, width=width)
            for layer, out, (idx, valid) in zip(self.layers, means, sel):
                out.append(layer.bin_means(q, sup, layer.reduced(feats), idx, valid))
        b, k = len(frames), frames[0][0].shape[0]
        x = torch.cat([layer.post(m, b, k) for layer, m in zip(self.layers, means)], -1)
        return self.msg_post_mlps(x.reshape(b * k, -1)).reshape(b, k, -1)


def build_sa_layer(sa_cfg, in_channels: int) -> nn.Module:
    """An SA_LAYER entry -> SALayer (StackSAModuleMSG) or
    VectorPoolAggregationMSG (VectorPoolAggregationModuleMSG), as the JAX
    package's build_sa_layer dispatches on NAME."""
    if sa_cfg.get("NAME", "StackSAModuleMSG") == "VectorPoolAggregationModuleMSG":
        groups = [sa_cfg[f"GROUP_CFG_{i}"] for i in range(int(sa_cfg["NUM_GROUPS"]))]
        return VectorPoolAggregationMSG(
            in_channels, groups, tuple(sa_cfg.get("MSG_POST_MLPS", ())),
            int(sa_cfg.get("NUM_REDUCED_CHANNELS", 32)))
    return SALayer(in_channels, sa_cfg["POOL_RADIUS"], sa_cfg["NSAMPLE"],
                   sa_cfg["MLPS"])


class VoxelSetAbstraction(nn.Module):
    def __init__(self, pfe_cfg, point_cloud_range, voxel_size,
                 num_bev_features: int, num_rawpoint_features: int):
        super().__init__()
        self.cfg = pfe_cfg
        self.num_keypoints = int(pfe_cfg.NUM_KEYPOINTS)
        self.sample_method = pfe_cfg.get("SAMPLE_METHOD", "FPS")
        if self.sample_method not in ("FPS", "SPC"):
            raise NotImplementedError(f"PFE SAMPLE_METHOD {self.sample_method}")
        if self.sample_method == "SPC":
            spc = pfe_cfg.SPC_SAMPLING
            self.sample_radius_with_roi = float(spc.SAMPLE_RADIUS_WITH_ROI)
            self.num_sectors = int(spc.NUM_SECTORS)
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
        self.vsa_point_feature_fusion = _linear_bn_relu(c_in, [self.num_point_features])

    def dedupe(self, xyz: torch.Tensor, valid: torch.Tensor):
        """Over a cloud of more than 2^15 points (FPS_PRE_GRID_CELL > 0),
        ``grid_subsample``'s representatives of the ``valid`` points ->
        (xyz (B, P', 3), valid (B, P'))."""
        if self.pre_cell > 0 and xyz.shape[1] > PRE_CAP:
            sel = [grid_subsample(p, v, self.pre_cell, PRE_CAP)
                   for p, v in zip(xyz, valid)]
            xyz = torch.stack([p[i] for p, (i, _) in zip(xyz, sel)])
            valid = torch.stack([ok for _, ok in sel])
        return xyz, valid

    @torch.no_grad()
    def sample_keypoints(self, points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(B, P, 3+) points, (B, P) validity -> (B, K, 3) keypoints: FPS
        from the first valid point; over a cloud of more than 2^15 points,
        FPS over ``grid_subsample``'s representatives (FPS_PRE_GRID_CELL,
        0.35 m; 0 opts out)."""
        xyz, valid = self.dedupe(points[..., :3], valid)
        idx = farthest_point_sample(xyz, self.num_keypoints, valid)
        return torch.gather(xyz, 1, idx[..., None].expand(*idx.shape, 3))

    @torch.no_grad()
    def spc_candidates(self, points: torch.Tensor, valid: torch.Tensor,
                       rois: torch.Tensor, roi_mask: torch.Tensor) -> torch.Tensor:
        """SPC's candidates, (B, P) bool: each frame's valid points near a
        valid RoI (``sample_points_with_roi_mask``, SAMPLE_RADIUS_WITH_ROI),
        or all its valid points when none is near one (the reference falls
        back to its first point; the JAX package, and so the port, to the
        valid points)."""
        near = torch.stack([sample_points_with_roi_mask(
            p, r, m, self.sample_radius_with_roi, v)
            for p, v, r, m in zip(points[..., :3], valid, rois, roi_mask)])
        return torch.where(near.any(1, keepdim=True), near, valid)

    @torch.no_grad()
    def sample_keypoints_spc(self, points: torch.Tensor, valid: torch.Tensor,
                             rois: torch.Tensor, roi_mask: torch.Tensor) -> torch.Tensor:
        """SAMPLE_METHOD SPC (PV-RCNN++'s sectorized proposal-centric
        sampling): ``spc_candidates``, deduped as ``sample_keypoints``
        dedupes, then ``sector_fps_sample`` (NUM_SECTORS) -> (B, K, 3)."""
        near = self.spc_candidates(points, valid, rois, roi_mask)
        xyz, near = self.dedupe(points[..., :3], near)
        idx, _ = sector_fps_sample(xyz, near, self.num_keypoints, self.num_sectors)
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
        """SA over each frame's valid raw points -> (B, K, C); JAX's support
        width is the points tensor's padded P."""
        frames = [(kp, p[v, :3], p[v, 3:] if p.shape[-1] > 3 else None)
                  for kp, p, v in zip(keypoints, points, valid)]
        return self.SA_rawpoints(frames, width=points.shape[1])

    def stage_centres(self, name: str, st: SP.SparseTensor) -> torch.Tensor:
        """(N, 3) metric centres of a stage's voxels (coords [b, z, y, x])."""
        sa_cfg = self.cfg.SA_LAYER[name]
        ds = float(sa_cfg.get("DOWNSAMPLE_FACTOR", STAGE_STRIDES[name]))
        return voxel_centres(st.coords, ds, self.voxel_size, self.point_cloud_range,
                             self.vsa_point_feature_fusion[0].weight.dtype)

    def stage_features(self, name: str, keypoints: torch.Tensor,
                       st: SP.SparseTensor, width: int) -> torch.Tensor:
        """SA over each frame's valid voxels of stage ``name`` -> (B, K, C);
        ``width``: the row count of the stage tensor JAX's VSA reads
        (``pvrcnn.jax_stage_width``)."""
        centres = self.stage_centres(name, st)
        feats = st.features.to(centres.dtype)
        frames = []
        for b, kp in enumerate(keypoints):
            rows = st.mask & (st.coords[:, 0] == b)
            frames.append((kp, centres[rows], feats[rows]))
        return self.SA_layers[self.layer_names.index(name)](frames, width=width)

    def forward(self, points, points_valid, bev, bev_stride: int,
                multi_scale_3d: dict, stage_width: int, rois=None,
                roi_mask=None) -> dict:
        """points (B, P, 3+), points_valid (B, P), bev (B, H, W, C),
        multi_scale_3d: name -> SparseTensor, ``stage_width`` as
        ``stage_features``' width; under SAMPLE_METHOD SPC also rois (B, M,
        7+) and roi_mask (B, M). -> keypoints (B, K, 3), point_features (B,
        K, NUM_OUTPUT_FEATURES) and point_features_before_fusion (B, K, C),
        the sources concatenated in the order bev, raw_points, then the
        stages as FEATURES_SOURCE lists them."""
        if self.sample_method == "SPC":
            if rois is None:
                # the JAX package's error: a detector that feeds no proposals
                raise ValueError(
                    "PFE SAMPLE_METHOD: SPC requires a detector that feeds "
                    "rois into the PFE (PV-RCNN++ topology); this detector "
                    "passed none — use SAMPLE_METHOD: FPS or a ++ config")
            keypoints = self.sample_keypoints_spc(points, points_valid, rois, roi_mask)
        else:
            keypoints = self.sample_keypoints(points, points_valid)
        feats = []
        if "bev" in self.sources:
            feats.append(self.bev_features(keypoints, bev, bev_stride))
        if "raw_points" in self.sources:
            feats.append(self.raw_point_features(keypoints, points, points_valid))
        for name in self.layer_names:
            feats.append(self.stage_features(name, keypoints, multi_scale_3d[name],
                                             stage_width))
        before = torch.cat(feats, -1)
        b, k, c = before.shape
        x = self.vsa_point_feature_fusion(before.reshape(b * k, c)).reshape(b, k, -1)
        return {"keypoints": keypoints, "point_features": x,
                "point_features_before_fusion": before}
