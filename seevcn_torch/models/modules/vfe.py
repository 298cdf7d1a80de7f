"""Pillar feature encoder (port of PFNLayer and DynamicPillarVFE of
seevcn_tpu/models/modules/vfe.py; reference pillar_vfe.py and
dynamic_pillar_vfe.py): per point, its features, its offset from the
pillar's mean and from the pillar's centre, then Linear + BN + ReLU layers,
each but the last followed by the pillar's max joined to every point, and
the max of the last per pillar. Points stay flat (a segment max over the
pillar ids), as in the reference. State-dict keys are OpenPCDet's
PillarVFE's: ``pfn_layers.{i}.linear``, ``pfn_layers.{i}.norm``.

Batch norm sees every point row given, the zeroed rows of dropped points
too, as the reference's does. The segment max starts from -inf with a
spare row for dropped points; an empty pillar reads 0, in the last
layer's max as in the reference's, and also in the max that a layer
before the last joins to its points: a dropped point joins the last
pillar row's, which the reference reads as -inf (and then NaN) when that
row is empty and the port as 0. Its gradient is
split evenly among the tied maxima of a pillar, as JAX's scatter-max VJP
splits it (torch's ``scatter_reduce`` amax backward does the same)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .common import BatchNorm1d


class PFNLayer(nn.Module):
    """Linear (no bias) + BatchNorm1d (eps 1e-3, flax's momentum) + ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(in_channels, out_channels, bias=False)
        self.norm = BatchNorm1d(out_channels, eps=1e-3, momentum=0.01)
        self.relu = nn.ReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.relu(self.norm(self.linear(x)))


def _segment_max(x: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(N, C) rows into ``num_segments`` rows by max, starting from -inf."""
    out = x.new_full((num_segments, x.shape[1]), float("-inf"))
    return out.scatter_reduce(0, seg[:, None].expand(-1, x.shape[1]), x, "amax",
                              include_self=True)


class DynamicPillarVFE(nn.Module):
    def __init__(self, num_point_features: int, num_filters: Sequence[int],
                 voxel_size, point_cloud_range, use_absolute_xyz: bool = True,
                 with_distance: bool = False):
        super().__init__()
        self.voxel_size = [float(v) for v in voxel_size]
        self.point_cloud_range = [float(v) for v in point_cloud_range]
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        cin = num_point_features + 6 - (0 if use_absolute_xyz else 3) + int(with_distance)
        layers = []
        for f in num_filters:
            layers.append(PFNLayer(cin, int(f)))
            cin = 2 * int(f)
        self.pfn_layers = nn.ModuleList(layers)
        self.num_filters = int(num_filters[-1])

    def forward(self, points: torch.Tensor, pillar_id: torch.Tensor,
                pillar_mean: torch.Tensor, pillar_coords: torch.Tensor,
                num_pillars: int) -> torch.Tensor:
        """points (P, 3+C) flat, pillar_id (P,) in [0, V) or -1 (dropped),
        pillar_mean (V, 3), pillar_coords (V, 4) [b, z, y, x] -> (V,
        NUM_FILTERS[-1]) pillar features."""
        ok = pillar_id >= 0
        pid = torch.where(ok, pillar_id.long(), num_pillars)
        row = pid.clamp(0, num_pillars - 1)
        xyz = points[:, :3]
        dt = points.dtype
        vs = torch.tensor(self.voxel_size, dtype=dt, device=points.device)
        pcr = torch.tensor(self.point_cloud_range, dtype=dt, device=points.device)
        c = pillar_coords.to(dt)
        centres = torch.stack([(c[:, 3] + 0.5) * vs[0] + pcr[0],
                               (c[:, 2] + 0.5) * vs[1] + pcr[1],
                               (c[:, 1] + 0.5) * vs[2] + pcr[2]], 1)
        feats = [points if self.use_absolute_xyz else points[:, 3:],
                 xyz - pillar_mean[row], xyz - centres[row]]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=1, keepdim=True))
        x = torch.where(ok[:, None], torch.cat(feats, 1), torch.zeros((), dtype=dt,
                                                                         device=points.device))
        last = len(self.pfn_layers) - 1
        for i, layer in enumerate(self.pfn_layers):
            x = layer(x)
            if i != last:
                pooled = _finite(_segment_max(x, pid, num_pillars + 1))
                x = torch.cat([x, pooled[row]], 1)
        neg = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)
        pooled = _segment_max(torch.where(ok[:, None], x, neg), pid, num_pillars + 1)
        return _finite(pooled[:num_pillars])


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))
