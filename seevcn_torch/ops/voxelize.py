"""Voxelisation on the device (port of seevcn_tpu/ops/voxelize.py).

Points stay flat: a stable sort by the z-major linear voxel key gives each
voxel a run of points in input order, and voxel features are segment sums
over the runs (MeanVFE: the mean of a voxel's first ``max_points_per_voxel``
points). What the reference pins, and this port keeps:

- voxel coords are [z, y, x];
- voxels are ordered by key, and the ``max_voxels`` with the LOWEST keys are
  kept, not the first ones in scan order;
- each voxel averages its first ``max_points_per_voxel`` points in input
  order (the sort is stable);
- ``num_points`` counts a voxel's points without the cap.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_BIG = np.iinfo(np.int32).max


class VoxelizationResult(NamedTuple):
    features: torch.Tensor        # (V, C) mean features
    coords: torch.Tensor          # (V, 3) int32 [z, y, x]
    num_points: torch.Tensor      # (V,) int32 points per voxel (uncapped)
    mask: torch.Tensor            # (V,) bool valid voxel
    point_voxel_id: torch.Tensor  # (P,) int32 voxel row per point, -1 if dropped
    point_order: torch.Tensor     # (P,) permutation applied to points (sorted)


def grid_size(point_cloud_range, voxel_size) -> np.ndarray:
    pcr = np.asarray(point_cloud_range, dtype=np.float64)
    vs = np.asarray(voxel_size, dtype=np.float64)
    return np.round((pcr[3:6] - pcr[0:3]) / vs).astype(np.int64)  # (nx, ny, nz)


def voxelize(points: torch.Tensor, valid: torch.Tensor, *, point_cloud_range,
             voxel_size, max_voxels: int,
             max_points_per_voxel: int = 0) -> VoxelizationResult:
    """points (P, 3+C) -> mean-pooled voxels. ``max_points_per_voxel=0``
    averages every point of a voxel; > 0 keeps the reference's cap."""
    dev = points.device
    pcr = torch.tensor(point_cloud_range, dtype=points.dtype, device=dev)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    nx, ny, nz = (int(g) for g in grid_size(point_cloud_range, voxel_size))
    mv = int(max_voxels)

    p = points.shape[0]
    c = torch.floor((points[:, :3] - pcr[0:3]) / vs).long()      # (P, 3) [x, y, z]
    dims = torch.tensor([nx, ny, nz], device=dev)
    ok = valid & ((c >= 0) & (c < dims)).all(1)
    big = nx * ny * nz
    key = torch.where(ok, (c[:, 2] * ny + c[:, 1]) * nx + c[:, 0], big)

    skey, order = torch.sort(key, stable=True)          # invalid keys go last
    spts = points[order]
    svalid = skey < big
    head = torch.ones_like(svalid)
    head[1:] = skey[1:] != skey[:-1]
    head &= svalid
    run_id = torch.cumsum(head, 0) - 1                  # voxel index per point
    run_id = torch.where(svalid & (run_id < mv), run_id, mv)

    # position of each point within its run, for the per-voxel point cap
    pos = torch.arange(p, device=dev)
    run_start = torch.cummax(torch.where(head, pos, 0), 0).values
    contributes = run_id < mv
    if max_points_per_voxel > 0:
        contributes &= (pos - run_start) < max_points_per_voxel

    w = contributes.to(points.dtype)
    feat_sum = points.new_zeros((mv + 1, points.shape[1])).index_add_(
        0, run_id, spts * w[:, None])
    cnt = points.new_zeros((mv + 1,)).index_add_(0, run_id, w)
    features = feat_sum[:mv] / cnt[:mv, None].clamp_min(1.0)
    num_points = torch.zeros((mv + 1,), dtype=torch.int32, device=dev).index_add_(
        0, run_id, svalid.to(torch.int32))[:mv]

    # every row of a run has the run's coords; rows of no kept voxel go to
    # the spare segment mv
    cs = c[order]
    zyx = torch.stack([cs[:, 2], cs[:, 1], cs[:, 0]], 1).clamp_min(0)
    coords = torch.zeros((mv + 1, 3), dtype=torch.long, device=dev).scatter_reduce_(
        0, run_id[:, None].expand(-1, 3), zyx, "amax")[:mv].to(torch.int32)

    return VoxelizationResult(features, coords, num_points, num_points > 0,
                              torch.where(run_id < mv, run_id, -1).to(torch.int32),
                              order)


def voxelize_batch(points: torch.Tensor, valid: torch.Tensor, *,
                   point_cloud_range, voxel_size, max_voxels: int,
                   max_points_per_voxel: int = 0):
    """(B, P, 3+C) -> per-frame voxels, concatenated with batch indices:
    (features (B*V, C), coords (B*V, 4) int32 [b, z, y, x], mask (B*V,)).
    Rows are globally key-sorted with the padding rows last, the layout the
    sparse backbone's lookups rely on."""
    res = [voxelize(points[i], valid[i], point_cloud_range=point_cloud_range,
                    voxel_size=voxel_size, max_voxels=max_voxels,
                    max_points_per_voxel=max_points_per_voxel)
           for i in range(points.shape[0])]
    feats = torch.cat([r.features for r in res])
    coords = torch.cat([torch.cat([torch.full_like(r.coords[:, :1], i), r.coords], 1)
                        for i, r in enumerate(res)])
    mask = torch.cat([r.mask for r in res])
    nx, ny, nz = (int(g) for g in grid_size(point_cloud_range, voxel_size))
    c = coords.long()
    key = ((c[:, 0] * nz + c[:, 1]) * ny + c[:, 2]) * nx + c[:, 3]
    key = torch.where(mask, key, _BIG)
    order = torch.sort(key, stable=True).indices
    return feats[order], coords[order], mask[order]
