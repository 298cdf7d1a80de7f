"""Voxelisation and the voxel mean (MeanVFE) as their definitions.

Each point inside the range falls in the voxel floor((p - min) / size);
voxels are numbered in ascending z-major key order, and the ``max_voxels``
with the lowest keys are kept. A voxel's feature is the mean of its first
``max_points_per_voxel`` points in input order (every point where 0).

The mean is a fixed-order sum: each kept point is written to its own slot
(voxel, rank within the voxel), a (V, slots, C) table with zeros in the
empty slots, which is summed over its slot axis. No slot is written twice,
so no sum depends on the order in which a device adds.
"""
from __future__ import annotations

import numpy as np
import torch


def grid_size(point_cloud_range, voxel_size) -> np.ndarray:
    pcr = np.asarray(point_cloud_range, dtype=np.float64)
    vs = np.asarray(voxel_size, dtype=np.float64)
    return np.round((pcr[3:6] - pcr[0:3]) / vs).astype(np.int64)  # (nx, ny, nz)


def voxelize(points: torch.Tensor, valid: torch.Tensor, *, point_cloud_range, voxel_size,
             max_voxels: int, max_points_per_voxel: int = 0):
    """points (P, 3+C) -> (features (V, 3+C), coords (V, 3) int32 [z, y, x]),
    V <= max_voxels, in ascending key order."""
    dev = points.device
    pcr = torch.tensor(point_cloud_range, dtype=points.dtype, device=dev)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    nx, ny, nz = (int(g) for g in grid_size(point_cloud_range, voxel_size))
    c = torch.floor((points[:, :3] - pcr[0:3]) / vs).long()
    inside = valid & (c >= 0).all(1) & (c < torch.tensor([nx, ny, nz], device=dev)).all(1)
    idx = torch.nonzero(inside)[:, 0]                       # input order
    key = (c[idx, 2] * ny + c[idx, 1]) * nx + c[idx, 0]
    keys, vox, counts = torch.unique(key, return_inverse=True, return_counts=True)
    # rank of each point within its voxel, in input order
    order = torch.argsort(vox, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(vox)
    rank[order] = torch.arange(vox.shape[0], device=dev) - starts[vox[order]]
    slots = int(counts.max()) if counts.numel() else 1
    if max_points_per_voxel > 0:
        slots = min(slots, int(max_points_per_voxel))
    keep = (rank < slots) & (vox < int(max_voxels))
    table = points.new_zeros((keys.shape[0], slots, points.shape[1]))
    table[vox[keep], rank[keep]] = points[idx[keep]]
    n = counts.clamp_max(slots).to(points.dtype)
    feats = table.sum(1) / n[:, None]
    keys = keys[:int(max_voxels)]
    coords = torch.stack([keys // (nx * ny), keys // nx % ny, keys % nx], 1).to(torch.int32)
    return feats[:int(max_voxels)], coords


def voxelize_batch(points: torch.Tensor, valid: torch.Tensor, *, point_cloud_range,
                   voxel_size, max_voxels: int, max_points_per_voxel: int = 0):
    """(B, P, 3+C) -> (features (N, C), coords (N, 4) int32 [b, z, y, x],
    mask (N,)): every frame's voxels, frame after frame."""
    feats, coords = [], []
    for b in range(points.shape[0]):
        f, c = voxelize(points[b], valid[b], point_cloud_range=point_cloud_range,
                        voxel_size=voxel_size, max_voxels=max_voxels,
                        max_points_per_voxel=max_points_per_voxel)
        feats.append(f)
        coords.append(torch.cat([torch.full_like(c[:, :1], b), c], 1))
    feats, coords = torch.cat(feats), torch.cat(coords)
    return feats, coords, torch.ones(feats.shape[0], dtype=torch.bool, device=feats.device)
