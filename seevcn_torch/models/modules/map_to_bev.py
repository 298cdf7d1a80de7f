"""Sparse 3D or pillars -> dense BEV (port of
seevcn_tpu/models/modules/map_to_bev.py; reference height_compression.py and
pointpillar_scatter.py)."""
from __future__ import annotations

import torch

from ...ops import sparse as SP


def height_compression(st: SP.SparseTensor) -> torch.Tensor:
    """SparseTensor (stride 8, few z levels) -> (B, H, W, C*D) BEV features,
    channel c*D + d as in the reference's (N, C, D, H, W) flatten; the dtype
    of the features (bf16 when the backbone runs in bf16)."""
    dense = SP.to_dense(st)                          # (B, D, H, W, C)
    b, d, h, w, c = dense.shape
    return dense.permute(0, 2, 3, 4, 1).reshape(b, h, w, c * d)


def pillar_scatter(features: torch.Tensor, coords: torch.Tensor, mask: torch.Tensor,
                   batch_size: int, grid) -> torch.Tensor:
    """PointPillarScatter: pillar features (N, C) with coords (N, 4) [b, z=0,
    y, x] -> (B, ny, nx, C), added onto a zero canvas; rows off ``mask``
    add zeros at cell (0, 0, 0). ``grid`` is (nx, ny)."""
    nx, ny = int(grid[0]), int(grid[1])
    c = coords.long()
    lin = torch.where(mask, (c[:, 0] * ny + c[:, 2]) * nx + c[:, 3], 0)
    feats = torch.where(mask[:, None], features,
                        torch.zeros((), dtype=features.dtype, device=features.device))
    canvas = features.new_zeros((batch_size * ny * nx, features.shape[1]))
    return canvas.index_add(0, lin, feats).view(batch_size, ny, nx, -1)
