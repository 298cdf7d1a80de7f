"""Exact RoI-aware grid pooling (port of seevcn_tpu/ops/roiaware.py;
reference ops/roiaware_pool3d, roiaware_pool3d_kernel.cu).

Each RoI is split into a G^3 grid in its own frame; a point (or voxel
centre) inside the box lands in the one cell its box-local coordinates
name, floor((local / max(size, 1e-6) + 0.5) G) on each axis, and each
cell pools the max or the mean of its points' features. Cells are x-major
(flat = (x G + y) G + z), as the reference kernel numbers them, and an
empty cell is 0.

The pool runs on the (RoI, point) pairs that land in a cell: ``roi_cells``
gives every pair's cell, then one scatter over those pairs (a max with no
initial value, or a sum and a count). A cell index is an f32 choice: a
point on a cell face may fall on either side on another device, which is
why ``roi_cells`` is a function of its own.
"""
from __future__ import annotations

import torch

from ..geom.transforms import rotate_points_along_z


def roi_cells(rois: torch.Tensor, xyz: torch.Tensor, valid: torch.Tensor,
              grid_size: int) -> torch.Tensor:
    """rois (R, 7), xyz (N, 3), valid (N,) -> (R, N) int64 flat cell of each
    (RoI, point) pair, G^3 where the point is outside the RoI or invalid."""
    g = int(grid_size)
    r = rois.shape[0]
    local = rotate_points_along_z(xyz[None, :, :3].expand(r, -1, -1) - rois[:, None, :3],
                                  -rois[:, 6])
    u = local / rois[:, None, 3:6].clamp_min(1e-6) + 0.5
    cell = torch.floor(u * g).long()
    inside = ((cell >= 0) & (cell < g)).all(-1) & valid[None, :]
    flat = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    return torch.where(inside, flat, g ** 3)


def roiaware_pool3d(rois: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor,
                    valid: torch.Tensor, grid_size: int = 12,
                    method: str = "max") -> torch.Tensor:
    """rois (R, 7), xyz (N, 3), feats (N, C), valid (N,) -> (R, G^3, C):
    each cell's max (``method="max"``) or mean (``"avg"``) of the features
    of the valid points inside it, 0 where it has none."""
    if method not in ("max", "avg"):
        raise ValueError(f"roiaware pool method {method}")
    g3 = int(grid_size) ** 3
    r, c = rois.shape[0], feats.shape[1]
    cells = roi_cells(rois, xyz, valid, grid_size)
    roi, point = torch.nonzero(cells < g3, as_tuple=True)
    slot = roi * g3 + cells[roi, point]
    src = feats[point]
    out = feats.new_zeros((r * g3, c))
    if method == "max":
        out.scatter_reduce_(0, slot[:, None].expand(-1, c), src, "amax", include_self=False)
    else:
        out.index_add_(0, slot, src)
        cnt = feats.new_zeros(r * g3).index_add_(0, slot, torch.ones_like(src[:, 0]))
        out = out / cnt.clamp_min(1.0)[:, None]
    return out.view(r, g3, c)


def roiaware_pool3d_batch(rois: torch.Tensor, xyz: torch.Tensor, feats: torch.Tensor,
                          valid: torch.Tensor, grid_size: int = 12,
                          method: str = "max") -> torch.Tensor:
    """Per frame: rois (B, R, 7), xyz (B, N, 3), feats (B, N, C), valid (B,
    N) -> (B, R, G^3, C)."""
    return torch.stack([roiaware_pool3d(ro, x, f, v, grid_size, method)
                        for ro, x, f, v in zip(rois, xyz, feats, valid)])
