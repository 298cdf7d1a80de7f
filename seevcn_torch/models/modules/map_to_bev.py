"""Sparse 3D -> dense BEV (port of the HeightCompression path of
seevcn_tpu/models/modules/map_to_bev.py; reference height_compression.py)."""
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
