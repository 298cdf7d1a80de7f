"""HeightCompression: the stride-8 sparse tensor as a dense BEV map."""
from __future__ import annotations

import torch

from ...ops import sparse as SP


def height_compression(st: SP.SparseTensor) -> torch.Tensor:
    """-> (B, H, W, C*D) in the features' dtype, channel c*D + d as
    OpenPCDet's view of (N, C, D, H, W) as (N, C*D, H, W)."""
    dense = SP.to_dense(st)                          # (B, C, D, H, W)
    b, c, d, h, w = dense.shape
    return dense.reshape(b, c * d, h, w).permute(0, 2, 3, 1)
