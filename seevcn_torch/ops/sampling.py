"""Point-set sampling ops in torch (port of seevcn_tpu/ops/sampling.py):
pairwise distances, fixed-size tiling, partial-mesh kNN selection and the
within-radius test of the replacement stage.

Fixed shapes and boolean validity masks, as in the reference; every
function takes an optional leading batch dimension where the reference
vmaps.
"""
from __future__ import annotations

import torch

from .cuda.min_dist import min_sqdist


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances.

    Gram form |a|^2 + |b|^2 - 2 a.b, clamped at 0, as the reference computes
    it: DBSCAN's eps adjacency is defined on these values."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp_min(a2 + b2 - 2 * ab, 0.0)


def tile_to_n(points: torch.Tensor, valid: torch.Tensor, n: int):
    """Cyclically repeat the valid rows of (..., M, C) to exactly (..., n, C)
    (the reference's ``np.tile(sel, [n, 1])[:n]``). Valid rows keep their
    order (stable sort). Returns (out (..., n, C), ok (...,) bool)."""
    m = points.shape[-2]
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    cnt = valid.sum(-1).clamp_min(1).clamp_max(m)                 # (...,)
    pos = torch.arange(n, device=points.device) % cnt[..., None]  # (..., n)
    idx = torch.gather(order, -1, pos)
    out = torch.gather(points, -2,
                       idx[..., None].expand(*idx.shape, points.shape[-1]))
    return out, valid.any(-1)


def knn_union_mask(partial_pc: torch.Tensor, complete_pc: torch.Tensor, k: int,
                   partial_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Union of the k nearest ``complete`` points over every valid
    ``partial`` point: (..., N, 3), (..., M, 3) -> (..., M) bool.

    The reference's ``approx_max_k`` is exact off the TPU; ``topk`` is the
    exact selection it lowers to there."""
    d = pairwise_sqdist(partial_pc, complete_pc)                   # (..., N, M)
    m = complete_pc.shape[-2]
    _, idx = torch.topk(d, k, dim=-1, largest=False)               # (..., N, k)
    if partial_valid is not None:
        idx = torch.where(partial_valid[..., None], idx, m)        # drop rows
    mask = torch.zeros((*idx.shape[:-2], m + 1), dtype=torch.bool,
                       device=d.device)
    mask.scatter_(-1, idx.flatten(-2), True)
    return mask[..., :m]


def partial_mesh_batch(batch_partial: torch.Tensor, batch_complete: torch.Tensor,
                       k: int = 30, surface_pts: int = 1024,
                       partial_valid: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) observed, (B, M, 3) predicted -> (B, surface_pts, 3): the
    predicted points near observed ones, cyclically tiled to a fixed count."""
    sel = knn_union_mask(batch_partial, batch_complete, k, partial_valid)
    out, _ = tile_to_n(batch_complete, sel, surface_pts)
    return out


def within_radius_mask(a: torch.Tensor, b: torch.Tensor, radius: float,
                       b_valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) bool: does each point of ``a`` (N, 3) have a valid ``b`` (M, 3)
    point within ``radius``? On a CUDA tensor this always runs the pruned
    min-distance kernel; on a CPU tensor its plain version."""
    d = min_sqdist(a[:, :3], b[:, :3], b_valid=b_valid,
                   prune_radius=float(radius))
    return d <= radius * radius
