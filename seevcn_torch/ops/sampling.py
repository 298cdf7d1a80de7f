"""Point-set sampling ops in torch (port of seevcn_tpu/ops/sampling.py):
pairwise distances, fixed-size tiling, farthest point sampling,
partial-mesh kNN selection and the within-radius test of the replacement
stage.

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


@torch.no_grad()
def farthest_point_sample(points: torch.Tensor, n_samples: int,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Iterative FPS: (..., N, 3) -> (..., n_samples) int64 indices.

    Starts at the first valid point with every distance at +inf; each step
    takes the argmax of the running min squared distance over the valid
    points (ties to the lower index; invalid points are never picked, and
    with fewer valid points than ``n_samples`` the picks repeat among them).
    One loop of ``n_samples`` steps serves the whole batch. The squared
    distance is summed x, y, z in that order, as the reference's reduction
    over the last axis does, and each step is elementwise, so every device
    picks the same points."""
    *lead, n, _ = points.shape
    p = points.reshape(-1, n, 3)
    b = p.shape[0]
    v = None if valid is None else valid.reshape(b, n)
    rows = torch.arange(b, device=p.device)
    min_d = torch.full((b, n), float("inf"), dtype=p.dtype, device=p.device)
    last = (torch.zeros(b, dtype=torch.long, device=p.device) if v is None
            else torch.argmax(v.to(torch.uint8), dim=1))
    picks = []
    for _ in range(n_samples):
        picks.append(last)
        diff = p - p[rows, last][:, None]
        dx, dy, dz = diff.unbind(-1)
        torch.minimum(min_d, dx * dx + dy * dy + dz * dz, out=min_d)
        last = torch.argmax(min_d if v is None else torch.where(v, min_d, -1.0),
                            dim=1)
    return torch.stack(picks, -1).reshape(*lead, n_samples)


def fps(points: torch.Tensor, n_samples: int,
        valid: torch.Tensor | None = None) -> torch.Tensor:
    """FPS gather: (..., N, 3) -> (..., n_samples, 3) (VCN misc.fps)."""
    idx = farthest_point_sample(points, n_samples, valid)
    return torch.gather(points, -2,
                        idx[..., None].expand(*idx.shape, points.shape[-1]))


def knn_union_mask(partial_pc: torch.Tensor, complete_pc: torch.Tensor, k: int,
                   partial_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Union of the k nearest ``complete`` points over every valid
    ``partial`` point: (..., N, 3), (..., M, 3) -> (..., M) bool.

    The reference's ``approx_max_k`` is exact off the TPU; ``topk`` is the
    exact selection it lowers to there. The selection carries no gradient,
    so the distances are taken from detached inputs."""
    d = pairwise_sqdist(partial_pc.detach(), complete_pc.detach())  # (..., N, M)
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
