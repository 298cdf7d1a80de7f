"""Density clustering (DBSCAN-equivalent) in torch (port of
seevcn_tpu/ops/clustering.py).

A point is *core* iff its eps-ball holds >= min_points points (itself
included). Labels propagate only through core points; border points adopt
the smallest neighbouring core label; the rest is noise (-1). A cluster id
is the index of its smallest core member, as in the reference, so the ids
and not only the partition agree. Every function takes a leading batch
dimension where the reference vmaps.
"""
from __future__ import annotations

import torch

from .sampling import pairwise_sqdist, tile_to_n


def dbscan(points: torch.Tensor, eps, min_points: int = 1,
           valid: torch.Tensor | None = None, n_iters: int = 12) -> torch.Tensor:
    """points (..., N, 3), eps scalar or (...,) -> (..., N) int32 labels;
    -1 = noise / invalid. ``n_iters`` rounds of neighbour-min + pointer
    jumping handle chain diameters up to ~2^n_iters."""
    n = points.shape[-2]
    if valid is None:
        valid = torch.ones(points.shape[:-1], dtype=torch.bool,
                           device=points.device)
    eps = torch.as_tensor(eps, dtype=points.dtype, device=points.device)
    eps2 = (eps * eps)[..., None, None]
    adj = pairwise_sqdist(points, points) <= eps2
    adj = adj & valid[..., :, None] & valid[..., None, :]

    deg = adj.sum(-1)                                  # self included
    core = (deg >= min_points) & valid
    big = n
    idx = torch.arange(n, dtype=torch.int32,
                       device=points.device).expand(points.shape[:-1])
    labels = torch.where(core, idx, big)
    core_adj = adj & core[..., :, None] & core[..., None, :]
    for _ in range(n_iters):
        nbr = torch.where(core_adj, labels[..., None, :], big).amin(-1)
        labels = torch.minimum(labels, nbr)
        # pointer jumping: a label is the index of a smaller core point
        labels = torch.minimum(labels,
                               torch.gather(labels, -1,
                                            labels.clamp(0, n - 1).long()))

    border = torch.where(adj & core[..., None, :], labels[..., None, :],
                         big).amin(-1)
    labels = torch.where(core, labels, border)
    noise = ~valid | (labels >= big)
    return torch.where(noise, -1, labels)


def _cluster_sums(labels: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per-cluster sums of (..., N[, C]) values into (..., N + 1[, C]) bins;
    noise goes to the last bin."""
    n = labels.shape[-1]
    safe = torch.where(labels >= 0, labels, n).long()
    shape = (*labels.shape[:-1], n + 1, *values.shape[labels.dim():])
    if values.dim() > labels.dim():
        safe = safe[..., None].expand(values.shape)
    return torch.zeros(shape, dtype=values.dtype,
                       device=values.device).scatter_add_(labels.dim() - 1,
                                                          safe, values)


def largest_cluster_mask(labels: torch.Tensor) -> torch.Tensor:
    """(..., N) labels -> (..., N) bool mask of the biggest non-noise
    cluster; ties go to the smallest id."""
    n = labels.shape[-1]
    counts = _cluster_sums(labels, torch.ones_like(labels))[..., :n]
    best = counts.argmax(-1, keepdim=True)
    return (labels == best) & (labels >= 0)


def best_cluster_mask(labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mask of the cluster with the highest integer weight sum, ties broken
    by size, then by the smallest id."""
    n = labels.shape[-1]
    counts = _cluster_sums(labels, torch.ones_like(labels))[..., :n]
    wsum = _cluster_sums(labels, weights.to(labels.dtype))[..., :n]
    best = (wsum * (n + 1) + counts).argmax(-1, keepdim=True)
    return (labels == best) & (labels >= 0)


def nearest_core_cluster_mask(labels: torch.Tensor, core: torch.Tensor,
                              points: torch.Tensor, min_core_pts: int = 3,
                              min_core_frac: float = 0.15,
                              merge_radius: float = 2.5) -> torch.Tensor:
    """Mask-core cluster selection with a nearest-surface prior.

    (..., N) labels, (..., N) bool core bits, (..., N, 3) points -> bool
    mask. Among clusters holding >= ``min_core_pts`` and >= ``min_core_frac``
    of all core points, seed on the one with the smallest mean core range,
    then merge every core-supported cluster whose centroid lies within
    ``merge_radius`` of the seed's. With no eligible cluster, fall back to
    the core/size vote of ``best_cluster_mask``."""
    n = labels.shape[-1]
    counts = _cluster_sums(labels, torch.ones_like(labels))[..., :n]
    wsum = _cluster_sums(labels, core.to(labels.dtype))[..., :n]
    rng = torch.linalg.norm(points, dim=-1)
    rsum = _cluster_sums(labels, torch.where(core, rng, 0.0))[..., :n]
    csum = _cluster_sums(labels, points)[..., :n, :]
    centroid = csum / counts.clamp_min(1)[..., None].to(points.dtype)
    mean_core_r = rsum / wsum.clamp_min(1).to(points.dtype)

    total_core = wsum.sum(-1, keepdim=True)
    eligible = ((wsum >= min_core_pts) & (wsum >= min_core_frac * total_core)
                & (counts > 0))
    seed_near = torch.where(eligible, mean_core_r, float("inf")).argmin(-1)
    seed_vote = (wsum * (n + 1) + counts).argmax(-1)
    seed = torch.where(eligible.any(-1), seed_near, seed_vote)[..., None]

    seed_c = torch.gather(centroid, -2,
                          seed[..., None].expand(*seed.shape, 3))
    d2 = ((centroid - seed_c) ** 2).sum(-1)
    keep = (d2 <= merge_radius * merge_radius) & (wsum >= min_core_pts)
    keep = keep.scatter(-1, seed, True)
    return torch.gather(keep, -1, labels.clamp(0, n - 1).long()) & (labels >= 0)


def largest_cluster_batch(points: torch.Tensor, eps: float, min_points: int = 2,
                          total_pts: int = 1024,
                          valid: torch.Tensor | None = None,
                          n_iters: int = 12) -> torch.Tensor:
    """(B, N, 3) -> (B, total_pts, 3): each set's largest cluster, tiled to a
    fixed count; a set that is all noise keeps its valid points."""
    if valid is None:
        valid = torch.ones(points.shape[:2], dtype=torch.bool,
                           device=points.device)
    labels = dbscan(points, eps, min_points=min_points, valid=valid,
                    n_iters=n_iters)
    mask = largest_cluster_mask(labels)
    mask = torch.where(mask.any(-1, keepdim=True), mask, valid)
    out, _ = tile_to_n(points, mask, total_pts)
    return out
