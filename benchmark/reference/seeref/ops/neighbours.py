"""Neighbourhood operations of SEE, as their definitions, in float64 with
direct squared distances: DBSCAN, its largest cluster, the k-nearest union
of the partial mesh and the cyclic tiling to a fixed count."""
from __future__ import annotations

import torch


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3), (M, 3) -> (N, M) squared distances, float64, as differences."""
    return ((a.double()[:, None, :] - b.double()[None, :, :]) ** 2).sum(-1)


def dbscan(points: torch.Tensor, eps: float, min_points: int) -> torch.Tensor:
    """(N, 3) -> (N,) labels: a point is core where its eps-ball holds
    min_points points, itself included; core points within eps of each
    other share a cluster, whose label is the index of its first core
    point; any other point takes the smallest label of the core points
    within eps, or -1 (noise)."""
    n = points.shape[0]
    adj = sqdist(points, points) <= float(eps) ** 2
    core = adj.sum(1) >= min_points
    link = adj & core[:, None] & core[None, :]
    idx = torch.arange(n, device=points.device)
    label = torch.where(core, idx, n)
    while True:                                   # to the fixed point: exact closure
        nxt = torch.where(link, label[None, :], n).amin(1)
        nxt = torch.minimum(label, nxt)
        if torch.equal(nxt, label):
            break
        label = nxt
    border = torch.where(adj & core[None, :], label[None, :], n).amin(1)
    label = torch.where(core, label, border)
    return torch.where(label < n, label, -1)


def largest_cluster(labels: torch.Tensor) -> torch.Tensor:
    """(N,) -> (N,) bool: the cluster with the most members, the smallest
    label at a tie; all False where every point is noise."""
    ok = labels >= 0
    if not bool(ok.any()):
        return ok
    counts = torch.bincount(labels[ok], minlength=labels.shape[0])
    return labels == int(torch.argmax(counts))    # the first maximum


def tile(points: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """The kept rows of (M, C), in order, repeated cyclically to n rows; with
    no kept row, row 0 repeated."""
    rows = torch.nonzero(keep)[:, 0]
    if rows.numel() == 0:
        rows = rows.new_zeros(1)
    return points[rows[torch.arange(n, device=points.device) % rows.numel()]]


def knn_union(partial: torch.Tensor, complete: torch.Tensor, k: int) -> torch.Tensor:
    """(N, 3), (M, 3) -> (M,) bool: the complete points among the k nearest
    of some partial point (the first k at a tie, by index)."""
    d = sqdist(partial, complete)
    order = torch.argsort(d, dim=1, stable=True)[:, :k]
    keep = torch.zeros(complete.shape[0], dtype=torch.bool, device=complete.device)
    keep[order.reshape(-1)] = True
    return keep
