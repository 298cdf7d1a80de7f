"""Chamfer distances in torch (port of seevcn_tpu/ops/chamfer.py).

Mask-aware: padded points are excluded from both the min and the mean."""
from __future__ import annotations

import torch

from .sampling import pairwise_sqdist


def chamfer_sq(xyz1: torch.Tensor, xyz2: torch.Tensor,
               valid1: torch.Tensor | None = None,
               valid2: torch.Tensor | None = None):
    """Per-point squared NN distances both ways.

    xyz1 (B, N, 3), xyz2 (B, M, 3) -> dist1 (B, N), dist2 (B, M). As in the
    reference, the 2 -> 1 direction reads the distances before ``valid2``
    masked them."""
    d = pairwise_sqdist(xyz1, xyz2)                                # (B, N, M)
    d12 = d if valid2 is None else torch.where(valid2[:, None, :], d,
                                               float("inf"))
    dist1 = d12.amin(-1)
    d_t = d.transpose(-1, -2)
    if valid1 is not None:
        d_t = torch.where(valid1[:, None, :], d_t, float("inf"))
    dist2 = d_t.amin(-1)
    if valid1 is not None:
        dist1 = torch.where(valid1, dist1, 0.0)
    if valid2 is not None:
        dist2 = torch.where(valid2, dist2, 0.0)
    return dist1, dist2


def _masked_mean(x, mask):
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def chamfer_l2(xyz1, xyz2, valid1=None, valid2=None):
    """mean(sq-NN 1->2) + mean(sq-NN 2->1)   (ChamferDistanceL2)."""
    d1, d2 = chamfer_sq(xyz1, xyz2, valid1, valid2)
    return _masked_mean(d1, valid1) + _masked_mean(d2, valid2)


def chamfer_l2_split(xyz1, xyz2, valid1=None, valid2=None):
    """The two directions of chamfer_l2: (mean sq-NN 1->2, mean sq-NN 2->1)."""
    d1, d2 = chamfer_sq(xyz1, xyz2, valid1, valid2)
    return _masked_mean(d1, valid1), _masked_mean(d2, valid2)


def chamfer_l1(xyz1, xyz2, valid1=None, valid2=None):
    """(mean(NN-dist 1->2) + mean(NN-dist 2->1)) / 2   (ChamferDistanceL1)."""
    d1, d2 = chamfer_sq(xyz1, xyz2, valid1, valid2)
    eps = 1e-12
    m1 = _masked_mean(torch.sqrt(d1 + eps), valid1)
    m2 = _masked_mean(torch.sqrt(d2 + eps), valid2)
    return (m1 + m2) / 2
