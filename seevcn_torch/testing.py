"""Helpers for holding the port against its reference: numpy <-> torch
conversion, an ``assert_close`` that names the worst element, the cases at
the edges of kernel K2's tiling, and the tiny Mask R-CNN config, which the
tests and chip_smoke.py both use."""
from __future__ import annotations

import re

import numpy as np
import torch

from seevcn_torch.models.seg2d.maskrcnn import Seg2DConfig
from seevcn_torch.ops.cuda.min_dist import FAR


def to_torch(x, device: str | torch.device = "cpu") -> torch.Tensor:
    """numpy array (or anything np.asarray takes) -> torch tensor."""
    return torch.tensor(np.asarray(x), device=device)


def to_numpy(x) -> np.ndarray:
    """torch tensor (any device) or array-like -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(actual, expected, atol: float = 0.0, rtol: float = 0.0,
                 name: str = "value") -> None:
    """Raise AssertionError unless |actual - expected| <= atol + rtol*|expected|
    everywhere; the message names the worst element and its two values.
    Boolean and integer inputs are compared for exact equality."""
    a, e = to_numpy(actual), to_numpy(expected)
    if a.shape != e.shape:
        raise AssertionError(f"{name}: shape {a.shape} != {e.shape}")
    if a.size == 0:
        return
    if a.dtype == bool or e.dtype == bool or (
            np.issubdtype(a.dtype, np.integer)
            and np.issubdtype(e.dtype, np.integer)):
        bad = a != e
        if bad.any():
            idx = np.unravel_index(np.argmax(bad), a.shape)
            raise AssertionError(
                f"{name}: {int(bad.sum())} of {a.size} elements differ; "
                f"first at {idx}: {a[idx]} != {e[idx]}")
        return
    a64, e64 = a.astype(np.float64), e.astype(np.float64)
    err = np.abs(a64 - e64)
    err = np.where(np.isnan(a64) & np.isnan(e64), 0.0, err)
    err = np.where(np.isinf(e64) & (a64 == e64), 0.0, err)
    excess = err - (atol + rtol * np.abs(e64))
    excess = np.where(np.isnan(excess), np.inf, excess)
    if (excess > 0).any():
        idx = np.unravel_index(np.argmax(excess), a.shape)
        raise AssertionError(
            f"{name}: {int((excess > 0).sum())} of {a.size} elements exceed "
            f"atol={atol} rtol={rtol}; worst at {idx}: {a[idx]} vs {e[idx]} "
            f"(|diff| {err[idx]:.3g})")


# K2's tiling (ops/cuda/min_dist.py): units of K2_GROUP = 1,024 query rows
# (8 a thread) by K2_TILE = 512 support rows, cut into runs, one a block.
# N of 1, one below and one above a unit's rows, not a multiple of 8; M of
# 1, one below and one above one and two tiles; a support of rows all at
# the pushed value 1e9; query rows at 1e9, where a padding row at 1e9 would
# read 0; several blocks whose minima meet on each row; and, on the card,
# more units than the card holds blocks, so that runs cross from one row
# group into the next (the plain version of that case is too large for a
# CPU).
K2_EDGES = ("n1_m513", "n1023_m1", "n1025_m511_invalid", "n1030_m1025",
            "n1024_m1023", "n2049_m512", "all_rows_far", "queries_at_far",
            "n2100_m9000_invalid")
K2_CARD_EDGES = K2_EDGES + ("n20000_m40000",)


def k2_edge_case(name: str):
    """One of K2_CARD_EDGES as numpy (a (N, 3), b (M, 3), valid (M,) or
    None), made from a seed."""
    rng = np.random.RandomState(40 + K2_CARD_EDGES.index(name))

    def cloud(n):
        return rng.uniform(-30, 30, (n, 3)).astype(np.float32)

    far = np.float32(FAR)
    if name == "all_rows_far":
        return cloud(300), np.full((600, 3), far, np.float32), None
    if name == "queries_at_far":
        return (np.concatenate([cloud(5), np.full((4, 3), far, np.float32)]),
                cloud(700), None)
    n, m = (int(x) for x in re.match(r"n(\d+)_m(\d+)", name).groups())
    valid = rng.rand(m) > 0.3 if name.endswith("invalid") else None
    return cloud(n), cloud(m), valid


def tiny_seg2d_cfg() -> Seg2DConfig:
    """The reference's tiny Mask R-CNN test config (tests/test_seg2d.py's
    ``_tiny_cfg``): a 96x128 image, one block a stage at widths (16, 32, 64,
    64), FPN width 32, 128 pre-NMS proposals, 32 RoIs, 4 detections."""
    return Seg2DConfig(image_size=(96, 128), max_gt=4, pre_nms_topk=128,
                       num_proposals=32, roi_batch=16, rpn_batch=64,
                       max_detections=4, stage_sizes=(1, 1, 1, 1),
                       stage_channels=(16, 32, 64, 64), fpn_channels=32,
                       box_hidden=128, mask_channels=32, mask_convs=2)
