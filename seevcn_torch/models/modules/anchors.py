"""Anchor generation (port of ``generate_anchors`` of
seevcn_tpu/models/modules/anchors.py; reference anchor_generator.py:17-60):
grid anchors at every feature-map cell, per class sizes, rotations and
bottom heights, flattened (z, y, x, size, rot) as the conv head's channels
are. Host-side numpy, as in the reference.
"""
from __future__ import annotations

import numpy as np


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range,
                     anchor_ndim: int = 7):
    """Host-side (numpy): returns (anchors (A, anchor_ndim) float32,
    num_anchors_per_location list). Multi-class anchors are concatenated on
    the per-location 'size' axis, matching the reference cat(dim=-3)."""
    pcr = np.asarray(point_cloud_range, dtype=np.float64)
    per_class = []
    num_per_loc = []
    for cfg in anchor_generator_cfg:
        stride = int(cfg["feature_map_stride"])
        gx, gy = int(grid_size[0]) // stride, int(grid_size[1]) // stride
        sizes = np.asarray(cfg["anchor_sizes"], dtype=np.float64)       # (S, 3)
        rots = np.asarray(cfg["anchor_rotations"], dtype=np.float64)    # (R,)
        heights = np.asarray(cfg["anchor_bottom_heights"], dtype=np.float64)  # (Z,)
        align = bool(cfg.get("align_center", False))
        num_per_loc.append(len(sizes) * len(rots) * len(heights))

        if align:
            xs = (pcr[3] - pcr[0]) / gx
            ys = (pcr[4] - pcr[1]) / gy
            xo, yo = xs / 2, ys / 2
        else:
            xs = (pcr[3] - pcr[0]) / (gx - 1)
            ys = (pcr[4] - pcr[1]) / (gy - 1)
            xo = yo = 0.0
        x_shifts = np.arange(pcr[0] + xo, pcr[3] + 1e-5, xs)
        y_shifts = np.arange(pcr[1] + yo, pcr[4] + 1e-5, ys)

        X, Y, Z = np.meshgrid(x_shifts, y_shifts, heights, indexing="ij")  # (gx, gy, gz)
        cent = np.stack([X, Y, Z], axis=-1)                                 # (gx, gy, gz, 3)
        a = np.broadcast_to(cent[:, :, :, None, None, :],
                            (*cent.shape[:3], len(sizes), len(rots), 3))
        s = np.broadcast_to(sizes[None, None, None, :, None, :], a.shape)
        r = np.broadcast_to(rots[None, None, None, None, :, None],
                            (*a.shape[:-1], 1))
        anchors = np.concatenate([a, s, r], axis=-1)        # (gx, gy, gz, S, R, 7)
        anchors = anchors.transpose(2, 1, 0, 3, 4, 5)       # (gz, gy, gx, S, R, 7)
        anchors[..., 2] += anchors[..., 5] / 2              # bottom -> center z
        per_class.append(anchors)

    cat = np.concatenate(per_class, axis=3)                  # stack classes on size axis
    flat = cat.reshape(-1, 7).astype(np.float32)
    if anchor_ndim != 7:
        flat = np.concatenate(
            [flat, np.zeros((len(flat), anchor_ndim - 7), np.float32)], axis=1)
    return flat, num_per_loc
