"""Host-side VCN training augmentations over ragged object clouds (the
port's copy of seevcn_tpu/models/vcn/transforms.py: with the same
``np.random.Generator`` it draws the same numbers in the same order).

Reference: see/.../models/vcn/datasets/data_transforms.py — notably
``LidarSimulation`` (ring-histogram subsampling that emulates arbitrary beam
counts, :142-201) which is the key ingredient of VCN's scan-pattern
invariance. These run in the input pipeline on numpy (ragged, data-dependent
shapes); the device side always receives fixed (B, 1024, 3) batches.
"""
from __future__ import annotations

import numpy as np

from ...geom.transforms import rotate_points_along_z_np


def cart2sph(pts: np.ndarray) -> np.ndarray:
    """(N,3) xyz -> (N,3) [r, azimuth, elevation]."""
    r = np.linalg.norm(pts, axis=1)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    el = np.arcsin(np.clip(pts[:, 2] / np.maximum(r, 1e-9), -1, 1))
    return np.stack([r, az, el], axis=1)


def sph2cart(sph: np.ndarray) -> np.ndarray:
    r, az, el = sph[:, 0], sph[:, 1], sph[:, 2]
    return np.stack([r * np.cos(el) * np.cos(az),
                     r * np.cos(el) * np.sin(az),
                     r * np.sin(el)], axis=1)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, pts, **kw):
        for t in self.transforms:
            pts = t(pts, **kw) if getattr(t, "needs_kw", False) else t(pts)
        return pts


class LidarSimulation:
    """Ring-subsampling augmentation (data_transforms.py:142-201): bucket
    points into elevation rings via a histogram, keep every Nth ring from a
    random offset, then every Mth point within kept rings; 20% of the time
    degrade to a 1-2-ring (nuScenes-like) pattern."""

    def __init__(self, params=None, rng=None):
        self.rng = rng or np.random.default_rng()

    def __call__(self, pts, min_in_pts=100, min_out_pts=30,
                 max_sel_n_hpts_1_2_ring=30):
        rng = self.rng
        if len(pts) < min_in_pts:
            return pts
        sph = cart2sph(pts)
        hist, edges = np.histogram(sph[:, 2], bins="sqrt")
        ring_idx = np.digitize(sph[:, 2], edges[np.argwhere(hist > 0).ravel()])
        num_rings = int(ring_idx.max())

        sel_n_ring = rng.integers(1, max(int(np.ceil(num_rings * 0.3)), 2))
        start = rng.integers(0, max(int(np.ceil(num_rings * 0.1)), 1))
        chosen = np.unique(ring_idx)[start::sel_n_ring]
        mask = np.isin(ring_idx, chosen)

        _, counts = np.unique(ring_idx[mask], return_counts=True)
        if len(counts) == 0:
            return pts
        sel_n = rng.integers(1, max(int(np.ceil(counts.min() * 0.5)), 2))
        offset = rng.integers(0, counts.min())
        out = sph2cart(sph[mask][offset::sel_n])

        onetwo = rng.random() < 0.2
        if onetwo and len(chosen) > 2:
            picks = rng.choice(chosen, size=rng.integers(1, 3))
            m12 = np.isin(ring_idx, picks)
            sel_n = min(max_sel_n_hpts_1_2_ring, sel_n)
            pts12 = sph2cart(sph[m12][offset::sel_n])
            return pts12 if len(pts12) >= min_out_pts else out
        return out if len(out) > min_out_pts else pts


class Jitter:
    def __init__(self, params=None, rng=None):
        params = params or {}
        self.clip = params.get("clip", 0.05)
        self.sigma = params.get("sigma", 0.01)
        self.rng = rng or np.random.default_rng()

    def __call__(self, pts):
        noise = np.clip(self.sigma * self.rng.standard_normal(pts.shape),
                        -self.clip, self.clip)
        return pts + noise


class AddGNSpherical:
    """Range-only gaussian noise (keeps the ring structure)."""

    def __init__(self, params=None, rng=None):
        self.bounds = (0.005, 0.03)
        self.rng = rng or np.random.default_rng()

    def __call__(self, pts):
        if self.rng.random() < 0.2:
            return pts
        std = self.rng.uniform(*self.bounds)
        noise = self.rng.normal(0, std, len(pts))
        noise[self.rng.random(len(pts)) < 0.5] = 0.0
        sph = cart2sph(pts)
        sph[:, 0] += noise
        return sph2cart(sph)


class ResamplePoints:
    """Tile + random subsample to exactly n points (data_transforms.py:247)."""

    def __init__(self, params, rng=None):
        self.n = params["n_points"] if isinstance(params, dict) else int(params)
        self.rng = rng or np.random.default_rng()

    def __call__(self, pts):
        if len(pts) == 0:
            return np.zeros((self.n, pts.shape[1] if pts.ndim == 2 else 3),
                            np.float32)
        tiled = np.tile(pts, (int(np.ceil(self.n / len(pts))), 1))
        choice = self.rng.permutation(len(tiled))[:self.n]
        return tiled[choice]


class RandomWorldFlip:
    """gtbox-aware y-flip for object clouds (data_transforms.py)."""

    def __init__(self, params=None, rng=None):
        self.rng = rng or np.random.default_rng()

    needs_kw = True

    def __call__(self, pts, gt_box=None, **kw):
        if self.rng.random() < 0.5:
            pts = pts.copy()
            pts[:, 1] = -pts[:, 1]
            if gt_box is not None:
                gt_box[1] = -gt_box[1]
                gt_box[6] = -gt_box[6]
        return pts


class GlobalRotation:
    needs_kw = True

    def __init__(self, params=None, rng=None):
        params = params or {}
        self.range = params.get("rot_range", [-np.pi / 4, np.pi / 4])
        self.rng = rng or np.random.default_rng()

    def __call__(self, pts, gt_box=None, **kw):
        a = self.rng.uniform(*self.range)
        c, s = np.cos(a), np.sin(a)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
        out = pts @ rot
        if gt_box is not None:
            gt_box[:3] = gt_box[:3] @ rot
            gt_box[6] += a
        return out


class RandomObjectScaling:
    """Per-dimension object scaling in the canonical frame
    (data_transforms.py:287-317): with prob 0.5, rotate partial+complete
    into the gt box frame, scale each axis by U(range), scale the box dims,
    rotate back."""

    def __init__(self, params=None, rng=None):
        self.scale_range = tuple((params or {}).get("scale_range", (0.9, 1.1)))
        self.rng = rng or np.random.default_rng()

    def __call__(self, pts, gt_box=None, complete=None, **kw):
        if gt_box is None or \
                self.scale_range[1] - self.scale_range[0] < 1e-3 or \
                not self.rng.random() < 0.5:
            return pts
        c, ry = gt_box[:3], gt_box[6]
        scale = self.rng.uniform(*self.scale_range, 3).astype(np.float32)

        def to_cn_scale_back(p):
            cn = rotate_points_along_z_np((p[:, :3] - c)[None], np.array([-ry]))[0]
            cn *= scale
            return rotate_points_along_z_np(cn[None], np.array([ry]))[0] + c

        out = pts.copy()
        out[:, :3] = to_cn_scale_back(pts)
        if complete is not None:
            complete[:, :3] = to_cn_scale_back(complete)
        gt_box[3:6] *= scale
        return out


class NormalizeObjectPose:
    """PCN-style pose normalization from 8 bbox corners
    (data_transforms.py:400-424): center on the bbox, rotate by the yaw of
    the corner0->corner3 edge, scale by that edge length, then swap y/z
    into the PCN axis convention."""

    def __init__(self, params=None, rng=None):
        params = params or {}
        keys = params.get("input_keys", {})
        self.ptcloud_key = keys.get("ptcloud", "partial")
        self.bbox_key = keys.get("bbox", "bbox_pts")

    def __call__(self, pts, bbox_pts=None, **kw):
        if bbox_pts is None:
            return pts
        bbox = np.asarray(bbox_pts, np.float64).copy()
        center = (bbox.min(0) + bbox.max(0)) / 2
        bbox -= center
        yaw = np.arctan2(bbox[3, 1] - bbox[0, 1], bbox[3, 0] - bbox[0, 0])
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        bbox = bbox @ rot
        scale = bbox[3, 0] - bbox[0, 0]
        out = pts.copy()
        out[:, :3] = ((pts[:, :3] - center) @ rot) / scale
        out[:, :3] = out[:, :3] @ np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0.0]])
        return out.astype(np.float32)


TRANSFORMS = {
    "LidarSimulation": LidarSimulation,
    "Jitter": Jitter,
    "AddGNSpherical": AddGNSpherical,
    "ResamplePoints": ResamplePoints,
    "RandomWorldFlip": RandomWorldFlip,
    "GlobalRotation": GlobalRotation,
    "RandomObjectScaling": RandomObjectScaling,
    "NormalizeObjectPose": NormalizeObjectPose,
}


def build_transforms(cfg_list, rng=None) -> Compose:
    ts = []
    for c in cfg_list or []:
        name = c["callback"] if isinstance(c, dict) else c
        params = c.get("parameters") if isinstance(c, dict) else None
        ts.append(TRANSFORMS[name](params, rng=rng))
    return Compose(ts)
