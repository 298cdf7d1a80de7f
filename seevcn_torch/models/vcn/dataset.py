"""VCN training datasets (the port's copy of seevcn_tpu/models/vcn/dataset.py:
the same seed and directory give bit-equal batches).

Reference: see/.../models/vcn/datasets/VCDataset.py (VC-ShapeNet
partial/complete pairs + label pkl per model/view) and KITTIDataset.py (real
isolated-object test set). Directory layout consumed verbatim:

  root/<model_id>/partial/<view>.pcd     (or .npy)
  root/<model_id>/complete.pcd
  root/<model_id>/labels.pkl             {'gtbox': (7,), ...} per view

Fixed-batch collation replaces the reference's variable collate: every
sample resamples input to n_points and complete to n_complete.
"""
from __future__ import annotations

import glob
import os
import pickle

import numpy as np

from ...geom.pcd_io import read_pcd
from .transforms import ResamplePoints, build_transforms


def _load_points(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)[:, :3]
    return read_pcd(path)


class VCDataset:
    """Synthetic viewer-centred ShapeNet pairs (VCDataset.py:19-150)."""

    def __init__(self, root: str, transforms_cfg=None, n_points: int = 1024,
                 n_complete: int = 2048, rng=None):
        self.root = root
        self.rng = rng or np.random.default_rng(0)
        self.n_points = n_points
        self.n_complete = n_complete
        self.transforms = build_transforms(transforms_cfg, rng=self.rng)
        self.resample_in = ResamplePoints(n_points, rng=self.rng)
        self.resample_gt = ResamplePoints(n_complete, rng=self.rng)

        self.samples = []
        for model_dir in sorted(glob.glob(os.path.join(root, "*"))):
            if not os.path.isdir(model_dir):
                continue
            complete = None
            for ext in (".pcd", ".npy"):
                c = os.path.join(model_dir, "complete" + ext)
                if os.path.exists(c):
                    complete = c
            labels_path = os.path.join(model_dir, "labels.pkl")
            labels = {}
            if os.path.exists(labels_path):
                with open(labels_path, "rb") as f:
                    labels = pickle.load(f)
            for view in sorted(glob.glob(os.path.join(model_dir, "partial", "*"))):
                key = os.path.splitext(os.path.basename(view))[0]
                lab = labels.get(key)
                if lab is None and key.isdigit():
                    lab = labels.get(int(key))
                gtbox = np.asarray(lab.get("gtbox", np.zeros(7)), np.float32) \
                    if isinstance(lab, dict) else np.zeros(7, np.float32)
                # prefer the per-view VIEW-FRAME surface (the reference's
                # surface/%s/%03d.pcd layout, VCDataset.py:28): the loss
                # chamfers view-frame predictions against 'complete', so
                # a shared canonical complete would train completions
                # toward the origin
                vc = None
                for ext in (".pcd", ".npy"):
                    c = os.path.join(model_dir, "surface", key + ext)
                    if os.path.exists(c):
                        vc = c
                self.samples.append({"partial": view,
                                     "complete": vc or complete,
                                     "gtbox": gtbox})

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        s = self.samples[i]
        partial = _load_points(s["partial"])
        gt_box = s["gtbox"].copy()
        partial = self.transforms(partial, gt_box=gt_box)
        inp = self.resample_in(partial).astype(np.float32)
        complete = self.resample_gt(_load_points(s["complete"])).astype(np.float32) \
            if s["complete"] else np.zeros((self.n_complete, 3), np.float32)
        return {"input": inp, "complete": complete, "gt_boxes": gt_box,
                "num_pts": np.int32(len(partial))}

    def batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = True):
        order = self.rng.permutation(len(self)) if shuffle else np.arange(len(self))
        for s in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size and drop_last:
                break
            items = [self[i] for i in idx]
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class KittiObjectsDataset(VCDataset):
    """Real isolated-object test set (KITTIDataset.py): same layout but no
    complete surface; used for the qualitative real-lidar test in the
    runner (runner.py:343-549)."""

    def __getitem__(self, i):
        s = self.samples[i]
        partial = _load_points(s["partial"])
        inp = self.resample_in(partial).astype(np.float32)
        return {"input": inp, "gt_boxes": s["gtbox"],
                "num_pts": np.int32(len(partial))}
