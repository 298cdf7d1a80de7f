"""The dataset template: host-side frames of fixed shape, augmented on the
device (port of seevcn_tpu/data/dataset.py; reference datasets/dataset.py:
103-257 and processor/{point_feature_encoder,data_processor}.py).

``prepare_frame`` is numpy, with the JAX package's ``default_rng`` draws,
so that a frame equals JAX's bit for bit: the GT-database paste, the
feature selection, the range mask, the shuffle, the fixed-capacity pad or
subsample, the class filter and (in training) the min-points filter,
counted by the port's ``points_in_boxes_count``. ``augment_on_device``
runs the augmentations on a batch of tensors where they lie, one
generator a frame. No voxelisation: each model voxelises its own input.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geom.boxes import points_in_boxes_count
from .augmentor import GTDatabaseSampler, apply_augmentations, aug_list_from_cfg, draw_params


class PointFeatureEncoder:
    """absolute_coordinates_encoding (processor/point_feature_encoder.py):
    the used features' columns of the source's, x y z first."""

    def __init__(self, cfg):
        self.used = list(cfg.used_feature_list)
        self.src = list(cfg.get("src_feature_list", self.used))
        assert self.used[:3] == ["x", "y", "z"]

    @property
    def num_point_features(self):
        return len(self.used)

    def __call__(self, points: np.ndarray) -> np.ndarray:
        return points[:, [self.src.index(f) for f in self.used]]


def mask_points_outside_range(points: np.ndarray, pcr) -> np.ndarray:
    """The points whose x and y lie in the range (bounds included)."""
    m = ((points[:, 0] >= pcr[0]) & (points[:, 0] <= pcr[3])
         & (points[:, 1] >= pcr[1]) & (points[:, 1] <= pcr[4]))
    return points[m]


class DatasetTemplate:
    """Common preparation and collation; a dataset implements ``__len__``
    and ``__getitem__`` over its infos, and ``get_lidar``."""

    def __init__(self, dataset_cfg, class_names, training: bool,
                 root_path: str | None = None, max_points: int = 150000,
                 max_boxes: int = 64):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.root_path = root_path or dataset_cfg.get("DATA_PATH", ".")
        self.point_cloud_range = np.asarray(dataset_cfg.POINT_CLOUD_RANGE, np.float32)
        self.max_points = max_points
        self.max_boxes = max_boxes
        self._epoch = 0
        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg.POINT_FEATURE_ENCODING) \
            if dataset_cfg.get("POINT_FEATURE_ENCODING") else None

        aug_cfg = dataset_cfg.get("DATA_AUGMENTOR", None)
        self.aug_list = aug_list_from_cfg(aug_cfg) if (training and aug_cfg) else ()
        self.gt_sampler = None
        if training and aug_cfg:
            for a in aug_cfg.get("AUG_CONFIG_LIST", []):
                if a["NAME"] == "gt_sampling" and \
                        "gt_sampling" not in aug_cfg.get("DISABLE_AUG_LIST", []):
                    try:
                        self.gt_sampler = GTDatabaseSampler(self.root_path, a,
                                                            self.class_names)
                    except FileNotFoundError:
                        self.gt_sampler = None
        self._shuffle = True
        for p in dataset_cfg.get("DATA_PROCESSOR", []):
            if p.NAME == "shuffle_points":
                se = p.get("SHUFFLE_ENABLED", {"train": True, "test": False})
                self._shuffle = bool(se["train"] if training else se["test"])
            elif p.NAME == "sample_points":
                # data_processor.py sample_points: the frame's point budget,
                # which the fixed-capacity pad or subsample realises
                n = p.get("NUM_POINTS", None)
                if isinstance(n, dict):
                    n = n["train"] if training else n["test"]
                if n:
                    self.max_points = min(self.max_points, int(n))
            # transform_points_to_voxels(_placeholder) and the CaDDN
            # processors are the models' own; the range mask is below
        self.min_points_of_gt = int(dataset_cfg.get("MIN_POINTS_OF_GT", 0) or 0)
        self.shift_coor = dataset_cfg.get("SHIFT_COOR", None)

    def set_epoch(self, epoch: int):
        """The epoch the train loop is in (fresh draws each epoch, eval
        reproducible)."""
        self._epoch = int(epoch)

    def prepare_frame(self, points: np.ndarray, gt_boxes=None, gt_names=None,
                      rng_seed: int = 0) -> dict:
        """points (N, C) and the ground truth -> the fixed-shape frame
        (numpy): points (max_points, C'), points_valid, and given boxes
        gt_boxes (max_boxes, 8) (x y z dx dy dz heading, class index from
        1; zero rows pad) and gt_mask."""
        if self.shift_coor is not None:
            points = points.copy()
            points[:, :3] += np.asarray(self.shift_coor, points.dtype)
            if gt_boxes is not None and len(gt_boxes):
                gt_boxes = gt_boxes.copy()
                gt_boxes[:, :3] += np.asarray(self.shift_coor, gt_boxes.dtype)

        if self.training and self.gt_sampler is not None and gt_boxes is not None:
            points, gt_boxes, gt_names = self.gt_sampler(points, gt_boxes, gt_names)

        if self.point_feature_encoder is not None:
            points = self.point_feature_encoder(points)
        points = mask_points_outside_range(points, self.point_cloud_range)

        rng = np.random.default_rng(rng_seed)
        if self._shuffle:
            points = points[rng.permutation(len(points))]

        p = np.zeros((self.max_points, points.shape[1]), np.float32)
        n = min(len(points), self.max_points)
        if len(points) > self.max_points:
            p[:] = points[rng.choice(len(points), self.max_points, replace=False)]
        else:
            p[:n] = points[:n]
        out = {"points": p, "points_valid": np.arange(self.max_points) < n}

        if gt_boxes is not None:
            gt_names = np.asarray(gt_names)
            keep = np.isin(gt_names, self.class_names)
            boxes = np.asarray(gt_boxes, np.float32)[keep]
            names = gt_names[keep]
            if self.training and self.min_points_of_gt and len(boxes):
                # the gts with too few points go (dataset.py:129-137)
                cnt = points_in_boxes_count(torch.as_tensor(points[:, :3], dtype=torch.float32),
                                            torch.as_tensor(boxes[:, :7])).numpy()
                boxes = boxes[cnt >= self.min_points_of_gt]
                names = names[cnt >= self.min_points_of_gt]
            cls_ids = np.array([self.class_names.index(nm) + 1 for nm in names],
                               np.float32).reshape(-1, 1)
            gb = np.zeros((self.max_boxes, 8), np.float32)
            m = min(len(boxes), self.max_boxes)
            if m:
                gb[:m, :7] = boxes[:m, :7]
                gb[:m, 7:] = cls_ids[:m]
            out["gt_boxes"] = gb
            out["gt_mask"] = np.arange(self.max_boxes) < m
        return out

    def augment_on_device(self, batch: dict, generators=None, draws=None) -> dict:
        """The augmentations of the config on a batch dict of tensors
        (points (B, P, C), points_valid, gt_boxes (B, M, 8), gt_mask), on
        their device, frame by frame: frame b draws from ``generators[b]``
        (a torch.Generator of that device), or takes ``draws[b]``
        (``augmentor.draw_params``' list). The ground truth that an
        augmentation masks out becomes a zero row. -> a new dict."""
        if not self.aug_list:
            return batch
        pts, pvalid, gbs, gmask = [], [], [], []
        for b in range(batch["points"].shape[0]):
            p, v, g, m = (batch[k][b] for k in ("points", "points_valid", "gt_boxes",
                                                 "gt_mask"))
            d = draws[b] if draws is not None else draw_params(
                self.aug_list, p.shape[0], g.shape[0], generators[b], p.device)
            p, v, g7, m = apply_augmentations(p, v, g[:, :7], m, self.aug_list, d)
            pts.append(p)
            pvalid.append(v)
            gbs.append(torch.where(m[:, None], torch.cat([g7, g[:, 7:]], dim=1), 0.0))
            gmask.append(m)
        return {**batch, "points": torch.stack(pts), "points_valid": torch.stack(pvalid),
                "gt_boxes": torch.stack(gbs), "gt_mask": torch.stack(gmask)}

    @staticmethod
    def collate(frames: list) -> dict:
        return {k: np.stack([f[k] for f in frames]) for k in frames[0]}
