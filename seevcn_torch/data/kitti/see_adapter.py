"""KITTI adapter for the SEE preprocessing stage (port of
seevcn_tpu/data/kitti/see_adapter.py).

Reference: see/surface_completion/datasets/kitti/kitti_objects.py:16-213 —
raw .bin clouds + calib txt + per-camera COCO mask JSON + OpenPCDet infos
pkl; provides projection, instance lookup, save paths, and the infos update
that records each frame's completed cloud (``update_infos``,
kitti_objects.py:64-87).
"""
from __future__ import annotations

import copy
import os
import pickle

import numpy as np

from ...geom.calibration import KittiCalibration
from ...see.masks import CocoMasks
from ...utils.native_io import read_bin


class KittiObjects:
    dataset_name = "kitti"

    def __init__(self, cfg):
        """cfg: SEE YAML block (DATA_DIR, INFO_PATHS, MASK_PATHS, TAG,
        CLASSES, SHRINK_MASK_PERCENTAGE, CAMERA_CHANNELS)."""
        self.root = cfg.get("DATA_DIR", ".")
        self.split_dir = os.path.join(self.root, "training")
        self.classes = list(cfg.get("CLASSES", ["Car"]))
        self.camera_channels = list(cfg.get("CAMERA_CHANNELS", ["image_2"]))
        self.shrink_mask_percentage = float(cfg.get("SHRINK_MASK_PERCENTAGE", 0))
        self.tag = cfg.get("TAG", "vcn")

        self.infos = []
        self._info_paths = [p if os.path.isabs(p) else os.path.join(self.root, p)
                            for p in cfg.get("INFO_PATHS", [])]
        for p in self._info_paths:
            if os.path.exists(p):
                with open(p, "rb") as f:
                    self.infos.extend(pickle.load(f))
        self.frames = [i["point_cloud"]["lidar_idx"] for i in self.infos] or \
            sorted(os.path.splitext(f)[0] for f in os.listdir(
                os.path.join(self.split_dir, "velodyne"))
                if f.endswith(".bin")) if os.path.isdir(
                    os.path.join(self.split_dir, "velodyne")) else []

        self.masks = {}
        for cam, path in cfg.get("MASK_PATHS", {}).items():
            full = path if os.path.isabs(path) else os.path.join(self.root, path)
            if os.path.exists(full):
                self.masks[cam] = CocoMasks(full)

    def __len__(self):
        return len(self.frames)

    # ------------------------------------------------------------------ #
    def get_infos(self, idx):
        return self.infos[idx] if self.infos else None

    def get_pointcloud(self, idx) -> np.ndarray:
        path = os.path.join(self.split_dir, "velodyne", f"{self.frames[idx]}.bin")
        return read_bin(path)[:, :3].astype(np.float32)

    def get_calibration(self, idx) -> KittiCalibration:
        return KittiCalibration(os.path.join(self.split_dir, "calib",
                                             f"{self.frames[idx]}.txt"))

    def get_image_shape(self, idx, channel="image_2"):
        info = self.get_infos(idx)
        if info and "image" in info:
            return tuple(int(v) for v in info["image"]["image_shape"])
        return (375, 1242)

    def get_gt_boxes(self, idx) -> np.ndarray:
        info = self.get_infos(idx)
        if not info or "annos" not in info:
            return np.zeros((0, 7), np.float32)
        annos = info["annos"]
        keep = np.isin(annos["name"], self.classes)
        if "gt_boxes_lidar" in annos:
            return np.asarray(annos["gt_boxes_lidar"], np.float32)[keep]
        return np.zeros((0, 7), np.float32)

    def map_pointcloud_to_image(self, idx, camera_channel="image_2",
                                min_dist: float = 1.0) -> dict:
        pc = self.get_pointcloud(idx)
        calib = self.get_calibration(idx)
        h, w = self.get_image_shape(idx, camera_channel)
        uv, depth = calib.lidar_to_img(pc[:, :3])
        fov = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & \
            (uv[:, 1] < h) & (pc[:, 0] > min_dist)
        return {"pc_lidar": pc[fov], "pc_cam": calib.lidar_to_rect(pc[fov, :3]),
                "pts_img": np.floor(uv[fov]).astype(np.int64),
                "fov_inds": fov, "img_shape": (h, w)}

    def get_camera_instances(self, idx, channel="image_2"):
        coco = self.masks.get(channel)
        if coco is None:
            return []
        fname = f"{self.frames[idx]}.png"
        img = coco.file_to_img.get(fname) or coco.file_to_img.get(
            f"{self.frames[idx]}.jpg")
        if img is None:
            return []
        return coco.load_anns(coco.get_ann_ids(img["id"]))

    def get_save_fname(self, idx) -> str:
        return os.path.join(self.split_dir, f"vcn_{self.tag}", self.frames[idx])

    def update_infos(self, out_dir: str | None = None):
        """Write infos_<tag> pkls with completed_lidar_path per frame
        (kitti_objects.py:64-87) so SCKittiDataset picks them up."""
        out_dir = out_dir or os.path.join(self.root, f"infos_{self.tag}")
        os.makedirs(out_dir, exist_ok=True)
        new_infos = []
        for info in self.infos:
            info = copy.deepcopy(info)
            idx = info["point_cloud"]["lidar_idx"]
            info["completed_lidar_path"] = os.path.join(f"vcn_{self.tag}",
                                                        f"{idx}.pcd")
            new_infos.append(info)
        path = os.path.join(out_dir, "kitti_infos_val.pkl")
        with open(path, "wb") as f:
            pickle.dump(new_infos, f)
        return path
