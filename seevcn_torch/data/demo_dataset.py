"""The demo's SEE adapter: a pcd, a JSON calibration and COCO masks a
camera (port of seevcn_tpu/data/demo_dataset.py; reference
demo/see_vcn_dataset.py:13-136 and the Baraja custom adapter).

The tree:
  root/pcd/<frame>.pcd, root/calib/<frame>.json,
  root/image/<cam>/<frame>.jpg, and a COCO JSON of masks a camera.
An image's size comes from its JPEG (or PNG) header, not from a decode.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..geom.calibration import JsonCalibration
from ..geom.pcd_io import read_pcd
from ..see.masks import CocoMasks
from .kitti.bootstrap import read_image_shape


class DemoObjects:
    dataset_name = "demo"

    def __init__(self, root: str, camera_channels=("front",), masks=None,
                 image_shape=(720, 1260), shrink_mask_percentage=0,
                 classes=("Car",)):
        self.root = root
        self.camera_channels = list(camera_channels)
        self.shrink_mask_percentage = shrink_mask_percentage
        self.classes = list(classes)
        self.frames = sorted(
            os.path.splitext(os.path.basename(p))[0]
            for p in glob.glob(os.path.join(root, "pcd", "*.pcd")))
        self.image_shape = image_shape
        # masks: {camera: CocoMasks or a path}; a frame's image by file name
        self.masks = {c: (m if isinstance(m, CocoMasks) else CocoMasks(m))
                      for c, m in (masks or {}).items()}

    def __len__(self):
        return len(self.frames)

    def get_pointcloud(self, idx) -> np.ndarray:
        return read_pcd(os.path.join(self.root, "pcd", f"{self.frames[idx]}.pcd"))

    def get_calibration(self, idx) -> JsonCalibration:
        return JsonCalibration(os.path.join(self.root, "calib", f"{self.frames[idx]}.json"))

    def get_image_shape(self, idx, channel="front"):
        """(H, W) of the frame's image, or the default shape without one."""
        path = os.path.join(self.root, "image", channel, f"{self.frames[idx]}.jpg")
        if os.path.exists(path):
            return tuple(int(v) for v in read_image_shape(path))
        return self.image_shape

    def map_pointcloud_to_image(self, idx, camera_channel="front", min_dist=1.0):
        pc = self.get_pointcloud(idx)
        calib = self.get_calibration(idx)
        h, w = self.get_image_shape(idx, camera_channel)
        uv, depth = calib.lidar_to_img(pc[:, :3])
        fov = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h) \
            & (depth > min_dist)
        return {"pc_lidar": pc[fov], "pc_cam": calib.lidar_to_cam(pc[fov]),
                "pts_img": np.floor(uv[fov]).astype(np.int64),
                "fov_inds": fov, "img_shape": (h, w)}

    def get_camera_instances(self, idx, channel="front"):
        coco = self.masks[channel]
        fname = f"{self.frames[idx]}.jpg"
        img = coco.file_to_img.get(fname) or coco.file_to_img.get(os.path.join(channel, fname))
        if img is None:
            return []
        return coco.load_anns(coco.get_ann_ids(img["id"]))

    def get_save_fname(self, idx, tag="vcn_demo"):
        return os.path.join(self.root, tag, self.frames[idx])
