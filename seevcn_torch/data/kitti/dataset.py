"""KITTI and its SEE-completed variant (port of
seevcn_tpu/data/kitti/dataset.py; reference kitti_dataset.py and
sc_kitti_dataset.py:20-88).

``KittiDataset`` reads OpenPCDet's ``kitti_infos_*.pkl`` as they are: the
``.bin`` clouds, the calibration (from the infos or ``calib/*.txt``), the
ground truth in the lidar frame; with FOV_POINTS_ONLY only the points that
project onto the image in front of the camera; and CaDDN's camera items of
GET_ITEM_LIST: ``images`` (RGB in [0, 1]) and ``depth_maps`` (metres, the
16-bit PNG over 256), padded bottom-right with zeros to IMAGE_PAD_SHAPE
(384 x 1280 by default), ``calib_matricies`` (``trans_lidar_to_cam``, R0
Tr_velo_to_cam as 4 x 4, and ``trans_cam_to_img``, P2), and ``gt_boxes2d``,
which the JAX package does not give: the annotations' image boxes of the
kept classes, zero rows padding to ``max_boxes``. The PNGs are read by
``data/png.py`` (the JAX package reads them with cv2).

``generate_prediction_dicts`` turns lidar boxes into KITTI's camera-frame
annotations (with TEST.BOX_FILTER's FOV filter and LIMIT_RANGE) and can
write them as KITTI label files; ``evaluation`` runs the official AP
(``eval.py``). ``SCKittiDataset`` reads each frame's SEE-completed cloud
(the infos' ``completed_lidar_path``, else PROCESSED_DATA_TAG/<idx>.pcd).
"""
from __future__ import annotations

import copy
import os
import pickle

import numpy as np
import torch

from ...geom import boxes as box_utils
from ...geom.calibration import KittiCalibration
from ...geom.pcd_io import read_pcd
from ..dataset import DatasetTemplate
from ..png import read_png
from .eval import get_official_eval_result


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training: bool, root_path=None, **kw):
        super().__init__(dataset_cfg, class_names, training, root_path, **kw)
        split_key = "train" if training else "test"
        self.split = dataset_cfg.get("DATA_SPLIT", {}).get(split_key, "val")
        self.root_split_path = os.path.join(
            self.root_path, "training" if self.split != "test" else "testing")
        self.infos = []
        for p in dataset_cfg.get("INFO_PATH", {}).get(split_key, []):
            full = p if os.path.isabs(p) else os.path.join(self.root_path, p)
            if os.path.exists(full):
                with open(full, "rb") as f:
                    self.infos.extend(pickle.load(f))

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, info) -> np.ndarray:
        idx = info["point_cloud"]["lidar_idx"]
        path = os.path.join(self.root_split_path, "velodyne", f"{idx}.bin")
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    def get_calib(self, info) -> KittiCalibration:
        if "calib" in info:
            c = info["calib"]
            return KittiCalibration({"P2": np.asarray(c["P2"])[:3, :4],
                                     "R0": np.asarray(c["R0_rect"])[:3, :3],
                                     "Tr_velo2cam": np.asarray(c["Tr_velo_to_cam"])[:3, :4]})
        idx = info["point_cloud"]["lidar_idx"]
        return KittiCalibration(os.path.join(self.root_split_path, "calib", f"{idx}.txt"))

    def get_gt(self, info):
        """-> (lidar boxes (N, 7), names) of the annotations but DontCare, or
        (None, None) without annotations."""
        if "annos" not in info:
            return None, None
        annos = info["annos"]
        mask = annos["name"] != "DontCare"
        if "gt_boxes_lidar" in annos:
            return annos["gt_boxes_lidar"], annos["name"][mask]
        loc, dims, rots = (annos["location"][mask], annos["dimensions"][mask],
                           annos["rotation_y"][mask])
        cam = np.concatenate([loc, dims, rots[:, None]], axis=1)
        return box_utils.boxes3d_kitti_camera_to_lidar(cam, self.get_calib(info)), \
            annos["name"][mask]

    # the camera items (kitti_dataset.py:68-99, 411-462) -------------------
    def get_image(self, idx) -> np.ndarray:
        """RGB in [0, 1], f32 (H, W, 3)."""
        img = read_png(os.path.join(self.root_split_path, "image_2", f"{idx}.png"))
        return img[:, :, :3].astype(np.float32) / 255.0

    def get_depth_map(self, idx) -> np.ndarray:
        """Depth in metres, the 16-bit PNG's value over 256, f32 (H, W)."""
        d = read_png(os.path.join(self.root_split_path, "depth_2", f"{idx}.png"))
        return d.astype(np.float32) / 256.0

    @staticmethod
    def _pad_hw(arr, shape):
        """Bottom / right zero pad (or crop) to a static (H, W[, C])."""
        h, w = shape
        out = np.zeros((h, w) + arr.shape[2:], arr.dtype)
        ch, cw = min(h, arr.shape[0]), min(w, arr.shape[1])
        out[:ch, :cw] = arr[:ch, :cw]
        return out

    def gt_boxes2d(self, info) -> np.ndarray:
        """(max_boxes, 4) image boxes of the annotations of the dataset's
        classes, zero rows padding."""
        out = np.zeros((self.max_boxes, 4), np.float32)
        annos = info.get("annos")
        if annos is not None:
            keep = np.isin(annos["name"], self.class_names)
            boxes = np.asarray(annos["bbox"], np.float32).reshape(-1, 4)[keep]
            m = min(len(boxes), self.max_boxes)
            out[:m] = boxes[:m]
        return out

    def __getitem__(self, index):
        info = self.infos[index]
        points = self.get_lidar(info)
        calib = None
        if self.dataset_cfg.get("FOV_POINTS_ONLY", False):
            calib = self.get_calib(info)
            img_shape = np.asarray(info.get("image", {}).get("image_shape", (375, 1242)))
            uv, depth = calib.lidar_to_img(points[:, :3])
            points = points[(uv[:, 0] >= 0) & (uv[:, 0] < img_shape[1]) & (uv[:, 1] >= 0)
                            & (uv[:, 1] < img_shape[0]) & (depth > 0)]
        boxes, names = self.get_gt(info)
        out = self.prepare_frame(points, boxes, names, rng_seed=index)
        out["frame_id"] = info["point_cloud"]["lidar_idx"]

        items = list(self.dataset_cfg.get("GET_ITEM_LIST", ["points"]))
        idx = info["point_cloud"]["lidar_idx"]
        pad = tuple(self.dataset_cfg.get("IMAGE_PAD_SHAPE", (384, 1280)))
        if "images" in items:
            out["images"] = self._pad_hw(self.get_image(idx), pad)
        if "depth_maps" in items:
            out["depth_maps"] = self._pad_hw(self.get_depth_map(idx), pad)
        if "calib_matricies" in items:
            calib = calib or self.get_calib(info)
            v2c = np.eye(4, dtype=np.float32)
            v2c[:3, :4] = calib.V2C
            r0 = np.eye(4, dtype=np.float32)
            r0[:3, :3] = calib.R0
            out["trans_lidar_to_cam"] = (r0 @ v2c).astype(np.float32)
            out["trans_cam_to_img"] = calib.P2.astype(np.float32)
        if "gt_boxes2d" in items:
            out["gt_boxes2d"] = self.gt_boxes2d(info)
        return out

    def generate_prediction_dicts(self, frame_indices, pred_dicts, class_names,
                                  output_path=None, device="cuda"):
        """pred_dicts: a dict a frame with numpy 'pred_boxes' (N, 7),
        'pred_scores' (N,) and 'pred_labels' (N,), the kept boxes only ->
        KITTI annotations a frame (kitti_dataset.py:277-364); written as
        label files under ``output_path`` if given. LIMIT_RANGE's corner
        test runs on ``device``."""
        annos = []
        for fi, box_dict in zip(frame_indices, pred_dicts):
            info = self.infos[fi]
            calib = self.get_calib(info)
            image_shape = info.get("image", {}).get("image_shape", (375, 1242))
            boxes = np.asarray(box_dict["pred_boxes"], np.float64)
            scores = np.asarray(box_dict["pred_scores"], np.float64)
            labels = np.asarray(box_dict["pred_labels"], np.int64)
            if self.shift_coor is not None:
                boxes = boxes.copy()
                boxes[:, :3] -= np.asarray(self.shift_coor)

            test_cfg = self.dataset_cfg.get("TEST", None)
            if test_cfg and test_cfg.get("BOX_FILTER", {}).get("FOV_FILTER"):
                uv, depth = calib.rect_to_img(calib.lidar_to_rect(boxes[:, :3]))
                m = 5
                fov = ((uv[:, 0] >= -m) & (uv[:, 0] < image_shape[1] + m)
                       & (uv[:, 1] >= -m) & (uv[:, 1] < image_shape[0] + m) & (depth > 0))
                lim = test_cfg["BOX_FILTER"].get("LIMIT_RANGE")
                if lim is not None:
                    fov &= box_utils.mask_boxes_outside_range(
                        torch.as_tensor(boxes[:, :7], dtype=torch.float32,
                                        device=device), lim).cpu().numpy()
                boxes, scores, labels = boxes[fov], scores[fov], labels[fov]

            n = len(boxes)
            pred = {"name": np.array(["Car"] * 0) if n == 0 else
                    np.array(class_names)[labels - 1],
                    "truncated": np.zeros(n), "occluded": np.zeros(n),
                    "score": scores, "boxes_lidar": boxes,
                    "frame_id": info["point_cloud"]["lidar_idx"]}
            if n:
                cam = box_utils.boxes3d_lidar_to_kitti_camera(boxes, calib)
                pred["alpha"] = -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6]
                pred["bbox"] = box_utils.boxes3d_kitti_camera_to_imageboxes(
                    cam, calib, image_shape=image_shape)
                pred["dimensions"] = cam[:, 3:6]
                pred["location"] = cam[:, 0:3]
                pred["rotation_y"] = cam[:, 6]
            else:
                pred.update({"alpha": np.zeros(0), "bbox": np.zeros((0, 4)),
                             "dimensions": np.zeros((0, 3)), "location": np.zeros((0, 3)),
                             "rotation_y": np.zeros(0)})
            annos.append(pred)
            if output_path is not None:
                self._write_kitti_txt(pred, output_path)
        return annos

    @staticmethod
    def _write_kitti_txt(pred, output_path):
        os.makedirs(output_path, exist_ok=True)
        with open(os.path.join(output_path, f"{pred['frame_id']}.txt"), "w") as f:
            for i in range(len(pred["bbox"])):
                b, d, loc = pred["bbox"][i], pred["dimensions"][i], pred["location"][i]
                f.write("%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                        "%.4f %.4f %.4f %.4f %.4f\n"
                        % (pred["name"][i], pred["alpha"][i], b[0], b[1], b[2], b[3],
                           d[1], d[2], d[0], loc[0], loc[1], loc[2],
                           pred["rotation_y"][i], pred["score"][i]))

    def evaluation(self, det_annos, class_names, device="cuda", **kw):
        """-> (report, {class: {metric: {difficulty: AP_R40}}}) against the
        annotations of the frames predicted (each prediction's frame_id; with
        MIN_POINTS_OF_GT, the gts with fewer points dropped), or (None, {})
        without annotations. The JAX package scores every info's annotations,
        so it fails when fewer frames were predicted (``--max_frames``)."""
        if not self.infos or "annos" not in self.infos[0]:
            return None, {}
        by_id = {info["point_cloud"]["lidar_idx"]: info for info in self.infos}
        infos = [by_id[d["frame_id"]] for d in det_annos]
        gt_annos = [copy.deepcopy(info["annos"]) for info in infos]
        if self.min_points_of_gt:
            for annos in gt_annos:
                keep = annos.get("num_points_in_gt",
                                 np.full(len(annos["name"]), 1 << 30)) >= self.min_points_of_gt
                for key in list(annos.keys()):
                    v = annos[key]
                    if isinstance(v, np.ndarray) and len(v) == len(keep):
                        annos[key] = v[keep]
        return get_official_eval_result(gt_annos, det_annos, classes=tuple(class_names),
                                        device=device)


class SCKittiDataset(KittiDataset):
    """KITTI with SEE-completed clouds (sc_kitti_dataset.py:20-33): a frame's
    points are the completed ``.pcd`` the infos name."""

    def get_lidar(self, info) -> np.ndarray:
        rel = info.get("completed_lidar_path")
        if rel is None:
            tag = self.dataset_cfg.get("PROCESSED_DATA_TAG", "vcn")
            rel = os.path.join(tag, f"{info['point_cloud']['lidar_idx']}.pcd")
        return read_pcd(rel if os.path.isabs(rel) else os.path.join(self.root_split_path, rel))


DATASETS = {"KittiDataset": KittiDataset, "SCKittiDataset": SCKittiDataset}
