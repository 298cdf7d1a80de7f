"""SEE-stage dataset adapters: nuScenes (multi-camera, multi-sweep), Waymo
(precomputed projections), Custom/Baraja (json calib with pinhole/fisheye
distortion) (port of seevcn_tpu/data/see_adapters.py, host numpy: the
nuScenes transforms chain in f64 and the clouds are cast to f32 at the end).

Reference: see/surface_completion/datasets/nuscenes/nuscenes_objects.py
(SDK chain :237-297, 2-sweep aggregation, 6 cameras),
waymo/waymo_objects.py (precomputed image_lidar_projections :170-186),
custom_dataset/custom_dataset_objects.py (:141-194 distortion projection).
All three present the KittiObjects interface the SEE pipeline drives
(see/pipeline.py): frames, camera_channels, masks, get_pointcloud,
map_pointcloud_to_image, get_camera_instances, get_save_fname,
update_infos. The nuScenes adapter runs devkit-free on the raw JSON tables
(data/nuscenes_bootstrap.NuScenesTables) instead of the nuscenes SDK.
"""
from __future__ import annotations

import copy
import glob
import os
import pickle

import numpy as np

from ..geom.calibration import JsonCalibration
from ..geom.pcd_io import read_pcd
from ..see.masks import CocoMasks
from .nuscenes_bootstrap import NuScenesTables, quat_to_rotmat

# reference class-id conventions in the mask JSONs
NUSCENES_CLASS2IDX = {"pedestrian": 0, "car": 2, "truck": 7}
WAYMO_CLASS2IDX = {"Pedestrian": 0, "Car": 2}
NUSCENES_CAMERAS = ["CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
                    "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT"]
WAYMO_CAMERAS = ["FRONT", "FRONT_LEFT", "FRONT_RIGHT", "SIDE_LEFT",
                 "SIDE_RIGHT"]


def _load_masks(mask_dir, camera_channels):
    masks = {}
    for ch in camera_channels:
        p = os.path.join(mask_dir, f"{ch}.json")
        if os.path.exists(p):
            masks[ch] = CocoMasks(p)
    return masks


def _filter_instances(coco: CocoMasks, img_id, classes, class2idx):
    """Instances of an image filtered by class ids, largest-area first
    (reference get_camera_instances)."""
    cat_ids = {class2idx[c] for c in classes if c in class2idx}
    anns = [a for a in coco.load_anns(coco.get_ann_ids(img_id))
            if not cat_ids or a.get("category_id") in cat_ids]
    return sorted(anns, key=lambda a: a.get("area", 0), reverse=True)


# ---------------------------------------------------------------------------
# nuScenes
# ---------------------------------------------------------------------------

class NuscenesObjects:
    """nuScenes SEE adapter on the raw tables (nuscenes_objects.py:21-297).

    cfg keys: DATA_DIR, VERSION, SPLIT/SCENE_NAMES, LIDAR_NSWEEPS, CLASSES,
    CAMERA_CHANNELS, MASK_DIR (masks/<model>), SHRINK_MASK_PERCENTAGE, TAG,
    INFO_PATHS {train/val -> pkl} (bootstrap- or reference-generated).
    """

    dataset_name = "nuscenes"

    def __init__(self, cfg):
        self.root = cfg.get("DATA_DIR", ".")
        version = cfg.get("VERSION", None)
        if version is None:
            base = os.path.basename(os.path.normpath(self.root))
            version = base if base.startswith("v1.0") else "v1.0-trainval"
        self.nusc = NuScenesTables(self.root, version)
        self.classes = list(cfg.get("CLASSES", ["car"]))
        self.nsweeps = int(cfg.get("LIDAR_NSWEEPS", 2))
        self.camera_channels = list(cfg.get("CAMERA_CHANNELS",
                                            NUSCENES_CAMERAS))
        self.shrink_mask_percentage = float(
            cfg.get("SHRINK_MASK_PERCENTAGE", 0))
        self.tag = cfg.get("TAG", "vcn")
        self.split = cfg.get("SPLIT", "train")
        self.save_dir = os.path.join(self.root, "samples", f"vcn_{self.tag}")

        # sample records of the selected scenes, in scene order
        # (nuscenes_objects.get_sample_records; CUSTOM_SCENES -> SCENE_NAMES)
        scene_names = cfg.get("SCENE_NAMES", None)
        scenes = [s for s in self.nusc.scene
                  if scene_names is None or s["name"] in scene_names]
        self.sample_records = []
        by_token = {s["token"]: s for s in self.nusc.sample}
        for scene in scenes:
            tok = scene["first_sample_token"]
            while tok:
                s = by_token[tok]
                self.sample_records.append(s)
                tok = s.get("next", "")
        self.frames = [s["token"] for s in self.sample_records]

        self.infos = {}
        for split, p in cfg.get("INFO_PATHS", {}).items():
            full = p if os.path.isabs(p) else os.path.join(self.root, p)
            if os.path.exists(full):
                with open(full, "rb") as f:
                    self.infos[split] = pickle.load(f)
        self._token_to_info = {i["token"]: (split, k)
                               for split, infos in self.infos.items()
                               for k, i in enumerate(infos)}

        self.masks = _load_masks(
            cfg.get("MASK_DIR", os.path.join(self.root, "masks")),
            self.camera_channels)

    def __len__(self):
        return len(self.sample_records)

    def get_infos(self, idx):
        loc = self._token_to_info.get(self.sample_records[idx]["token"])
        return self.infos[loc[0]][loc[1]] if loc else None

    def get_gt_boxes(self, idx) -> np.ndarray:
        """The infos' boxes of CLASSES (N, 7) in the lidar frame, which the
        GT path crops by. The JAX adapter has none, so its run_see --path
        gt raises AttributeError on nuScenes."""
        info = self.get_infos(idx)
        if not info or "gt_boxes" not in info:
            return np.zeros((0, 7), np.float32)
        keep = np.isin(info["gt_names"], self.classes)
        return np.asarray(info["gt_boxes"], np.float32)[keep][:, :7]

    # -- point cloud (multi-sweep aggregation, LidarPointCloud.from_file_
    #    multisweep equivalent on raw tables) ------------------------------
    def _read_bin(self, filename):
        return np.fromfile(os.path.join(self.root, filename),
                           dtype=np.float32).reshape(-1, 5)[:, :3]

    def _sd_to_global(self, sd):
        """4x4 sensor->global for a sample_data record."""
        cs = self.nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = self.nusc.get("ego_pose", sd["ego_pose_token"])
        car_from_sensor = np.eye(4)
        car_from_sensor[:3, :3] = quat_to_rotmat(cs["rotation"])
        car_from_sensor[:3, 3] = cs["translation"]
        global_from_car = np.eye(4)
        global_from_car[:3, :3] = quat_to_rotmat(pose["rotation"])
        global_from_car[:3, 3] = pose["translation"]
        return global_from_car @ car_from_sensor

    def get_pointcloud(self, idx, nsweeps: int = 0) -> np.ndarray:
        nsweeps = nsweeps or self.nsweeps
        ref_sd = self.nusc.channels_of(self.frames[idx])["LIDAR_TOP"]
        ref_from_global = np.linalg.inv(self._sd_to_global(ref_sd))
        clouds = [self._read_bin(ref_sd["filename"])]
        cur = ref_sd
        while len(clouds) < nsweeps and cur.get("prev"):
            cur = self.nusc.get("sample_data", cur["prev"])
            tm = ref_from_global @ self._sd_to_global(cur)
            pts = self._read_bin(cur["filename"])
            clouds.append(pts @ tm[:3, :3].T + tm[:3, 3])
        return np.concatenate(clouds).astype(np.float32)

    # -- projection (nuscenes_objects.map_pointcloud_to_image:237-297) -----
    def map_pointcloud_to_image(self, idx, camera_channel="CAM_FRONT",
                                min_dist: float = 1.0) -> dict:
        chans = self.nusc.channels_of(self.frames[idx])
        lidar_sd, cam_sd = chans["LIDAR_TOP"], chans[camera_channel]
        pc_lidar = self.get_pointcloud(idx)

        cam_from_global = np.linalg.inv(self._sd_to_global(cam_sd))
        tm = cam_from_global @ self._sd_to_global(lidar_sd)
        pc_cam = pc_lidar @ tm[:3, :3].T + tm[:3, 3]

        cs = self.nusc.get("calibrated_sensor",
                           cam_sd["calibrated_sensor_token"])
        K = np.asarray(cs["camera_intrinsic"], np.float64)
        depth = pc_cam[:, 2]
        z = np.where(depth == 0, 1e-9, depth)
        uv = np.stack([K[0, 0] * pc_cam[:, 0] / z + K[0, 2],
                       K[1, 1] * pc_cam[:, 1] / z + K[1, 2]], axis=1)
        h = int(cam_sd.get("height", 900))
        w = int(cam_sd.get("width", 1600))
        fov = ((depth > min_dist) & (uv[:, 0] > 0) & (uv[:, 0] < w)
               & (uv[:, 1] > 0) & (uv[:, 1] < h))
        return {"pc_lidar": pc_lidar[fov], "pc_cam": pc_cam[fov],
                "pts_img": np.floor(uv[fov]).astype(np.int64),
                "fov_inds": fov, "img_shape": (h, w)}

    def get_camera_instances(self, idx, channel="CAM_FRONT"):
        coco = self.masks.get(channel)
        if coco is None:
            return []
        cam_sd = self.nusc.channels_of(self.frames[idx])[channel]
        stem = os.path.splitext(os.path.basename(cam_sd["filename"]))[0]
        # reference keys mask images by file stem; ours may use id or name
        img = coco.file_to_img.get(stem) or coco.file_to_img.get(
            os.path.basename(cam_sd["filename"]))
        img_id = img["id"] if img else stem
        return _filter_instances(coco, img_id, self.classes,
                                 NUSCENES_CLASS2IDX)

    def get_save_fname(self, idx) -> str:
        return os.path.join(self.save_dir, f"{self.frames[idx]}#{idx:06d}")

    def update_infos(self, out_dir: str | None = None):
        """Record completed_lidar_path (+ per-box completed point counts)
        into infos_<tag>/nuscenes_infos_<split>.pkl
        (nuscenes_objects.update_infos:143-182)."""
        from .kitti.bootstrap import points_in_rotated_boxes_np

        saved = glob.glob(os.path.join(self.save_dir, "*.pcd"))
        out_dir = out_dir or os.path.join(self.root, f"infos_{self.tag}")
        os.makedirs(out_dir, exist_ok=True)
        new_infos = []
        for path in sorted(saved):
            token = os.path.basename(path).split("#")[0]
            loc = self._token_to_info.get(token)
            if loc is None:
                continue
            info = copy.deepcopy(self.infos[loc[0]][loc[1]])
            info["completed_lidar_path"] = os.path.relpath(path, self.root)
            gt = np.asarray(info.get("gt_boxes", np.zeros((0, 7))),
                            np.float32)
            pts = read_pcd(path)
            inside = points_in_rotated_boxes_np(pts[:, :3], gt[:, :7])
            info["num_completed_lidar_pts"] = inside.sum(axis=1).astype(int)
            new_infos.append(info)
        out = os.path.join(out_dir, f"nuscenes_infos_{self.split}.pkl")
        with open(out, "wb") as f:
            pickle.dump(new_infos, f)
        return out


# ---------------------------------------------------------------------------
# Waymo
# ---------------------------------------------------------------------------

class WaymoObjects:
    """Waymo SEE adapter (waymo_objects.py:31-230): per-sequence processed
    npy/pkl tree + precomputed image projections under
    image_lidar_projections/{image_pc,fov_inds}/<cam>/<seq>_<idx:04>.npy.

    cfg keys: DATA_DIR, PROCESSED_DATA_TAG, SPLIT, SAMPLED_INTERVAL,
    CLASSES, CAMERA_CHANNELS, MASK_DIR, TAG.
    """

    dataset_name = "waymo"

    def __init__(self, cfg):
        self.root = cfg.get("DATA_DIR", ".")
        self.processed_dir = os.path.join(
            self.root, cfg.get("PROCESSED_DATA_TAG", "waymo_processed_data"))
        self.classes = list(cfg.get("CLASSES", ["Car"]))
        self.camera_channels = list(cfg.get("CAMERA_CHANNELS", ["FRONT"]))
        self.shrink_mask_percentage = float(
            cfg.get("SHRINK_MASK_PERCENTAGE", 0))
        self.tag = cfg.get("TAG", "vcn")
        self.split = cfg.get("SPLIT", "train")
        self.save_dir = os.path.join(self.root, f"vcn_{self.tag}")
        self.proj_dir = os.path.join(self.root, "image_lidar_projections")

        split_file = os.path.join(self.root, "ImageSets", f"{self.split}.txt")
        if os.path.exists(split_file):
            with open(split_file) as f:
                self.sample_sequence_list = [
                    os.path.splitext(x.strip())[0] for x in f if x.strip()]
        else:
            self.sample_sequence_list = sorted(
                d for d in os.listdir(self.processed_dir)
                if os.path.isdir(os.path.join(self.processed_dir, d)))
        self.infos = []
        for seq in self.sample_sequence_list:
            p = os.path.join(self.processed_dir, seq, f"{seq}.pkl")
            with open(p, "rb") as f:
                self.infos.extend(pickle.load(f))
        step = int(cfg.get("SAMPLED_INTERVAL", 1))
        if step > 1:
            self.infos = self.infos[::step]
        self.frames = [f"{i['point_cloud']['lidar_sequence']}_"
                       f"{i['point_cloud']['sample_idx']:04d}"
                       for i in self.infos]

        self.masks = _load_masks(
            cfg.get("MASK_DIR", os.path.join(self.proj_dir, "masks")),
            self.camera_channels)

    def __len__(self):
        return len(self.infos)

    def get_infos(self, idx):
        return self.infos[idx]

    def get_pointcloud(self, idx, disable_nlz_flag: bool = False):
        pc = self.infos[idx]["point_cloud"]
        path = os.path.join(self.processed_dir, pc["lidar_sequence"],
                            f"{pc['sample_idx']:04d}.npy")
        feats = np.load(path)
        if disable_nlz_flag and feats.shape[1] > 5:
            feats = feats[feats[:, 5] == -1]
        return feats[:, :3].astype(np.float32)

    def get_gt_boxes(self, idx) -> np.ndarray:
        annos = self.infos[idx].get("annos")
        if annos is None:
            return np.zeros((0, 7), np.float32)
        name_map = {"Car": "Vehicle"}
        wanted = {name_map.get(c, c) for c in self.classes}
        keep = np.isin(annos["name"], list(wanted))
        return np.asarray(annos["gt_boxes_lidar"], np.float32)[keep]

    def map_pointcloud_to_image(self, idx, camera_channel="FRONT") -> dict:
        pc = self.infos[idx]["point_cloud"]
        stem = f"{pc['lidar_sequence']}_{pc['sample_idx']:04d}.npy"
        pts_img = np.load(os.path.join(self.proj_dir, "image_pc",
                                       camera_channel, stem))
        fov_inds = np.load(os.path.join(self.proj_dir, "fov_inds",
                                        camera_channel, stem))
        cam_idx = WAYMO_CAMERAS.index(camera_channel)
        shape = self.infos[idx].get("image", {}).get(
            f"image_shape_{cam_idx}", (1280, 1920))
        return {"pc_lidar": self.get_pointcloud(idx)[fov_inds],
                "pts_img": np.floor(pts_img[:, :2]).astype(np.int64),
                "pc_cam": None, "fov_inds": fov_inds,
                "img_shape": tuple(shape)}

    def get_camera_instances(self, idx, channel="FRONT"):
        coco = self.masks.get(channel)
        if coco is None:
            return []
        fid = self.frames[idx]
        # reference mask JSONs key images by '<seq>_<idx:04>' directly;
        # generate_masks --backend outputs key by file name
        img = coco.file_to_img.get(f"{fid}.png") or \
            coco.file_to_img.get(f"{fid}.jpg") or coco.file_to_img.get(fid)
        img_id = img["id"] if img else fid
        return _filter_instances(coco, img_id, self.classes,
                                 WAYMO_CLASS2IDX)

    def get_save_fname(self, idx) -> str:
        pc = self.infos[idx]["point_cloud"]
        return os.path.join(self.save_dir, pc["lidar_sequence"],
                            f"{pc['sample_idx']:04d}")

    def update_infos(self, out_dir: str | None = None):
        """Per-sequence pkls under the save dir + master infos
        (waymo_objects.update_infos:113-140)."""
        by_key = {(i["point_cloud"]["lidar_sequence"],
                   int(i["point_cloud"]["sample_idx"])): i
                  for i in self.infos}
        for seq in self.sample_sequence_list:
            saved = glob.glob(os.path.join(self.save_dir, seq, "*.pcd"))
            if not saved:
                continue
            seq_infos = []
            for pcd in sorted(saved):
                fid = int(os.path.splitext(os.path.basename(pcd))[0])
                info = by_key.get((seq, fid))
                if info is None:
                    continue
                info["completed_lidar_path"] = os.path.relpath(pcd, self.root)
                seq_infos.append(info)
            with open(os.path.join(self.save_dir, seq, f"{seq}.pkl"),
                      "wb") as f:
                pickle.dump(seq_infos, f)
        out_dir = out_dir or os.path.join(self.root, f"infos_{self.tag}")
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"waymo_infos_{self.split}.pkl")
        with open(out, "wb") as f:
            pickle.dump(self.infos, f)
        return out


# ---------------------------------------------------------------------------
# Custom / Baraja
# ---------------------------------------------------------------------------

class CustomObjects:
    """Baraja Spectrum-Scan adapter (custom_dataset_objects.py:17-194):
    <root>/<split>/{pcd,calib,image/<cam>}, infos/baraja_infos_<split>.pkl,
    json calib with pinhole or equidistant-fisheye distortion (handled by
    geom.calibration.JsonCalibration)."""

    dataset_name = "custom"

    def __init__(self, cfg):
        self.root = cfg.get("DATA_DIR", ".")
        self.split = cfg.get("SPLIT", "test")
        self.split_dir = os.path.join(self.root, self.split)
        self.classes = list(cfg.get("CLASSES", ["Car"]))
        self.camera_channels = list(cfg.get("CAMERA_CHANNELS", ["front"]))
        self.shrink_mask_percentage = float(
            cfg.get("SHRINK_MASK_PERCENTAGE", 0))
        self.camera_model = cfg.get("CAMERA_MODEL", None)
        self.tag = cfg.get("TAG", "vcn")
        self.save_dir = os.path.join(self.split_dir, f"vcn_{self.tag}")

        info_path = cfg.get("INFO_PATH", os.path.join(
            self.root, "infos", f"baraja_infos_{self.split}.pkl"))
        if not os.path.isabs(info_path):
            info_path = os.path.join(self.root, info_path)
        if os.path.exists(info_path):
            with open(info_path, "rb") as f:
                self.infos = pickle.load(f)
            self.frames = [i["point_cloud"]["lidar_idx"] for i in self.infos]
        else:
            self.infos = []
            self.frames = sorted(
                os.path.splitext(os.path.basename(p))[0] for p in
                glob.glob(os.path.join(self.split_dir, "pcd", "*.pcd")))

        self.masks = _load_masks(
            cfg.get("MASK_DIR", os.path.join(self.split_dir, "masks")),
            self.camera_channels)

    def __len__(self):
        return len(self.frames)

    def get_infos(self, idx):
        return self.infos[idx] if self.infos else None

    def get_pointcloud(self, idx) -> np.ndarray:
        return read_pcd(os.path.join(self.split_dir, "pcd",
                                     f"{self.frames[idx]}.pcd"))[:, :3]

    def get_calibration(self, idx) -> JsonCalibration:
        import json

        with open(os.path.join(self.split_dir, "calib",
                               f"{self.frames[idx]}.json")) as f:
            spec = json.load(f)
        if self.camera_model and "distortion_model" not in spec:
            spec["distortion_model"] = \
                "fisheye" if self.camera_model == "equidistant" \
                else self.camera_model
        return JsonCalibration(spec)

    def get_gt_boxes(self, idx) -> np.ndarray:
        info = self.get_infos(idx)
        if not info or "annos" not in info:
            return np.zeros((0, 7), np.float32)
        annos = info["annos"]
        keep = np.isin(annos["name"], self.classes)
        return np.asarray(annos["gt_boxes_lidar"], np.float32)[keep]

    def get_image_shape(self, idx, channel="front"):
        info = self.get_infos(idx)
        if info and "image" in info:
            return tuple(int(v) for v in info["image"]["image_shape"])
        return (1024, 1920)

    def map_pointcloud_to_image(self, idx, camera_channel="front",
                                min_dist: float = 1.0) -> dict:
        points = self.get_pointcloud(idx)
        calib = self.get_calibration(idx)
        h, w = self.get_image_shape(idx, camera_channel)
        # pre-distortion gate against wrap-around of wide-angle distortion
        # (custom_dataset_objects.py:158-162)
        cam = calib.lidar_to_cam(points)
        z = np.where(cam[:, 2] == 0, 1e-9, cam[:, 2])
        pre = (cam[:, 2] > 0) & (np.abs(cam[:, 0] / z) < np.arctan(w / h))
        uv, depth = calib.lidar_to_img(points[pre])
        fov = ((uv[:, 0] > 0) & (uv[:, 0] < w - 1)
               & (uv[:, 1] > 0) & (uv[:, 1] < h - 1) & (depth > min_dist))
        combined = np.zeros(len(points), bool)
        combined[pre] = fov
        uvd = np.concatenate([uv[fov], depth[fov, None]], axis=1)
        return {"pc_lidar": points[combined], "pc_cam": uvd,
                "pts_img": np.round(uvd[:, :2]).astype(np.int64),
                "fov_inds": combined, "img_shape": (h, w)}

    def get_camera_instances(self, idx, channel="front"):
        coco = self.masks.get(channel)
        if coco is None:
            return []
        fid = self.frames[idx]
        img = coco.file_to_img.get(f"{fid}.jpg") or \
            coco.file_to_img.get(f"{fid}.png")
        img_id = img["id"] if img else fid
        return _filter_instances(coco, img_id, self.classes, WAYMO_CLASS2IDX)

    def get_save_fname(self, idx) -> str:
        return os.path.join(self.save_dir, f"{self.frames[idx]}")

    def update_infos(self, out_dir: str | None = None):
        saved = glob.glob(os.path.join(self.save_dir, "*.pcd"))
        by_id = {i["point_cloud"]["lidar_idx"]: i for i in self.infos}
        new_infos = []
        for path in sorted(saved):
            fid = os.path.splitext(os.path.basename(path))[0]
            info = by_id.get(fid)
            if info is None:
                continue
            info = copy.deepcopy(info)
            info["completed_lidar_path"] = os.path.relpath(path,
                                                           self.split_dir)
            new_infos.append(info)
        out_dir = out_dir or os.path.join(self.root, f"infos_{self.tag}")
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"baraja_infos_{self.split}.pkl")
        with open(out, "wb") as f:
            pickle.dump(new_infos, f)
        return out


SEE_ADAPTERS = {"nuscenes": NuscenesObjects, "waymo": WaymoObjects,
                "custom": CustomObjects, "baraja": CustomObjects}
