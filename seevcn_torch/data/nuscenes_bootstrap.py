"""nuScenes infos generation without the devkit (port of
seevcn_tpu/data/nuscenes_bootstrap.py, host numpy in f64, copied).

Reference: detector3d/pcdet/datasets/nuscenes/nuscenes_utils.py
(fill_trainval_infos:252-380, get_sample_data:185-250) — which drives the
nuscenes-devkit SDK. The devkit is not a dependency: the
nuScenes release format is plain JSON relation tables
(``v1.0-*/{scene,sample,sample_data,...}.json``), so this module reads them
directly and emits the same ``nuscenes_infos_10sweeps_{train,val}.pkl``
structure the NuScenesDataset consumes: per-sample lidar path, CAM_FRONT
path+intrinsics, max_sweeps-1 sweep records with relative transforms, and
gt boxes (x y z l w h yaw vx vy) in the lidar sensor frame.
"""
from __future__ import annotations

import json
import os
import pickle
from functools import reduce

import numpy as np

# devkit map_name_from_general_to_detection (nuscenes_utils.py:24-50)
MAP_NAME_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}


# ---------------------------------------------------------------------------
# quaternion / rigid-transform helpers (devkit transform_matrix equivalents)
# ---------------------------------------------------------------------------

def quat_to_rotmat(q) -> np.ndarray:
    """nuScenes (w, x, y, z) quaternion -> (3,3) rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_multiply(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_inverse(q):
    return np.array([q[0], -q[1], -q[2], -q[3]]) / np.dot(q, q)


def quaternion_yaw(q) -> float:
    """Yaw of the rotated x-axis projected onto the xy-plane (devkit
    eval.common.utils.quaternion_yaw)."""
    v = quat_to_rotmat(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, rotation_q, inverse: bool = False):
    tm = np.eye(4)
    R = quat_to_rotmat(rotation_q)
    t = np.asarray(translation, np.float64)
    if inverse:
        tm[:3, :3] = R.T
        tm[:3, 3] = -R.T @ t
    else:
        tm[:3, :3] = R
        tm[:3, 3] = t
    return tm


# ---------------------------------------------------------------------------
# raw-table access (the devkit-free NuScenes class)
# ---------------------------------------------------------------------------

class NuScenesTables:
    """Load the nuScenes relation tables from ``<root>/<version>/*.json``
    into token-keyed dicts; reconstruct the devkit's sample['data'] channel
    map from sample_data + calibrated_sensor + sensor."""

    TABLES = ("scene", "sample", "sample_data", "calibrated_sensor",
              "ego_pose", "sample_annotation", "instance", "category",
              "sensor")

    def __init__(self, root: str, version: str = "v1.0-trainval",
                 table_dir: str | None = None):
        """table_dir overrides the json directory (default
        <root>/<version>; the Lyft release keeps the same tables at
        <root>/data with data files relative to <root>)."""
        self.root = root
        self.version = version
        tdir = table_dir or os.path.join(root, version)
        self._tables = {}
        self._index = {}
        for name in self.TABLES:
            path = os.path.join(tdir, f"{name}.json")
            with open(path) as f:
                rows = json.load(f)
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}
        # channel per calibrated_sensor
        self._cs_channel = {
            cs["token"]: self._index["sensor"][cs["sensor_token"]]["channel"]
            for cs in self._tables["calibrated_sensor"]}
        # sample -> {channel: keyframe sample_data}
        self._sample_channels: dict[str, dict] = {}
        for sd in self._tables["sample_data"]:
            if not sd.get("is_key_frame", False):
                continue
            ch = self._cs_channel[sd["calibrated_sensor_token"]]
            self._sample_channels.setdefault(sd["sample_token"], {})[ch] = sd
        # sample -> [annotation tokens]
        self._sample_anns: dict[str, list] = {}
        for a in self._tables["sample_annotation"]:
            self._sample_anns.setdefault(a["sample_token"], []).append(
                a["token"])

    @property
    def sample(self):
        return self._tables["sample"]

    @property
    def scene(self):
        return self._tables["scene"]

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    def channels_of(self, sample_token: str) -> dict:
        return self._sample_channels.get(sample_token, {})

    def anns_of(self, sample_token: str) -> list:
        return self._sample_anns.get(sample_token, [])

    def category_name(self, ann: dict) -> str:
        inst = self.get("instance", ann["instance_token"])
        return self.get("category", inst["category_token"])["name"]

    def data_path(self, sd: dict) -> str:
        return os.path.join(self.root, sd["filename"])

    def box_velocity(self, ann: dict, max_time_diff: float = 1.5):
        """Finite-difference global velocity from the prev/next annotations
        of the same instance (devkit NuScenes.box_velocity)."""
        has_prev = bool(ann.get("prev"))
        has_next = bool(ann.get("next"))
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.get("sample_annotation", ann["prev"]) if has_prev else ann
        last = self.get("sample_annotation", ann["next"]) if has_next else ann
        pos_first = np.asarray(first["translation"], np.float64)
        pos_last = np.asarray(last["translation"], np.float64)
        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        dt = t_last - t_first
        if dt > max_time_diff or dt <= 0:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / dt


# ---------------------------------------------------------------------------
# infos generation (fill_trainval_infos)
# ---------------------------------------------------------------------------

def _boxes_in_sensor_frame(nusc: NuScenesTables, ann_tokens, cs_rec, pose_rec):
    """Global annotations -> (center, wlh, yaw, vel, name, token) in the
    sensor frame (devkit get_sample_data's box transform chain)."""
    q_ego_inv = quat_inverse(np.asarray(pose_rec["rotation"], np.float64))
    q_cs_inv = quat_inverse(np.asarray(cs_rec["rotation"], np.float64))
    R_ego_inv = quat_to_rotmat(pose_rec["rotation"]).T
    R_cs_inv = quat_to_rotmat(cs_rec["rotation"]).T
    t_ego = np.asarray(pose_rec["translation"], np.float64)
    t_cs = np.asarray(cs_rec["translation"], np.float64)

    out = []
    for tok in ann_tokens:
        ann = nusc.get("sample_annotation", tok)
        c = np.asarray(ann["translation"], np.float64)
        c = R_cs_inv @ (R_ego_inv @ (c - t_ego) - t_cs)
        q = quat_multiply(q_cs_inv, quat_multiply(
            q_ego_inv, np.asarray(ann["rotation"], np.float64)))
        vel = nusc.box_velocity(ann)
        vel = R_cs_inv @ (R_ego_inv @ vel)
        out.append({
            "center": c, "wlh": np.asarray(ann["size"], np.float64),
            "yaw": quaternion_yaw(q), "velocity": vel,
            "name": nusc.category_name(ann), "token": tok,
            "num_lidar_pts": ann.get("num_lidar_pts", -1),   # -1: no field
            "num_radar_pts": ann.get("num_radar_pts", -1),   # (Lyft tables)
        })
    return out


def fill_trainval_infos(nusc: NuScenesTables, train_scenes, val_scenes,
                        test: bool = False, max_sweeps: int = 10):
    """nuscenes_utils.py:252-380 on the raw tables. train/val_scenes are
    sets of scene *tokens*."""
    train_infos, val_infos = [], []
    for sample in nusc.sample:
        chans = nusc.channels_of(sample["token"])
        ref_sd = chans["LIDAR_TOP"]
        ref_cs = nusc.get("calibrated_sensor",
                          ref_sd["calibrated_sensor_token"])
        ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]

        ref_from_car = transform_matrix(ref_cs["translation"],
                                        ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(ref_pose["translation"],
                                           ref_pose["rotation"], inverse=True)

        cam = chans.get("CAM_FRONT")
        cam_cs = nusc.get("calibrated_sensor",
                          cam["calibrated_sensor_token"]) if cam else None
        info = {
            "lidar_path": ref_sd["filename"],
            "cam_front_path": cam["filename"] if cam else None,
            "cam_intrinsic": (np.asarray(cam_cs["camera_intrinsic"])
                              if cam_cs else None),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        # sweeps: walk sample_data.prev
        curr = ref_sd
        sweeps = []
        while len(sweeps) < max_sweeps - 1:
            if not curr.get("prev"):
                if not sweeps:
                    sweeps.append({"lidar_path": ref_sd["filename"],
                                   "sample_data_token": curr["token"],
                                   "transform_matrix": None,
                                   "time_lag": 0.0})
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr = nusc.get("sample_data", curr["prev"])
                cur_pose = nusc.get("ego_pose", curr["ego_pose_token"])
                global_from_car = transform_matrix(
                    cur_pose["translation"], cur_pose["rotation"])
                cur_cs = nusc.get("calibrated_sensor",
                                  curr["calibrated_sensor_token"])
                car_from_current = transform_matrix(
                    cur_cs["translation"], cur_cs["rotation"])
                tm = reduce(np.dot, [ref_from_car, car_from_global,
                                     global_from_car, car_from_current])
                sweeps.append({
                    "lidar_path": curr["filename"],
                    "sample_data_token": curr["token"],
                    "transform_matrix": tm,
                    "global_from_car": global_from_car,
                    "car_from_current": car_from_current,
                    "time_lag": ref_time - 1e-6 * curr["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            boxes = _boxes_in_sensor_frame(nusc, nusc.anns_of(sample["token"]),
                                           ref_cs, ref_pose)
            num_lidar_pts = np.array([b["num_lidar_pts"] for b in boxes])
            num_radar_pts = np.array([b["num_radar_pts"] for b in boxes])
            # Lyft annotation tables carry no point-count fields (-1
            # sentinel) — keep those rows; nuScenes drops point-free boxes
            # like the devkit (nuscenes_utils.py:331)
            mask = ((num_lidar_pts + num_radar_pts) > 0) | \
                (num_lidar_pts < 0)

            locs = np.array([b["center"] for b in boxes]).reshape(-1, 3)
            # wlh -> (l, w, h) = dxdydz
            dims = np.array([b["wlh"] for b in boxes]).reshape(-1, 3)[:, [1, 0, 2]]
            rots = np.array([b["yaw"] for b in boxes]).reshape(-1, 1)
            velocity = np.array([b["velocity"] for b in boxes]).reshape(-1, 3)
            names = np.array([MAP_NAME_TO_DETECTION.get(b["name"], b["name"])
                              for b in boxes])
            tokens = np.array([b["token"] for b in boxes])
            gt_boxes = np.concatenate([locs, dims, rots, velocity[:, :2]],
                                      axis=1)
            info["gt_boxes"] = gt_boxes[mask]
            info["gt_boxes_velocity"] = velocity[mask]
            info["gt_names"] = names[mask]
            info["gt_boxes_token"] = tokens[mask]
            info["num_lidar_pts"] = num_lidar_pts[mask]
            info["num_radar_pts"] = num_radar_pts[mask]

        if sample["scene_token"] in train_scenes:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_infos(root_path: str, version: str = "v1.0-trainval",
                          max_sweeps: int = 10, val_scene_names=None,
                          save_path: str | None = None, logger=print) -> dict:
    """Write nuscenes_infos_{max_sweeps}sweeps_{train,val}.pkl. Scenes whose
    name is in val_scene_names go to val (default: the official devkit split
    is unavailable without the devkit, so every scene not named goes to
    train)."""
    nusc = NuScenesTables(root_path, version)
    save_path = save_path or root_path
    val_names = set(val_scene_names or [])
    train_scenes = {s["token"] for s in nusc.scene if s["name"] not in val_names}
    val_scenes = {s["token"] for s in nusc.scene if s["name"] in val_names}
    train_infos, val_infos = fill_trainval_infos(
        nusc, train_scenes, val_scenes, test="test" in version,
        max_sweeps=max_sweeps)
    out = {}
    for split, infos in (("train", train_infos), ("val", val_infos)):
        p = os.path.join(save_path,
                         f"nuscenes_infos_{max_sweeps}sweeps_{split}.pkl")
        with open(p, "wb") as f:
            pickle.dump(infos, f)
        logger(f"nuscenes infos {split}: {len(infos)} samples -> {p}")
        out[split] = p
    return out


def create_nuscenes_groundtruth_database(root_path: str, info_path: str,
                                         used_classes=None,
                                         max_sweeps: int = 10,
                                         logger=print) -> str:
    """Per-object point extraction into gt_database_{N}sweeps_withvelo
    (nuscenes_dataset.py create_groundtruth_database)."""
    from .kitti.bootstrap import points_in_rotated_boxes_np

    db_dir = os.path.join(root_path, f"gt_database_{max_sweeps}sweeps_withvelo")
    os.makedirs(db_dir, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    all_db_infos: dict[str, list] = {}
    for idx, info in enumerate(infos):
        path = os.path.join(root_path, info["lidar_path"])
        points = np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :4]
        gt_boxes = np.asarray(info["gt_boxes"], np.float32)
        names = info["gt_names"]
        inside = points_in_rotated_boxes_np(points[:, :3], gt_boxes[:, :7])
        for i in range(len(gt_boxes)):
            if used_classes is not None and names[i] not in used_classes:
                continue
            filename = f"{info['token']}_{names[i]}_{i}.bin"
            gt_points = points[inside[i]].copy()
            gt_points[:, :3] -= gt_boxes[i, :3]
            gt_points.tofile(os.path.join(db_dir, filename))
            all_db_infos.setdefault(names[i], []).append({
                "name": names[i],
                "path": os.path.join(os.path.basename(db_dir), filename),
                "image_idx": idx, "gt_idx": i,
                "box3d_lidar": gt_boxes[i],
                "num_points_in_gt": int(inside[i].sum()),
            })
    for k, v in all_db_infos.items():
        logger(f"nuscenes gt database {k}: {len(v)}")
    db_info_path = os.path.join(
        root_path, f"nuscenes_dbinfos_{max_sweeps}sweeps_withvelo.pkl")
    with open(db_info_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return db_info_path
