"""KITTI dataset bootstrap: raw tree -> infos pkls + gt-database (port of
seevcn_tpu/data/kitti/bootstrap.py, host numpy, copied).

Reference: detector3d/pcdet/datasets/kitti/kitti_dataset.py:151 (get_infos)
and :225 (create_groundtruth_database), object3d_kitti.py (label parsing,
difficulty levels). This is the tooling that lets the framework start from a
raw KITTI checkout (velodyne/.bin + label_2/.txt + calib/.txt + image_2)
instead of pre-digested reference artifacts: it writes the exact
``kitti_infos_<split>.pkl`` / ``kitti_dbinfos_<split>.pkl`` /
``gt_database/*.bin`` layouts the datasets and the GT-paste augmentor
consume. Pure host numpy — no device work, no torch.
"""
from __future__ import annotations

import concurrent.futures as futures
import os
import pickle
import struct

import numpy as np

from ...geom.calibration import KittiCalibration

CLS_TO_ID = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}


# ---------------------------------------------------------------------------
# label parsing (object3d_kitti.py)
# ---------------------------------------------------------------------------

def kitti_obj_level(box2d, truncation, occlusion) -> int:
    """Difficulty per the official protocol (object3d_kitti.py:39-52)."""
    height = float(box2d[3]) - float(box2d[1]) + 1
    if height >= 40 and truncation <= 0.15 and occlusion <= 0:
        return 0  # Easy
    if height >= 25 and truncation <= 0.3 and occlusion <= 1:
        return 1  # Moderate
    if height >= 25 and truncation <= 0.5 and occlusion <= 2:
        return 2  # Hard
    return -1


def parse_label_file(path: str) -> list[dict]:
    objs = []
    with open(path) as f:
        for line in f:
            t = line.strip().split(" ")
            if len(t) < 15:
                continue
            box2d = np.array([float(x) for x in t[4:8]], np.float32)
            obj = {
                "name": t[0],
                "truncated": float(t[1]),
                "occluded": float(t[2]),
                "alpha": float(t[3]),
                "bbox": box2d,
                # label order is h, w, l; annos['dimensions'] is lhw (camera)
                "h": float(t[8]), "w": float(t[9]), "l": float(t[10]),
                "location": np.array([float(x) for x in t[11:14]], np.float32),
                "rotation_y": float(t[14]),
                "score": float(t[15]) if len(t) == 16 else -1.0,
            }
            obj["difficulty"] = kitti_obj_level(box2d, obj["truncated"],
                                                obj["occluded"])
            objs.append(obj)
    return objs


# ---------------------------------------------------------------------------
# image shape without an imaging dependency
# ---------------------------------------------------------------------------

def read_image_shape(path: str):
    """(H, W) from a PNG IHDR or JPEG SOF header."""
    with open(path, "rb") as f:
        head = f.read(2)
        if head == b"\x89P":  # PNG
            f.seek(16)
            w, h = struct.unpack(">II", f.read(8))
            return np.array([h, w], np.int32)
        if head == b"\xff\xd8":  # JPEG: scan for SOF0/1/2
            data = f.read()
            i = 0
            while i < len(data) - 9:
                if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2):
                    h, w = struct.unpack(">HH", data[i + 5:i + 9])
                    return np.array([h, w], np.int32)
                i += 1
    raise ValueError(f"unsupported image format: {path}")


# ---------------------------------------------------------------------------
# geometry (host numpy versions of geom/boxes device ops)
# ---------------------------------------------------------------------------

def points_in_rotated_boxes_np(points: np.ndarray, boxes: np.ndarray):
    """(P, 3) x (N, 7) -> (N, P) bool, z-rotated box containment.

    Equivalent to the reference's in_hull over boxes_to_corners_3d
    (kitti_dataset.py:210-214) — a box is a convex hull, so the closed-form
    local-frame test is exact.
    """
    if len(boxes) == 0 or len(points) == 0:
        return np.zeros((len(boxes), len(points)), bool)
    d = points[None, :, :3] - boxes[:, None, :3]
    c, s = np.cos(-boxes[:, 6]), np.sin(-boxes[:, 6])
    lx = d[:, :, 0] * c[:, None] - d[:, :, 1] * s[:, None]
    ly = d[:, :, 0] * s[:, None] + d[:, :, 1] * c[:, None]
    lz = d[:, :, 2]
    return ((np.abs(lx) <= boxes[:, None, 3] / 2)
            & (np.abs(ly) <= boxes[:, None, 4] / 2)
            & (np.abs(lz) <= boxes[:, None, 5] / 2))


def fov_point_flag(points: np.ndarray, calib: KittiCalibration,
                   img_shape, margin: float = 0) -> np.ndarray:
    """Points visible in the camera (kitti_dataset.py:135-148)."""
    rect = calib.lidar_to_rect(points[:, :3])
    uv, depth = calib.rect_to_img(rect)
    return ((uv[:, 0] >= -margin) & (uv[:, 0] < img_shape[1] + margin)
            & (uv[:, 1] >= -margin) & (uv[:, 1] < img_shape[0] + margin)
            & (depth >= 0))


# ---------------------------------------------------------------------------
# infos generation (kitti_dataset.py:151-225)
# ---------------------------------------------------------------------------

def _split_dir(root_path: str, split: str) -> str:
    return os.path.join(root_path,
                        "testing" if split == "test" else "training")


def _sample_ids(root_path: str, split: str):
    lst = os.path.join(root_path, "ImageSets", f"{split}.txt")
    if os.path.exists(lst):
        with open(lst) as f:
            return [x.strip() for x in f if x.strip()]
    # no ImageSets: enumerate the velodyne dir
    vdir = os.path.join(_split_dir(root_path, split), "velodyne")
    return sorted(os.path.splitext(x)[0] for x in os.listdir(vdir)
                  if x.endswith(".bin"))


def process_single_scene(root_path: str, split: str, sample_idx: str,
                         has_label: bool = True,
                         count_inside_pts: bool = True) -> dict:
    base = _split_dir(root_path, split)
    info = {"point_cloud": {"num_features": 4, "lidar_idx": sample_idx}}

    img_path = os.path.join(base, "image_2", f"{sample_idx}.png")
    if not os.path.exists(img_path):
        img_path = os.path.join(base, "image_2", f"{sample_idx}.jpg")
    image_shape = read_image_shape(img_path) if os.path.exists(img_path) \
        else np.array([375, 1242], np.int32)
    info["image"] = {"image_idx": sample_idx, "image_shape": image_shape}

    calib = KittiCalibration(os.path.join(base, "calib", f"{sample_idx}.txt"))
    P2 = np.concatenate([calib.P2, [[0., 0., 0., 1.]]], axis=0)
    R0_4x4 = np.zeros((4, 4), calib.R0.dtype)
    R0_4x4[3, 3] = 1.0
    R0_4x4[:3, :3] = calib.R0
    V2C_4x4 = np.concatenate([calib.V2C, [[0., 0., 0., 1.]]], axis=0)
    info["calib"] = {"P2": P2, "R0_rect": R0_4x4, "Tr_velo_to_cam": V2C_4x4}

    if has_label:
        objs = parse_label_file(os.path.join(base, "label_2",
                                             f"{sample_idx}.txt"))
        annotations = {
            "name": np.array([o["name"] for o in objs]),
            "truncated": np.array([o["truncated"] for o in objs]),
            "occluded": np.array([o["occluded"] for o in objs]),
            "alpha": np.array([o["alpha"] for o in objs]),
            "bbox": (np.stack([o["bbox"] for o in objs])
                     if objs else np.zeros((0, 4), np.float32)),
            "dimensions": np.array([[o["l"], o["h"], o["w"]] for o in objs],
                                   np.float32).reshape(-1, 3),  # lhw (camera)
            "location": (np.stack([o["location"] for o in objs])
                         if objs else np.zeros((0, 3), np.float32)),
            "rotation_y": np.array([o["rotation_y"] for o in objs]),
            "score": np.array([o["score"] for o in objs]),
            "difficulty": np.array([o["difficulty"] for o in objs], np.int32),
        }
        num_objects = sum(1 for o in objs if o["name"] != "DontCare")
        num_gt = len(objs)
        annotations["index"] = np.array(
            list(range(num_objects)) + [-1] * (num_gt - num_objects), np.int32)

        loc = annotations["location"][:num_objects]
        dims = annotations["dimensions"][:num_objects]
        rots = annotations["rotation_y"][:num_objects]
        loc_lidar = calib.rect_to_lidar(loc) if num_objects else \
            np.zeros((0, 3))
        l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
        if num_objects:
            loc_lidar[:, 2] += h[:, 0] / 2  # bottom-center -> box center
        gt_boxes_lidar = np.concatenate(
            [loc_lidar, l, w, h, -(np.pi / 2 + rots[:, None])],
            axis=1).astype(np.float32)
        annotations["gt_boxes_lidar"] = gt_boxes_lidar
        info["annos"] = annotations

        if count_inside_pts:
            pts = np.fromfile(os.path.join(base, "velodyne",
                                           f"{sample_idx}.bin"),
                              dtype=np.float32).reshape(-1, 4)
            fov = fov_point_flag(pts, calib, image_shape)
            pts_fov = pts[fov]
            num_points_in_gt = -np.ones(num_gt, np.int32)
            inside = points_in_rotated_boxes_np(pts_fov[:, :3], gt_boxes_lidar)
            num_points_in_gt[:num_objects] = inside.sum(axis=1)
            annotations["num_points_in_gt"] = num_points_in_gt
    return info


def get_infos(root_path: str, split: str, num_workers: int = 4,
              has_label: bool = True, count_inside_pts: bool = True,
              sample_id_list=None) -> list[dict]:
    ids = sample_id_list if sample_id_list is not None else \
        _sample_ids(root_path, split)
    with futures.ThreadPoolExecutor(num_workers) as ex:
        infos = ex.map(lambda i: process_single_scene(
            root_path, split, i, has_label, count_inside_pts), ids)
    return list(infos)


def create_kitti_infos(root_path: str, save_path: str | None = None,
                       splits=("train", "val"), with_test: bool = False,
                       num_workers: int = 4, logger=print) -> dict:
    """Write kitti_infos_{train,val,trainval[,test]}.pkl (kitti_dataset.py
    create_kitti_infos, :430-460). Returns {split: path}."""
    save_path = save_path or root_path
    os.makedirs(save_path, exist_ok=True)
    out, trainval = {}, []
    for split in splits:
        infos = get_infos(root_path, split, num_workers=num_workers)
        p = os.path.join(save_path, f"kitti_infos_{split}.pkl")
        with open(p, "wb") as f:
            pickle.dump(infos, f)
        logger(f"kitti infos {split}: {len(infos)} frames -> {p}")
        out[split] = p
        if split in ("train", "val"):
            trainval.extend(infos)
    if {"train", "val"} <= set(splits):
        p = os.path.join(save_path, "kitti_infos_trainval.pkl")
        with open(p, "wb") as f:
            pickle.dump(trainval, f)
        out["trainval"] = p
    if with_test:
        infos = get_infos(root_path, "test", num_workers=num_workers,
                          has_label=False, count_inside_pts=False)
        p = os.path.join(save_path, "kitti_infos_test.pkl")
        with open(p, "wb") as f:
            pickle.dump(infos, f)
        out["test"] = p
    return out


# ---------------------------------------------------------------------------
# gt database (kitti_dataset.py:225-275)
# ---------------------------------------------------------------------------

def create_groundtruth_database(root_path: str, info_path: str | None = None,
                                used_classes=None, split: str = "train",
                                logger=print) -> str:
    """Extract every GT object's points (center-subtracted) into
    gt_database/*.bin and write kitti_dbinfos_<split>.pkl — the pool the
    gt_sampling augmentation pastes from."""
    info_path = info_path or os.path.join(root_path,
                                          f"kitti_infos_{split}.pkl")
    db_dir = os.path.join(root_path, "gt_database" if split == "train"
                          else f"gt_database_{split}")
    os.makedirs(db_dir, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)

    all_db_infos: dict[str, list] = {}
    base = _split_dir(root_path, split)
    for info in infos:
        sample_idx = info["point_cloud"]["lidar_idx"]
        points = np.fromfile(os.path.join(base, "velodyne",
                                          f"{sample_idx}.bin"),
                             dtype=np.float32).reshape(-1, 4)
        annos = info["annos"]
        gt_boxes = annos["gt_boxes_lidar"]
        inside = points_in_rotated_boxes_np(points[:, :3], gt_boxes)
        for i in range(len(gt_boxes)):
            name = annos["name"][i]
            filename = f"{sample_idx}_{name}_{i}.bin"
            gt_points = points[inside[i]].copy()
            gt_points[:, :3] -= gt_boxes[i, :3]
            gt_points.tofile(os.path.join(db_dir, filename))
            if used_classes is None or name in used_classes:
                db_info = {
                    "name": name,
                    "path": os.path.join(os.path.basename(db_dir), filename),
                    "image_idx": sample_idx, "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": int(inside[i].sum()),
                    "difficulty": annos["difficulty"][i],
                    "bbox": annos["bbox"][i], "score": annos["score"][i],
                }
                all_db_infos.setdefault(name, []).append(db_info)

    for k, v in all_db_infos.items():
        logger(f"gt database {k}: {len(v)}")
    db_info_path = os.path.join(root_path, f"kitti_dbinfos_{split}.pkl")
    with open(db_info_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return db_info_path
