"""Waymo Open Dataset preprocessing: TFRecord segments -> per-frame npy
point files + per-sequence info pkls + gt-database (port of
seevcn_tpu/data/waymo_bootstrap.py, host numpy, copied).

Reference: detector3d/pcdet/datasets/waymo/waymo_utils.py
(process_single_sequence:184-243, generate_labels:23-62,
save_lidar_points:160-182) and waymo_dataset.py (get_infos:137,
create_groundtruth_database:321-400, create_waymo_infos:403-445).

The heavy proto decode (Frame.ParseFromString) and the range-image ->
cartesian conversion need the ``waymo_open_dataset`` SDK; like the
reference's docker, that dependency is gated — this module reads the
TFRecord container natively (no TF needed) and uses the SDK only for the
per-record decode when present. Everything downstream of the decode
(infos aggregation, gt-database extraction, the npy/pkl tree layout the
WaymoDataset consumes) is SDK-free and fully exercised by tests.
"""
from __future__ import annotations

import os
import pickle
import struct

import numpy as np

WAYMO_CLASSES = ["unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist"]


# ---------------------------------------------------------------------------
# TFRecord container (native; TF-free)
# ---------------------------------------------------------------------------

def read_tfrecord(path: str, skip_crc: bool = True):
    """Yield raw record payloads from a TFRecord file.

    Framing per TF's RecordWriter: u64le length, u32le masked-crc(length),
    payload, u32le masked-crc(payload). CRC validation requires crc32c
    (absent here); corruption surfaces as a struct/length error instead.
    """
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            (length,) = struct.unpack("<Q", head)
            f.read(4)  # length crc
            payload = f.read(length)
            if len(payload) < length:
                raise EOFError(f"truncated record in {path}")
            f.read(4)  # payload crc
            yield payload


def write_tfrecord(path: str, payloads) -> None:
    """Inverse of read_tfrecord (zeroed CRCs) — used to build test fixtures
    and to re-shard segments."""
    with open(path, "wb") as f:
        for p in payloads:
            f.write(struct.pack("<Q", len(p)))
            f.write(b"\x00" * 4)
            f.write(p)
            f.write(b"\x00" * 4)


# ---------------------------------------------------------------------------
# per-frame decode (SDK-gated) -> plain dict
# ---------------------------------------------------------------------------

def decode_frame_with_sdk(payload: bytes) -> dict:
    """waymo_open_dataset decode of one Frame record -> {points (N,6),
    annos, pose, frame metadata}. Mirrors waymo_utils.py:184-243 exactly;
    requires the SDK (gated like the reference's docker dependency)."""
    try:
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils
    except ImportError as e:
        raise ImportError(
            "waymo_open_dataset is required to decode raw Waymo TFRecords "
            "(the reference's docker installs it). Pre-extracted frame dicts "
            "are accepted instead — see process_single_sequence(frames=...).") from e

    frame = dataset_pb2.Frame()
    frame.ParseFromString(payload)
    range_images, camera_projections, _, range_image_top_pose = \
        frame_utils.parse_range_image_and_camera_projection(frame)
    points, _ = frame_utils.convert_range_image_to_point_cloud(
        frame, range_images, camera_projections, range_image_top_pose,
        keep_polar_features=True)
    # keep_polar_features gives (range, intensity, elongation, x, y, z)
    pts = np.concatenate(points, axis=0)
    xyz = pts[:, 3:6]
    feats = pts[:, 1:3]  # intensity, elongation
    nlz = np.zeros((len(xyz), 1), np.float32)
    out_points = np.concatenate([xyz, feats, nlz], axis=1).astype(np.float32)

    labels = []
    for lab in frame.laser_labels:
        labels.append({
            "name": WAYMO_CLASSES[lab.type],
            "box": [lab.box.center_x, lab.box.center_y, lab.box.center_z,
                    lab.box.length, lab.box.width, lab.box.height,
                    lab.box.heading],
            "difficulty": lab.detection_difficulty_level,
            "tracking_difficulty": lab.tracking_difficulty_level,
            "num_points_in_gt": lab.num_lidar_points_in_box,
            "obj_id": lab.id,
        })
    return {
        "points": out_points,
        "labels": labels,
        "pose": np.array(frame.pose.transform, np.float32).reshape(4, 4),
        "context_name": frame.context.name,
        "timestamp_micros": frame.timestamp_micros,
        "image_shapes": [(c.height, c.width)
                         for c in frame.context.camera_calibrations],
        "num_points_of_each_lidar": [len(p) for p in points],
    }


def generate_labels(labels: list[dict]) -> dict:
    """Label dicts -> the annos structure (waymo_utils.generate_labels),
    'unknown' rows dropped."""
    labels = [l for l in labels if l["name"] != "unknown"]
    annos = {
        "name": np.array([l["name"] for l in labels]),
        "difficulty": np.array([l["difficulty"] for l in labels]),
        "dimensions": np.array([l["box"][3:6] for l in labels],
                               np.float32).reshape(-1, 3),
        "location": np.array([l["box"][0:3] for l in labels],
                             np.float32).reshape(-1, 3),
        "heading_angles": np.array([l["box"][6] for l in labels], np.float32),
        "obj_ids": np.array([l["obj_id"] for l in labels]),
        "tracking_difficulty": np.array([l["tracking_difficulty"]
                                         for l in labels]),
        "num_points_in_gt": np.array([l["num_points_in_gt"] for l in labels]),
    }
    if len(labels):
        annos["gt_boxes_lidar"] = np.concatenate(
            [annos["location"], annos["dimensions"],
             annos["heading_angles"][:, None]], axis=1)
    else:
        annos["gt_boxes_lidar"] = np.zeros((0, 7), np.float32)
    return annos


# ---------------------------------------------------------------------------
# sequence processing (waymo_utils.process_single_sequence)
# ---------------------------------------------------------------------------

def process_single_sequence(sequence_file: str, save_path: str,
                            sampled_interval: int = 1, has_label: bool = True,
                            frames: list[dict] | None = None) -> list[dict]:
    """TFRecord segment (or pre-decoded ``frames`` dicts with the
    decode_frame_with_sdk structure) -> <save_path>/<seq>/NNNN.npy +
    <seq>.pkl. Resume-safe: an existing pkl short-circuits."""
    sequence_name = os.path.splitext(os.path.basename(sequence_file))[0]
    for suffix in ("_with_camera_labels", ".tfrecord"):
        if sequence_name.endswith(suffix):
            sequence_name = sequence_name[:-len(suffix)]
    cur_dir = os.path.join(save_path, sequence_name)
    os.makedirs(cur_dir, exist_ok=True)
    pkl_file = os.path.join(cur_dir, f"{sequence_name}.pkl")
    if os.path.exists(pkl_file):
        with open(pkl_file, "rb") as f:
            return pickle.load(f)

    if frames is None:
        frames = (decode_frame_with_sdk(p)
                  for p in read_tfrecord(sequence_file))

    infos = []
    for cnt, fr in enumerate(frames):
        if cnt % sampled_interval != 0:
            continue
        info = {
            "point_cloud": {"num_features": 5,
                            "lidar_sequence": sequence_name,
                            "sample_idx": cnt},
            "frame_id": sequence_name + f"_{cnt:03d}",
            "metadata": {"context_name": fr.get("context_name", sequence_name),
                         "timestamp_micros": fr.get("timestamp_micros", 0)},
            "image": {f"image_shape_{j}": s
                      for j, s in enumerate(fr.get("image_shapes", []))},
            "pose": np.asarray(fr.get("pose", np.eye(4)), np.float32),
        }
        if has_label:
            info["annos"] = generate_labels(fr.get("labels", []))
        pts = np.asarray(fr["points"], np.float32)
        np.save(os.path.join(cur_dir, f"{cnt:04d}.npy"), pts)
        info["num_points_of_each_lidar"] = fr.get(
            "num_points_of_each_lidar", [len(pts)])
        infos.append(info)

    with open(pkl_file, "wb") as f:
        pickle.dump(infos, f)
    return infos


def create_waymo_infos(raw_data_path: str, save_path: str,
                       split_names: list[str] | None = None,
                       sampled_interval: int = 1, num_workers: int = 4,
                       logger=print) -> list[dict]:
    """Process every segment under raw_data_path, aggregate infos
    (waymo_dataset.get_infos:137-158). Returns the merged list; the
    WaymoDataset reads the per-sequence pkls this leaves behind."""
    import concurrent.futures as futures

    seqs = split_names or sorted(
        x for x in os.listdir(raw_data_path) if x.endswith(".tfrecord"))
    with futures.ThreadPoolExecutor(num_workers) as ex:
        all_infos = ex.map(
            lambda s: process_single_sequence(
                os.path.join(raw_data_path, s), save_path, sampled_interval),
            seqs)
    merged = [i for infos in all_infos for i in infos]
    logger(f"waymo infos: {len(merged)} frames from {len(seqs)} sequences")
    return merged


# ---------------------------------------------------------------------------
# gt database (waymo_dataset.create_groundtruth_database:321-400)
# ---------------------------------------------------------------------------

def create_waymo_groundtruth_database(
        processed_path: str, save_path: str | None = None,
        used_classes=("Vehicle", "Pedestrian", "Cyclist"),
        split: str = "train", sampled_interval: int = 10,
        processed_data_tag: str = "waymo_processed_data",
        logger=print) -> str:
    """Walk the processed npy/pkl tree, extract per-object points."""
    from .kitti.bootstrap import points_in_rotated_boxes_np

    save_path = save_path or os.path.dirname(processed_path.rstrip("/"))
    db_dir = os.path.join(
        save_path,
        f"{processed_data_tag}_gt_database_{split}_sampled_{sampled_interval}")
    os.makedirs(db_dir, exist_ok=True)
    all_db_infos: dict[str, list] = {}

    seqs = sorted(d for d in os.listdir(processed_path)
                  if os.path.isdir(os.path.join(processed_path, d)))
    k = 0
    for seq in seqs:
        pkl = os.path.join(processed_path, seq, f"{seq}.pkl")
        if not os.path.exists(pkl):
            continue
        with open(pkl, "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            k += 1
            if (k - 1) % sampled_interval != 0:
                continue
            pc = info["point_cloud"]
            pts = np.load(os.path.join(processed_path, pc["lidar_sequence"],
                                       f"{pc['sample_idx']:04d}.npy"))
            annos = info.get("annos")
            if annos is None or not len(annos["name"]):
                continue
            gt_boxes = annos["gt_boxes_lidar"]
            inside = points_in_rotated_boxes_np(pts[:, :3], gt_boxes[:, :7])
            for i, name in enumerate(annos["name"]):
                if used_classes is not None and name not in used_classes:
                    continue
                filename = f"{info['frame_id']}_{name}_{i}.bin"
                gt_points = pts[inside[i]].astype(np.float32).copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                gt_points.tofile(os.path.join(db_dir, filename))
                all_db_infos.setdefault(name, []).append({
                    "name": name,
                    "path": os.path.join(os.path.basename(db_dir), filename),
                    "sequence_name": pc["lidar_sequence"],
                    "sample_idx": pc["sample_idx"], "gt_idx": i,
                    "box3d_lidar": gt_boxes[i].astype(np.float32),
                    "num_points_in_gt": int(inside[i].sum()),
                    "difficulty": annos["difficulty"][i],
                })
    for c, v in all_db_infos.items():
        logger(f"waymo gt database {c}: {len(v)}")
    db_info_path = os.path.join(
        save_path,
        f"{processed_data_tag}_waymo_dbinfos_{split}_sampled_"
        f"{sampled_interval}.pkl")
    with open(db_info_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return db_info_path
