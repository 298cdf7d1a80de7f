"""Lyft Level-5 infos + gt-database generation without the SDK (port of
seevcn_tpu/data/lyft_bootstrap.py, host numpy, copied).

Reference: detector3d/pcdet/datasets/lyft/lyft_dataset.py
(create_lyft_info:252-305) + lyft_utils.py (fill_trainval_infos:87-225,
get_available_scenes:18-44) — which drive the lyft_dataset_sdk. The Lyft
release is a nuScenes-format fork (identical JSON relation tables, under
``<root>/<version>/data/*.json`` with data files relative to
``<root>/<version>/``), so this module reuses the devkit-free nuScenes
table reader and info filler (nuscenes_bootstrap.py) and emits
``lyft_infos_{train,val}.pkl`` in the structure LyftDataset consumes
(lidar_path, token, sweeps with relative transforms + time lags,
gt_boxes/gt_names in the lidar frame).

Split selection follows the reference: scene-name lists from
``ImageSets/{train,val}.txt`` (create_lyft_info:268-282); scenes in
neither list land in val, matching fill_trainval_infos' train-else-val
routing over the union.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from .nuscenes_bootstrap import NuScenesTables, fill_trainval_infos


def _read_split(path: str) -> list[str]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def create_lyft_infos(root_path: str, version: str = "trainval",
                      max_sweeps: int = 10, save_path: str | None = None,
                      logger=print) -> dict:
    """root_path is the lyft root holding ``<version>/data/*.json`` and
    ``ImageSets/{train,val}.txt``. Writes lyft_infos_{train,val}.pkl (or
    lyft_infos_test.pkl for the test version) under <root>/<version>."""
    data_path = os.path.join(root_path, version)
    tables = NuScenesTables(data_path, version,
                            table_dir=os.path.join(data_path, "data"))
    split_dir = os.path.join(root_path, "ImageSets")
    is_test = "test" in version
    train_names = set(_read_split(os.path.join(
        split_dir, "test.txt" if is_test else "train.txt")))
    name_to_token = {s["name"]: s["token"] for s in tables.scene}
    train_scenes = {name_to_token[n] for n in train_names
                    if n in name_to_token}
    if not train_names:           # no split files: everything trains
        train_scenes = set(name_to_token.values())
    elif is_test:
        # test mode writes ONLY the test pkl: scenes in the tables but
        # missing from test.txt would be routed to val and silently
        # dropped — surface that instead
        missing = set(name_to_token.values()) - train_scenes
        if missing:
            logger(f"WARNING: {len(missing)} scenes present in the tables "
                   f"but absent from ImageSets/test.txt are EXCLUDED from "
                   f"lyft_infos_test.pkl")
    # everything else lands in val (the reference routes train-else-val)
    val_scenes = set(name_to_token.values()) - train_scenes

    train_infos, val_infos = fill_trainval_infos(
        tables, train_scenes, val_scenes, test=is_test,
        max_sweeps=max_sweeps)

    save_path = save_path or data_path
    os.makedirs(save_path, exist_ok=True)
    out = {}
    if is_test:
        p = os.path.join(save_path, "lyft_infos_test.pkl")
        with open(p, "wb") as f:
            pickle.dump(train_infos, f)
        logger(f"lyft infos test: {len(train_infos)} samples -> {p}")
        out["test"] = p
    else:
        for split, infos in (("train", train_infos), ("val", val_infos)):
            p = os.path.join(save_path, f"lyft_infos_{split}.pkl")
            with open(p, "wb") as f:
                pickle.dump(infos, f)
            logger(f"lyft infos {split}: {len(infos)} samples -> {p}")
            out[split] = p
    return out


def create_lyft_groundtruth_database(root_path: str, version: str,
                                     info_path: str, used_classes=None,
                                     logger=print) -> str:
    """Per-object point extraction into gt_database/ +
    lyft_dbinfos_*.pkl (lyft_dataset.py:create_groundtruth_database:
    207-249; points_in_boxes_gpu becomes the closed-form numpy test)."""
    from .kitti.bootstrap import points_in_rotated_boxes_np

    data_path = os.path.join(root_path, version)
    db_dir = os.path.join(data_path, "gt_database")
    os.makedirs(db_dir, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    all_db_infos: dict[str, list] = {}
    for idx, info in enumerate(infos):
        path = os.path.join(data_path, info["lidar_path"])
        pts = np.fromfile(path, dtype=np.float32)
        pts = pts[:len(pts) - len(pts) % 5].reshape(-1, 5)[:, :4]
        gt_boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))),
                              np.float32)
        names = np.asarray(info.get("gt_names", []))
        if not len(gt_boxes):
            continue
        inside = points_in_rotated_boxes_np(pts[:, :3], gt_boxes[:, :7]).T
        for i in range(len(gt_boxes)):
            name = str(names[i])
            if used_classes is not None and name not in used_classes:
                continue
            obj = pts[inside[:, i]].copy()
            obj[:, :3] -= gt_boxes[i, :3]
            fname = f"{idx}_{name}_{i}.bin"
            obj.astype(np.float32).tofile(os.path.join(db_dir, fname))
            all_db_infos.setdefault(name, []).append({
                "name": name, "path": os.path.join("gt_database", fname),
                "image_idx": idx, "gt_idx": i,
                "box3d_lidar": gt_boxes[i],
                "num_points_in_gt": int(len(obj)),
            })
    db_info_path = os.path.join(data_path, "lyft_dbinfos.pkl")
    with open(db_info_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    for k, v in all_db_infos.items():
        logger(f"lyft gt database {k}: {len(v)}")
    return db_info_path
