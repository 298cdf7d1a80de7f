"""nuScenes / Lyft / Waymo / Custom (Baraja) datasets + SC (completed-cloud)
variants (port of seevcn_tpu/data/generic.py, host numpy).

Reference: detector3d/pcdet/datasets/{nuscenes,lyft,waymo,custom}/ — all
are infos-pkl driven; the SC variants swap the raw cloud for the
SEE-completed .pcd (sc_*_dataset.py). Evaluation uses the KITTI protocol
after the standard lidar->camera-format annotation transform
(kitti/kitti_utils.py:transform_annotations_to_kitti_format), or with
EVAL_METRIC the devkit-free nuScenes, Lyft or Waymo metric.

Every evaluation scores the predictions against the ground truth of the
frames predicted: each prediction's ``frame_id`` (what
``generate_prediction_dicts`` writes: the info's ``lidar_idx``, else its
index) picks its info. The JAX package pairs the predictions with every
info by position, so with fewer frames predicted than the split holds
(``--max_frames``) it scores the wrong frames or raises. ``__getitem__``'s
``frame_id`` is JAX's (``lidar_idx``, else the info's ``token``, else the
index), which differs from the predictions' on nuScenes and Lyft.
"""
from __future__ import annotations

import copy
import os
import pickle
import zlib

import numpy as np

from ..geom.pcd_io import read_pcd
from .dataset import DatasetTemplate
from .kitti.eval import get_official_eval_result


def transform_annotations_to_kitti_format(annos, map_name_to_kitti,
                                          info_with_fakelidar: bool = False):
    """lidar-frame annos -> KITTI camera-format fields (kitti_utils.py:5-49)."""
    for anno in annos:
        if "name" not in anno:
            anno["name"] = anno.pop("gt_names")
        anno["name"] = np.array([map_name_to_kitti.get(n, n)
                                 for n in anno["name"]])
        n = len(anno["name"])
        anno["bbox"] = np.zeros((n, 4))
        anno["bbox"][:, 2:4] = 50
        anno["truncated"] = np.zeros(n)
        anno["occluded"] = np.zeros(n)
        boxes = anno.get("boxes_lidar", anno.get("gt_boxes_lidar",
                                                 anno.get("gt_boxes")))
        boxes = np.array(boxes, np.float64, copy=True).reshape(-1, boxes.shape[-1]) \
            if boxes is not None and len(boxes) else np.zeros((0, 7))
        if len(boxes):
            boxes[:, 2] -= boxes[:, 5] / 2
            anno["location"] = np.stack(
                [-boxes[:, 1], -boxes[:, 2], boxes[:, 0]], axis=1)
            anno["dimensions"] = boxes[:, [3, 5, 4]]  # lwh -> lhw
            anno["rotation_y"] = -boxes[:, 6] - np.pi / 2.0
            anno["alpha"] = -np.arctan2(-boxes[:, 1], boxes[:, 0]) \
                + anno["rotation_y"]
        else:
            anno["location"] = anno["dimensions"] = np.zeros((0, 3))
            anno["rotation_y"] = anno["alpha"] = np.zeros(0)
    return annos


class _InfosDataset(DatasetTemplate):
    """Shared infos-pkl machinery for nuScenes/Waymo/Custom."""

    def __init__(self, dataset_cfg, class_names, training, root_path=None, **kw):
        super().__init__(dataset_cfg, class_names, training, root_path, **kw)
        self.infos = []
        split_key = "train" if training else "test"
        for p in dataset_cfg.get("INFO_PATH", {}).get(split_key, []):
            full = p if os.path.isabs(p) else os.path.join(self.root_path, p)
            if os.path.exists(full):
                with open(full, "rb") as f:
                    self.infos.extend(pickle.load(f))
        interval = dataset_cfg.get("SAMPLED_INTERVAL", {})
        step = int(interval.get(split_key, 1)) if isinstance(interval, dict) else 1
        if step > 1:
            self.infos = self.infos[::step]

    def __len__(self):
        return len(self.infos)

    # subclasses: get_lidar(info), gt fields
    def gt_of(self, info):
        if "annos" in info:
            a = info["annos"]
            boxes = a.get("gt_boxes_lidar")
            names = a.get("name")
        else:
            boxes = info.get("gt_boxes")
            names = info.get("gt_names")
        if boxes is None:
            return None, None
        boxes = np.asarray(boxes, np.float32)
        return boxes[:, :7] if boxes.size else boxes.reshape(-1, 7), \
            np.asarray(names)

    def prediction_frame_id(self, index: int) -> str:
        """The frame_id ``generate_prediction_dicts`` writes for info
        ``index``: its ``lidar_idx``, else the index."""
        return str(self.infos[index].get("point_cloud", {}).get("lidar_idx", index))

    def infos_of(self, det_annos) -> list:
        """The infos of the frames predicted, in the predictions' order (a
        prediction without a frame_id raises a KeyError)."""
        by_id = {self.prediction_frame_id(k): info for k, info in enumerate(self.infos)}
        return [by_id[d["frame_id"]] for d in det_annos]

    def __getitem__(self, index):
        info = self.infos[index]
        points = self.get_lidar(info)
        boxes, names = self.gt_of(info)
        out = self.prepare_frame(points, boxes, names, rng_seed=index)
        out["frame_id"] = str(info.get("point_cloud", {}).get(
            "lidar_idx", info.get("token", index)))
        return out

    # ---------------- evaluation (KITTI-protocol over lidar boxes) --------
    def _kitti_protocol_eval(self, det_annos, class_names, name_map=None, device="cuda"):
        if not self.infos or ("annos" not in self.infos[0]
                              and "gt_boxes" not in self.infos[0]):
            return None, {}
        if name_map is None:
            name_map = {c: c.capitalize() if c.islower() else c
                        for c in list(class_names) + ["car"]}
        gt_annos = []
        for info in self.infos_of(det_annos):
            a = copy.deepcopy(info.get("annos", {
                "name": np.asarray(info.get("gt_names", [])),
                "gt_boxes_lidar": np.asarray(info.get("gt_boxes",
                                                      np.zeros((0, 7))))}))
            if self.min_points_of_gt and "num_points_in_gt" in a:
                keep = a["num_points_in_gt"] >= self.min_points_of_gt
                for k in list(a.keys()):
                    v = a[k]
                    if isinstance(v, np.ndarray) and len(v) == len(keep):
                        a[k] = v[keep]
            gt_annos.append(a)
        det = copy.deepcopy(det_annos)
        for d in det:
            d["boxes_lidar"] = np.asarray(d["pred_boxes"]) if "pred_boxes" in d \
                else d.get("boxes_lidar")
            if "name" not in d:
                d["name"] = np.array(class_names)[
                    np.asarray(d["pred_labels"], int) - 1] if len(
                        d.get("pred_labels", [])) else np.array([])
            if "score" not in d:
                d["score"] = np.asarray(d.get("pred_scores", []))
        transform_annotations_to_kitti_format(det, name_map)
        transform_annotations_to_kitti_format(
            gt_annos, name_map,
            info_with_fakelidar=self.dataset_cfg.get("INFO_WITH_FAKELIDAR", False))
        # order-preserving dedupe: a many-to-one map (Lyft bicycle +
        # motorcycle -> Cyclist) must score the merged pool once
        classes = tuple(dict.fromkeys(name_map[c] for c in class_names))
        return get_official_eval_result(gt_annos, det, classes=classes, device=device)

    def evaluation(self, det_annos, class_names, device="cuda", **kw):
        return self._kitti_protocol_eval(det_annos, class_names, device=device)

    def _metric_annos(self, det_annos, class_names):
        """-> (the predicted frames' ground truth as the native metrics read
        it, the predictions with boxes_lidar, name and score)."""
        gt_annos = [info.get("annos", {
            "name": np.asarray(info.get("gt_names", [])),
            "gt_boxes_lidar": np.asarray(info.get("gt_boxes", np.zeros((0, 7))))})
            for info in self.infos_of(det_annos)]
        det = copy.deepcopy(det_annos)
        for d in det:
            if "boxes_lidar" not in d and "pred_boxes" in d:
                d["boxes_lidar"] = np.asarray(d["pred_boxes"])
            if "name" not in d:
                d["name"] = np.array(class_names)[
                    np.asarray(d["pred_labels"], int) - 1] if len(
                        d.get("pred_labels", [])) else np.array([])
            if "score" not in d:
                d["score"] = np.asarray(d.get("pred_scores", []))
        return gt_annos, det

    def generate_prediction_dicts(self, frame_indices, pred_dicts, class_names,
                                  output_path=None, device=None):
        """Lidar-frame predictions a frame, keyed by
        ``prediction_frame_id``; ``device`` is taken for the evaluation
        loop's call and unused (the boxes stay on the host)."""
        annos = []
        for fi, box_dict in zip(frame_indices, pred_dicts):
            boxes = np.asarray(box_dict["pred_boxes"], np.float64)
            if self.shift_coor is not None and len(boxes):
                boxes = boxes.copy()
                boxes[:, :3] -= np.asarray(self.shift_coor)
            labels = np.asarray(box_dict["pred_labels"], int)
            annos.append({
                "boxes_lidar": boxes,
                "name": np.array(class_names)[labels - 1] if len(labels)
                else np.array([]),
                "score": np.asarray(box_dict["pred_scores"], np.float64),
                "pred_labels": labels,
                "frame_id": self.prediction_frame_id(fi),
            })
        return annos


class CustomDataset(_InfosDataset):
    """Baraja Spectrum-Scan dataset (custom_dataset.py): test/pcd/*.pcd +
    json calib; the multi-target-DA evaluation target."""

    def get_lidar(self, info) -> np.ndarray:
        idx = info["point_cloud"]["lidar_idx"]
        return read_pcd(os.path.join(self.root_path, "test", "pcd", f"{idx}.pcd"))


class SCCustomDataset(CustomDataset):
    def get_lidar(self, info) -> np.ndarray:
        rel = info.get("completed_lidar_path")
        if rel is None:
            tag = self.dataset_cfg.get("PROCESSED_DATA_TAG", "vcn")
            idx = info["point_cloud"]["lidar_idx"]
            rel = os.path.join(tag, f"{idx}.pcd")
        path = rel if os.path.isabs(rel) else os.path.join(self.root_path,
                                                           "test", rel)
        return read_pcd(path)


class NuScenesDataset(_InfosDataset):
    """nuScenes (nuscenes_dataset.py): infos carry gt_boxes/gt_names and a
    lidar_path; MAX_SWEEPS aggregates past sweeps into the frame cloud with
    a time-lag channel (get_lidar_with_sweeps, nuscenes_dataset.py:93-110);
    BALANCED_RESAMPLING applies CBGS class-balanced info resampling at train
    time (:40-65). EVAL_METRIC 'nuscenes' runs the native NDS evaluator
    (nuscenes_eval.py, devkit-free), 'kitti' the KITTI protocol (the
    reference's DA configs' choice, nuscenes_dataset.py:334-351)."""

    def __init__(self, dataset_cfg, class_names, training, root_path=None, **kw):
        super().__init__(dataset_cfg, class_names, training, root_path, **kw)
        if training and dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self.balanced_infos_resampling(self.infos)

    def balanced_infos_resampling(self, infos, rng=None):
        """CBGS (arXiv 1908.09492): duplicate infos so every class's frame
        share approaches 1/num_classes (nuscenes_dataset.py:40-65)."""
        if not self.class_names or not infos:
            return infos
        rng = rng or np.random.RandomState(
            int(self.dataset_cfg.get("RESAMPLING_SEED", 0)))
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            names = info.get("gt_names")
            if names is None:
                names = info.get("annos", {}).get("name", [])
            for name in set(np.asarray(names).tolist()):
                if name in cls_infos:
                    cls_infos[name].append(info)
        duplicated = sum(len(v) for v in cls_infos.values())
        if duplicated == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled = []
        for v in cls_infos.values():
            if not v:
                continue
            ratio = frac / (len(v) / duplicated)
            sampled += [v[i] for i in rng.choice(len(v),
                                                 int(len(v) * ratio))]
        return sampled or infos

    def _read_bin5(self, rel) -> np.ndarray:
        path = rel if os.path.isabs(rel) else os.path.join(self.root_path, rel)
        return np.fromfile(path, dtype=np.float32).reshape(-1, 5)[:, :4]

    def get_sweep(self, sweep_info):
        """One past sweep -> (points in ref frame, time lags)
        (nuscenes_dataset.py:77-91): drop ego-radius points, apply the
        precomputed relative transform."""
        pts = self._read_bin5(sweep_info["lidar_path"])
        keep = ~((np.abs(pts[:, 0]) < 1.0) & (np.abs(pts[:, 1]) < 1.0))
        pts = pts[keep]
        tm = sweep_info.get("transform_matrix")
        if tm is not None:
            hom = np.hstack([pts[:, :3], np.ones((len(pts), 1), pts.dtype)])
            pts = np.hstack([(hom @ np.asarray(tm, np.float32).T)[:, :3],
                             pts[:, 3:4]])
        times = np.full((len(pts), 1), sweep_info["time_lag"], pts.dtype)
        return pts, times

    def get_lidar(self, info) -> np.ndarray:
        points = self._read_bin5(info["lidar_path"])
        max_sweeps = int(self.dataset_cfg.get("MAX_SWEEPS", 1))
        sweeps = info.get("sweeps", [])
        if max_sweeps <= 1 or not sweeps:
            if self._wants_timestamp():
                return np.hstack([points,
                                  np.zeros((len(points), 1), points.dtype)])
            return points
        pts_list = [points]
        times = [np.zeros((len(points), 1), points.dtype)]
        # per-sample seed (token hash): varied ACROSS frames like the
        # reference's np.random.choice (nuscenes_dataset.py:97) but
        # reproducible per frame — a process-global stateful rng would
        # make eval sweep subsets depend on iteration order and replay
        # identically in every forked worker. set_epoch() folds the
        # epoch in so training still sees fresh subsets per epoch.
        token = str(info.get("token", info.get("lidar_path", "")))
        seed = (zlib.crc32(token.encode())        # str hash() is salted
                ^ (0x9E3779B9 * (getattr(self, "_epoch", 0) + 1))
                ) & 0x7FFFFFFF
        rng = np.random.RandomState(seed)
        for k in rng.choice(
                len(sweeps), min(max_sweeps - 1, len(sweeps)), replace=False):
            p, t = self.get_sweep(sweeps[k])
            pts_list.append(p)
            times.append(t)
        merged = np.vstack(pts_list)
        if not self._wants_timestamp():
            return merged
        return np.hstack([merged, np.vstack(times).astype(points.dtype)])

    def _wants_timestamp(self) -> bool:
        enc = self.dataset_cfg.get("POINT_FEATURE_ENCODING", {})
        return "timestamp" in list(enc.get("used_feature_list", []))

    def evaluation(self, det_annos, class_names, device="cuda", **kw):
        if self.dataset_cfg.get("EVAL_METRIC", "kitti") == "nuscenes":
            from .nuscenes_eval import nuscenes_eval

            gt_annos, det = self._metric_annos(det_annos, class_names)
            return nuscenes_eval(det, gt_annos, list(class_names))
        return self._kitti_protocol_eval(det_annos, class_names, device=device)


class SCNuScenesDataset(NuScenesDataset):
    def get_lidar(self, info) -> np.ndarray:
        rel = info.get("completed_lidar_path")
        if rel is None:
            tag = self.dataset_cfg.get("PROCESSED_DATA_TAG", "vcn")
            token = info.get("token", "")
            rel = os.path.join(tag, f"{token}.pcd")
        path = rel if os.path.isabs(rel) else os.path.join(self.root_path, rel)
        return read_pcd(path)


class LyftDataset(NuScenesDataset):
    """Lyft Level-5 (lyft_dataset.py:13-118): infos carry gt_boxes/gt_names
    + lidar_path + sweeps, exactly the nuScenes layout (the Lyft release is
    a nuScenes-format fork), with 5-float .bin points and the same
    remove-ego + transform sweep aggregation — so the loader is inherited.
    EVAL_METRIC 'lyft' runs the native class-average 3D-IoU mAP
    (lyft_eval.py, devkit-free; thresholds EVAL_LYFT_IOU_LIST,
    lyft_dataset.py:179-205), 'kitti' the KITTI protocol
    (lyft_dataset.py:153-177 kitti_eval)."""

    #: lyft_dataset.py:154-160 map_name_to_kitti
    MAP_NAME_TO_KITTI = {"car": "Car", "pedestrian": "Pedestrian",
                         "truck": "Truck", "bicycle": "Cyclist",
                         "motorcycle": "Cyclist"}

    def evaluation(self, det_annos, class_names, device="cuda", **kw):
        metric = kw.get("eval_metric",
                        self.dataset_cfg.get("EVAL_METRIC", "lyft"))
        if metric == "lyft":
            from .lyft_eval import lyft_eval

            gt_annos, det = self._metric_annos(det_annos, class_names)
            return lyft_eval(det, gt_annos, list(class_names),
                             iou_thresholds=self.dataset_cfg.get(
                                 "EVAL_LYFT_IOU_LIST"))
        # KITTI protocol with the reference's Lyft->KITTI name merge
        # (lyft_dataset.py:154-160: bicycle + motorcycle -> Cyclist)
        name_map = {c: self.MAP_NAME_TO_KITTI.get(
            c, c.capitalize() if c.islower() else c)
            for c in list(class_names) + ["car"]}
        return self._kitti_protocol_eval(det_annos, class_names,
                                         name_map=name_map, device=device)


class SCLyftDataset(LyftDataset):
    """Surface-completed Lyft variant (same pattern as the other SC*
    datasets; the reference ships no sc_lyft, provided for symmetry)."""

    def get_lidar(self, info) -> np.ndarray:
        rel = info.get("completed_lidar_path")
        if rel is None:
            tag = self.dataset_cfg.get("PROCESSED_DATA_TAG", "vcn")
            token = info.get("token", "")
            rel = os.path.join(tag, f"{token}.pcd")
        path = rel if os.path.isabs(rel) else os.path.join(self.root_path, rel)
        return read_pcd(path)


class WaymoDataset(_InfosDataset):
    """Waymo (waymo_dataset.py): per-sequence npy point files. EVAL_METRIC
    'waymo' runs the native AP/APH L1/L2 evaluator (waymo_eval.py,
    devkit/TF-free), 'kitti' the KITTI protocol (waymo_dataset.py:372-388
    offers the same choice) with the reference's Waymo -> KITTI names
    (Vehicle -> Car: the JAX package keeps Vehicle, which the KITTI
    protocol has no overlap threshold for, and raises KeyError)."""

    #: waymo_dataset.py:376-382 map_name_to_kitti
    MAP_NAME_TO_KITTI = {"Vehicle": "Car", "Pedestrian": "Pedestrian", "Cyclist": "Cyclist"}

    def get_lidar(self, info) -> np.ndarray:
        pc = info["point_cloud"]
        seq = pc["lidar_sequence"]
        sample = pc["sample_idx"]
        # shared-memory cache across loader workers (waymo_dataset.py:77-105)
        if self.dataset_cfg.get("USE_SHARED_MEMORY", False):
            from ..utils.shm_cache import sa_attach, sa_create, sa_exists

            tag = f"{seq}__{sample}"
            if sa_exists(tag):
                return sa_attach(tag)[:, :4].astype(np.float32)
        path = os.path.join(self.root_path, "waymo_processed_data", seq,
                            f"{sample:04d}.npy")
        pts = np.load(path)
        if self.dataset_cfg.get("USE_SHARED_MEMORY", False):
            sa_create(f"{seq}__{sample}", pts)
        return pts[:, :4].astype(np.float32)

    def evaluation(self, det_annos, class_names, device="cuda", **kw):
        if self.dataset_cfg.get("EVAL_METRIC", "kitti") == "waymo":
            from .waymo_eval import waymo_eval

            _, det = self._metric_annos(det_annos, class_names)
            gt_annos = [info.get("annos", {}) for info in self.infos_of(det_annos)]
            return waymo_eval(det, gt_annos, list(class_names), device=device)
        name_map = {c: self.MAP_NAME_TO_KITTI.get(c, c.capitalize() if c.islower() else c)
                    for c in list(class_names) + ["car"]}
        return self._kitti_protocol_eval(det_annos, class_names, name_map=name_map,
                                         device=device)


class SCWaymoDataset(WaymoDataset):
    def get_lidar(self, info) -> np.ndarray:
        rel = info.get("completed_lidar_path")
        if rel is None:
            tag = self.dataset_cfg.get("PROCESSED_DATA_TAG", "vcn")
            pc = info["point_cloud"]
            rel = os.path.join(tag, pc["lidar_sequence"],
                               f"{pc['sample_idx']:04d}.pcd")
        path = rel if os.path.isabs(rel) else os.path.join(self.root_path, rel)
        return read_pcd(path)
