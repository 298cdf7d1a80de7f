"""KITTI's official AP evaluation (R40), host-side numpy (port of
seevcn_tpu/data/kitti/eval.py; the protocol of the reference's numba
evaluator, kitti_object_eval_python/eval.py:30-747): difficulty buckets
(minimum box height, maximum occlusion and truncation), the similar-class
ignores (Van for Car, Person_sitting for Pedestrian), don't-care regions,
the score-threshold sweep at 41 recall positions, greedy matching frame by
frame, and AP_R40, the mean precision over recall 1/40..40/40.

The rotated BEV and 3D IoU matrices are the port's ``ops/iou3d.py``
(``boxes_iou_bev``, ``boxes_iou3d``) on ``device``, a part of frames a call.

Boxes: the annos are dicts with 'name', 'bbox' (N, 4 image), 'location'
(N, 3 rect), 'dimensions' (N, 3: l, h, w), 'rotation_y', 'alpha',
'occluded', 'truncated' and for detections 'score': the schema of the
reference's generate_prediction_dicts and get_label_annos.
"""
from __future__ import annotations

import numpy as np
import torch

from ... import resolve_device
from ...ops.iou3d import boxes_iou3d, boxes_iou_bev

CLASS_NAMES = ["Car", "Pedestrian", "Cyclist", "Van", "Person_sitting", "Truck"]
MIN_HEIGHT = [40, 25, 25]
MAX_OCCLUSION = [0, 1, 2]
MAX_TRUNCATION = [0.15, 0.3, 0.5]
N_SAMPLE_PTS = 41


def _similar_classes(cls: str):
    return {"Car": ["Van"], "Pedestrian": ["Person_sitting"]}.get(cls, [])


def clean_data(gt_anno, dt_anno, current_class: str, difficulty: int):
    """Returns (num_valid_gt, ignored_gt, ignored_dt, dc_bboxes)."""
    ignored_gt, dc_bboxes = [], []
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        name = gt_anno["name"][i]
        height = gt_anno["bbox"][i, 3] - gt_anno["bbox"][i, 1]
        if name == current_class:
            valid_class = 1
        elif name in _similar_classes(current_class):
            valid_class = 0
        else:
            valid_class = -1
        ignore = (gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
                  or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
                  or height <= MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if name == "DontCare":
            dc_bboxes.append(gt_anno["bbox"][i])

    ignored_dt = []
    for i in range(len(dt_anno["name"])):
        height = dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1]
        if dt_anno["name"][i] == current_class:
            valid_class = 1
        else:
            valid_class = -1
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)

    return (num_valid_gt, np.array(ignored_gt, np.int32),
            np.array(ignored_dt, np.int32),
            np.array(dc_bboxes).reshape(-1, 4))


def image_box_overlap(boxes, qboxes, criterion=-1):
    """2D image IoU (or intersection-over-area for dontcare, criterion=0)."""
    n, k = len(boxes), len(qboxes)
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float64)
    x1 = np.maximum(boxes[:, None, 0], qboxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], qboxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], qboxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], qboxes[None, :, 3])
    iw = np.clip(x2 - x1, 0, None)
    ih = np.clip(y2 - y1, 0, None)
    inter = iw * ih
    area_a = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    area_b = (qboxes[:, 2] - qboxes[:, 0]) * (qboxes[:, 3] - qboxes[:, 1])
    if criterion == 0:      # intersection over dt area (dontcare)
        denom = area_a[:, None] + 0 * area_b[None, :]
    else:
        denom = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(denom, 1e-9)


def _camera_to_lidar_like(annos):
    """KITTI camera boxes (loc rect, dims l,h,w, ry) -> pseudo-lidar
    (x=z_c, y=-x_c, z=-y_c + h/2) boxes for BEV/3D IoU. Any fixed rigid map
    works since IoU is invariant; this matches the standard rect->velo
    orientation so headings stay consistent."""
    loc = annos["location"]
    dims = annos["dimensions"]  # l, h, w
    ry = annos["rotation_y"]
    if len(loc) == 0:
        return np.zeros((0, 7))
    x, y, z = loc[:, 0], loc[:, 1], loc[:, 2]
    l, h, w = dims[:, 0], dims[:, 1], dims[:, 2]
    return np.stack([z, -x, -(y - h / 2), l, w, h, -ry - np.pi / 2], axis=1)


def _bev_3d_overlaps(gt_annos, dt_annos, metric: str, part_size: int = 3000,
                     device="cuda"):
    """Per-frame (num_dt, num_gt) IoU matrices, the frames joined into parts
    of up to ``part_size`` boxes a side with one IoU call a part (the
    reference's calculate_iou_partly:340-415), each frame's block sliced out."""
    dev = resolve_device(device)
    fn = boxes_iou_bev if metric == "bev" else boxes_iou3d
    gt_boxes = [_camera_to_lidar_like(g) for g in gt_annos]
    dt_boxes = [_camera_to_lidar_like(d) for d in dt_annos]

    out = [None] * len(gt_annos)
    start = 0
    while start < len(gt_annos):
        stop, ng, nd = start, 0, 0
        while stop < len(gt_annos) and (
                max(ng + len(gt_boxes[stop]), nd + len(dt_boxes[stop]))
                <= part_size or stop == start):
            ng += len(gt_boxes[stop])
            nd += len(dt_boxes[stop])
            stop += 1
        gb = np.concatenate([gt_boxes[f] for f in range(start, stop)]) \
            if ng else np.zeros((0, 7))
        db = np.concatenate([dt_boxes[f] for f in range(start, stop)]) \
            if nd else np.zeros((0, 7))
        if ng and nd:
            part = fn(torch.as_tensor(db, dtype=torch.float32, device=dev),
                      torch.as_tensor(gb, dtype=torch.float32, device=dev)
                      ).cpu().numpy().astype(np.float64)
        else:
            part = np.zeros((nd, ng))
        gi = di = 0
        for f in range(start, stop):
            g, d = len(gt_boxes[f]), len(dt_boxes[f])
            out[f] = part[di:di + d, gi:gi + g]
            gi += g
            di += d
        start = stop
    return out


def get_thresholds(scores: np.ndarray, num_gt: int):
    """41-point recall-sampled score thresholds (eval.py:get_thresholds)."""
    scores = np.sort(scores)[::-1]
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (N_SAMPLE_PTS - 1.0)
    return np.array(thresholds)


def compute_statistics(overlaps, gt_anno, dt_anno, ignored_gt, ignored_dt,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_aos=False):
    """Single-frame greedy matching (eval.py:compute_statistics_jit).

    overlaps: (num_dt, num_gt). Returns (tp, fp, fn, similarity,
    thresh_list of matched dt scores). This scalar transcription of the
    official protocol is the readable form of what fused_statistics
    vectorises, and runs the compute_fp=False threshold-collection pass,
    once per frame.
    """
    dt_scores = dt_anno["score"]
    num_dt, num_gt = len(ignored_dt), len(ignored_gt)
    assigned = np.zeros(num_dt, bool)
    ignored_threshold = np.zeros(num_dt, bool)
    if compute_fp:
        ignored_threshold = dt_scores < thresh

    NO_DETECTION = -10000000
    tp = fp = fn = 0
    similarity = 0.0
    thresholds, deltas = [], []
    for i in range(num_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(num_dt):
            if ignored_dt[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            score = dt_scores[j]
            if not compute_fp and overlap > min_overlap and score > valid_detection:
                det_idx = j
                valid_detection = score
            elif (compute_fp and overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and ignored_dt[j] == 0):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (compute_fp and overlap > min_overlap
                  and valid_detection == NO_DETECTION and ignored_dt[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True

        if valid_detection == NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DETECTION and (
                ignored_gt[i] == 1 or ignored_dt[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != NO_DETECTION:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                deltas.append(gt_anno["alpha"][i] - dt_anno["alpha"][det_idx])
            assigned[det_idx] = True

    if compute_fp:
        for j in range(num_dt):
            if not (assigned[j] or ignored_dt[j] == -1 or ignored_dt[j] == 1
                    or ignored_threshold[j]):
                fp += 1
        # discount fps inside dontcare regions (bbox metric)
        nstuff = 0
        if metric == "bbox" and len(dc_bboxes) > 0:
            dt_bboxes = dt_anno["bbox"]
            ov = image_box_overlap(dt_bboxes, dc_bboxes, criterion=0)
            for j in range(num_dt):
                if (assigned[j] or ignored_dt[j] == -1 or ignored_dt[j] == 1
                        or ignored_threshold[j]):
                    continue
                if (ov[j] > min_overlap).any():
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
        if compute_aos:
            # orientation similarity over tps, zeros for fps; -1 sentinel
            # when this frame/threshold has no dets (eval.py:265-272)
            similarity = float(np.sum((1.0 + np.cos(deltas)) / 2.0)) \
                if (tp > 0 or fp > 0) else -1.0

    return tp, fp, fn, similarity, np.array(thresholds)


def fused_statistics(overlaps, gt_anno, dt_anno, ignored_gt, ignored_dt,
                     dc_bboxes, metric, min_overlap, thresholds,
                     compute_aos=False):
    """All-threshold statistics for one frame, vectorized over thresholds.

    Replaces the reference's numba fused_compute_statistics (eval.py:291-339):
    the greedy gt loop stays sequential (assignment state is sequential),
    but every score threshold is processed as a batch row, so per-frame cost
    is O(num_gt) small vector ops instead of O(T * num_gt * num_dt) scalar
    ones. Returns (T, 4) [tp, fp, fn, similarity].
    """
    dt_scores = np.asarray(dt_anno["score"], np.float64)
    thr = np.asarray(thresholds, np.float64)
    T = len(thr)
    num_dt, num_gt = len(ignored_dt), len(ignored_gt)
    out = np.zeros((T, 4))
    ign_thr = dt_scores[None, :] < thr[:, None]          # (T, D)
    assigned = np.zeros((T, num_dt), bool)
    tp = np.zeros(T, np.int64)
    fn = np.zeros(T, np.int64)
    sim = np.zeros(T)
    rows = np.arange(T)
    not_ignored = (ignored_dt != -1)[None, :]
    is0 = ignored_dt == 0
    is1 = ignored_dt == 1
    if compute_aos:
        gt_alpha = np.asarray(gt_anno["alpha"], np.float64)
        dt_alpha = np.asarray(dt_anno["alpha"], np.float64)

    for i in range(num_gt):
        if ignored_gt[i] == -1 or num_dt == 0:
            if ignored_gt[i] == 0 and num_dt == 0:
                fn += 1
            continue
        ov_i = overlaps[:, i]
        elig = (~assigned) & (~ign_thr) & not_ignored \
            & (ov_i > min_overlap)[None, :]
        e0 = elig & is0[None, :]
        any0 = e0.any(axis=1)
        # best-overlap class det, first-max tie-break == reference's scan
        det0 = np.where(e0, ov_i[None, :], -1.0).argmax(axis=1)
        e1 = elig & is1[None, :]
        any1 = e1.any(axis=1)
        det1 = e1.argmax(axis=1)  # first eligible ignored det
        valid = any0 | any1
        det = np.where(any0, det0, det1)

        if ignored_gt[i] == 0:
            fn += ~valid
            tp_rows = valid & any0
            tp += tp_rows
            if compute_aos and tp_rows.any():
                sim += np.where(
                    tp_rows,
                    (1.0 + np.cos(gt_alpha[i] - dt_alpha[det])) / 2.0, 0.0)
        assigned[rows[valid], det[valid]] = True

    fp_mask = (~assigned) & is0[None, :] & (~ign_thr)
    fp = fp_mask.sum(axis=1)
    if metric == "bbox" and len(dc_bboxes) > 0 and num_dt:
        ov = image_box_overlap(dt_anno["bbox"], dc_bboxes, criterion=0)
        dc_hit = (ov > min_overlap).any(axis=1)
        fp -= (fp_mask & dc_hit[None, :]).sum(axis=1)

    out[:, 0] = tp
    out[:, 1] = fp
    out[:, 2] = fn
    # compute_statistics returns the -1 "no dets" sentinel, but the
    # reference's accumulator SKIPS it (`if similarity != -1`,
    # eval.py:333-334) — so the fused accumulation contributes sim (which is
    # 0 whenever tp == 0) unconditionally.
    out[:, 3] = sim if compute_aos else 0.0
    return out


def eval_class(gt_annos, dt_annos, current_class: str, difficulty: int,
               metric: str, min_overlap: float, compute_aos: bool = False,
               overlaps=None, device="cuda"):
    """-> dict(precision (41,), recall (41,), ap_r40, ap_r11[, aos_r40]).

    ``overlaps`` may be passed in to reuse the per-frame IoU matrices across
    difficulties/classes (the reference computes them once in eval_class's
    caller; get_official_eval_result below does the same).
    """
    assert metric in ("bbox", "bev", "3d")
    frames = len(gt_annos)
    rets = [clean_data(g, d, current_class, difficulty)
            for g, d in zip(gt_annos, dt_annos)]
    if overlaps is None:
        overlaps = compute_overlaps(gt_annos, dt_annos, metric, device)

    total_valid_gt = sum(r[0] for r in rets)
    all_thresh = []
    for f in range(frames):
        nv, ig, idt, dc = rets[f]
        _, _, _, _, th = compute_statistics(
            overlaps[f], gt_annos[f], dt_annos[f], ig, idt, dc, metric,
            min_overlap, compute_fp=False)
        all_thresh.append(th)
    all_thresh = np.concatenate(all_thresh) if all_thresh else np.zeros(0)
    if total_valid_gt == 0 or len(all_thresh) == 0:
        z = np.zeros(N_SAMPLE_PTS)
        out = {"precision": z, "recall": z, "ap_r40": 0.0, "ap_r11": 0.0}
        if compute_aos:
            out["aos"] = z
            out["aos_r40"] = 0.0
        return out

    thresholds = get_thresholds(all_thresh, total_valid_gt)
    pr = np.zeros((len(thresholds), 4))  # tp, fp, fn, similarity
    for f in range(frames):
        nv, ig, idt, dc = rets[f]
        pr += fused_statistics(
            overlaps[f], gt_annos[f], dt_annos[f], ig, idt, dc, metric,
            min_overlap, thresholds, compute_aos=compute_aos)

    precision = np.zeros(N_SAMPLE_PTS)
    recall = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    for t in range(len(thresholds)):
        precision[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 1], 1e-9)
        recall[t] = pr[t, 0] / max(pr[t, 0] + pr[t, 2], 1e-9)
        if compute_aos:
            aos[t] = pr[t, 3] / max(pr[t, 0] + pr[t, 1], 1e-9)
    # right-cummax (standard interpolation)
    for t in range(N_SAMPLE_PTS):
        precision[t] = precision[t:].max()
        recall[t] = recall[t:].max()
        if compute_aos:
            aos[t] = aos[t:].max()

    ap_r40 = sum(precision[1:41]) / 40 * 100
    ap_r11 = sum(precision[0:41:4]) / 11 * 100
    out = {"precision": precision, "recall": recall,
           "ap_r40": float(ap_r40), "ap_r11": float(ap_r11)}
    if compute_aos:
        out["aos"] = aos
        out["aos_r40"] = float(sum(aos[1:41]) / 40 * 100)
    return out


def compute_overlaps(gt_annos, dt_annos, metric: str, device="cuda"):
    """Per-frame (num_dt, num_gt) overlap matrices for one metric (the
    rotated ones on ``device``)."""
    if metric == "bbox":
        return [image_box_overlap(d["bbox"].reshape(-1, 4),
                                  g["bbox"].reshape(-1, 4))
                for g, d in zip(gt_annos, dt_annos)]
    return _bev_3d_overlaps(gt_annos, dt_annos, metric, device=device)


# default overlap thresholds (eval.py:639-660, overlap_0_7 table)
MIN_OVERLAPS = {
    "Car": {"bbox": 0.7, "bev": 0.7, "3d": 0.7},
    "Pedestrian": {"bbox": 0.5, "bev": 0.5, "3d": 0.5},
    "Cyclist": {"bbox": 0.5, "bev": 0.5, "3d": 0.5},
    "Van": {"bbox": 0.7, "bev": 0.7, "3d": 0.7},
    "Truck": {"bbox": 0.7, "bev": 0.7, "3d": 0.7},
    "Person_sitting": {"bbox": 0.5, "bev": 0.5, "3d": 0.5},
}


def get_official_eval_result(gt_annos, dt_annos, classes=("Car",), device="cuda"):
    """-> (report string, dict {class: {metric: {difficulty: ap_r40}}}).

    AOS is reported when the detections carry valid alphas, exactly like the
    reference gate (eval.py:668-674: any anno with alpha[0] != -10).
    """
    compute_aos = False
    for anno in dt_annos:
        if len(anno.get("alpha", [])) != 0:
            compute_aos = anno["alpha"][0] != -10
            break
    results = {}
    lines = []
    # one IoU pass per metric, shared across classes (the reference's
    # calculate_iou_partly runs once per metric in do_eval; recomputing
    # inside the class loop multiplies the device IoU work by num_classes)
    overlaps_by_metric = {m: compute_overlaps(gt_annos, dt_annos, m, device)
                          for m in ("bbox", "bev", "3d")}
    for cls in classes:
        results[cls] = {}
        for metric in ("bbox", "bev", "3d"):
            overlaps = overlaps_by_metric[metric]
            results[cls][metric] = {}
            want_aos = compute_aos and metric == "bbox"
            if want_aos:
                results[cls]["aos"] = {}
            aps, aoss = [], []
            for diff in (0, 1, 2):
                r = eval_class(gt_annos, dt_annos, cls, diff, metric,
                               MIN_OVERLAPS[cls][metric],
                               compute_aos=want_aos, overlaps=overlaps)
                results[cls][metric][diff] = r["ap_r40"]
                aps.append(r["ap_r40"])
                if want_aos:
                    results[cls]["aos"][diff] = r["aos_r40"]
                    aoss.append(r["aos_r40"])
            lines.append(f"{cls} AP_R40@{MIN_OVERLAPS[cls][metric]:.2f} "
                         f"({metric}): {aps[0]:.4f}, {aps[1]:.4f}, {aps[2]:.4f}")
            if want_aos:
                lines.append(f"{cls} AOS_R40: {aoss[0]:.4f}, {aoss[1]:.4f}, "
                             f"{aoss[2]:.4f}")
    return "\n".join(lines), results
