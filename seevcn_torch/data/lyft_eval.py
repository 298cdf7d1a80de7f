"""Native Lyft Level-5 detection mAP, devkit-free (port of
seevcn_tpu/data/lyft_eval.py, host numpy, copied).

Reference: detector3d/pcdet/datasets/lyft/lyft_mAP_eval/lyft_eval.py
(Box3D:57-212, recall_precision:268-342, get_average_precisions:345-404)
plus the result formatting in lyft_utils.format_lyft_results. The
reference evaluates SDK ``Box3D`` objects in the *global* frame after
converting each 7-dof lidar prediction through the ego pose
(lyft_utils.convert_det_to_lyft_format / lidar_lyft_box_to_global).

This implementation evaluates the same protocol directly on lidar-frame
``[x y z dx dy dz heading]`` boxes:

  * 3D IoU = (rotated BEV polygon intersection) x (z-extent overlap) /
    union — exactly Box3D.get_iou (the reference's ground-plane polygon
    assumption holds identically in the lidar frame; a rigid ego-pose
    transform preserves every volume/intersection, so skipping the
    global-frame round-trip is a no-op on the metric, modulo ego
    roll/pitch which the reference's ground-projection drops anyway).
  * matching (recall_precision): predictions per class sorted by
    descending score; each matches its argmax-IoU ground truth of the
    same class in the same frame; it is a TP at threshold t iff
    max IoU > t and that gt is unmatched at t, else FP (no second-best
    re-matching — faithful to the reference).
  * AP (get_ap): sentinel-padded precision envelope integrated over
    recall change points; per-class AP = mean over the IoU threshold
    list (EVAL_LYFT_IOU_LIST, default [0.5 .. 0.95] step 0.05);
    mAP = mean over classes (classes with no predictions score 0).
"""
from __future__ import annotations

import numpy as np


def _box_corners_bev(box: np.ndarray) -> np.ndarray:
    """(7,) box -> (4, 2) BEV corner polygon (ccw)."""
    c, s = np.cos(box[6]), np.sin(box[6])
    dx, dy = box[3] / 2, box[4] / 2
    local = np.array([[dx, dy], [-dx, dy], [-dx, -dy], [dx, -dy]])
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + box[:2]


def _polygon_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip ``subject`` by convex ``clip`` polygon."""
    out = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        inp, out = out, []
        if not inp:
            break

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0

        for j, cur in enumerate(inp):
            prev = inp[j - 1]
            cur_in, prev_in = inside(cur), inside(prev)
            if cur_in:
                if not prev_in:
                    out.append(_intersect(prev, cur, a, b))
                out.append(cur)
            elif prev_in:
                out.append(_intersect(prev, cur, a, b))
    return np.asarray(out) if out else np.zeros((0, 2))


def _intersect(p1, p2, a, b):
    d1, d2 = p2 - p1, b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return p2
    t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
    return p1 + t * d1


def iou_3d(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Box3D.get_iou: BEV polygon intersection x height overlap / union."""
    pa = _box_corners_bev(box_a)
    pb = _box_corners_bev(box_b)
    inter_poly = _clip_polygon(pa, pb)
    area = _polygon_area(inter_poly) if len(inter_poly) >= 3 else 0.0
    za = (box_a[2] - box_a[5] / 2, box_a[2] + box_a[5] / 2)
    zb = (box_b[2] - box_b[5] / 2, box_b[2] + box_b[5] / 2)
    hz = max(0.0, min(za[1], zb[1]) - max(za[0], zb[0]))
    inter = area * hz
    vol_a = float(np.prod(box_a[3:6]))
    vol_b = float(np.prod(box_b[3:6]))
    return float(np.clip(inter / max(vol_a + vol_b - inter, 1e-9), 0, 1))


def _get_ap(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """lyft_eval.get_ap: envelope + sum over recall change points."""
    recalls = np.concatenate(([0.0], recalls, [1.0]))
    precisions = np.concatenate(([0.0], precisions, [0.0]))
    for i in range(precisions.size - 1, 0, -1):
        precisions[i - 1] = max(precisions[i - 1], precisions[i])
    idx = np.where(recalls[1:] != recalls[:-1])[0]
    return float(np.sum((recalls[idx + 1] - recalls[idx]) *
                        precisions[idx + 1]))


def _recall_precision(gt, predictions, iou_thresholds):
    """One class. gt: [(frame, (7,) box)], predictions:
    [(score, frame, (7,) box)] -> ap per threshold
    (lyft_eval.recall_precision:268-342)."""
    num_gts = len(gt)
    if num_gts == 0:
        return [-1.0] * len(iou_thresholds)
    gts_by_frame: dict = {}
    for frame, box in gt:
        gts_by_frame.setdefault(frame, []).append(box)
    gts_by_frame = {f: np.asarray(b) for f, b in gts_by_frame.items()}
    checked = {f: np.zeros((len(b), len(iou_thresholds)), bool)
               for f, b in gts_by_frame.items()}

    predictions = sorted(predictions, key=lambda d: -d[0])
    tp = np.zeros((len(predictions), len(iou_thresholds)))
    fp = np.zeros((len(predictions), len(iou_thresholds)))
    for pi, (score, frame, box) in enumerate(predictions):
        gts = gts_by_frame.get(frame)
        max_overlap, jmax = -np.inf, -1
        if gts is not None and len(gts):
            overlaps = [iou_3d(box, g) for g in gts]
            jmax = int(np.argmax(overlaps))
            max_overlap = overlaps[jmax]
        for ti, th in enumerate(iou_thresholds):
            if max_overlap > th:
                if not checked[frame][jmax, ti]:
                    tp[pi, ti] = 1.0
                    checked[frame][jmax, ti] = True
                else:
                    fp[pi, ti] = 1.0
            else:
                fp[pi, ti] = 1.0
    fp = np.cumsum(fp, axis=0)
    tp = np.cumsum(tp, axis=0)
    recalls = tp / float(num_gts)
    precisions = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return [_get_ap(recalls[:, i], precisions[:, i])
            for i in range(len(iou_thresholds))]


DEFAULT_IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def lyft_eval(det_annos, gt_annos, class_names,
              iou_thresholds=None):
    """det_annos: list of {boxes_lidar (N, 7), name (N,), score (N,),
    frame_id}; gt_annos: list of {gt_boxes_lidar|gt_boxes (M, 7),
    name|gt_names (M,)} aligned by list position (frame identity follows
    the list index, like merge order in eval_utils). Returns
    (report string, {class/mAP: ap}).
    """
    iou_thresholds = list(iou_thresholds or DEFAULT_IOU_THRESHOLDS)
    gt_by_class: dict = {c: [] for c in class_names}
    det_by_class: dict = {c: [] for c in class_names}
    for frame, g in enumerate(gt_annos):
        boxes = g.get("gt_boxes_lidar", g.get("gt_boxes"))
        names = g.get("name", g.get("gt_names"))
        if boxes is None:
            continue
        boxes = np.asarray(boxes, np.float64).reshape(-1, boxes.shape[-1]
                                                      if np.ndim(boxes) > 1
                                                      else 7)
        for b, n in zip(boxes, np.asarray(names)):
            if n in gt_by_class:
                gt_by_class[n].append((frame, b[:7]))
    for frame, d in enumerate(det_annos):
        boxes = np.asarray(d.get("boxes_lidar",
                                 d.get("pred_boxes", np.zeros((0, 7)))),
                           np.float64)
        names = np.asarray(d.get("name", []))
        scores = np.asarray(d.get("score", d.get("pred_scores", [])),
                            np.float64)
        for b, n, s in zip(boxes, names, scores):
            if n in det_by_class:
                det_by_class[n].append((float(s), frame, b[:7]))

    aps = {}
    for cls in class_names:
        if det_by_class[cls]:
            ap_list = _recall_precision(gt_by_class[cls], det_by_class[cls],
                                        iou_thresholds)
            aps[cls] = float(np.mean([a for a in ap_list if a >= 0])) \
                if any(a >= 0 for a in ap_list) else 0.0
        else:
            aps[cls] = 0.0

    mAP = float(np.mean([aps[c] for c in class_names]))
    lines = [f"Lyft mAP@{iou_thresholds[0]:.2f}:"
             f"{iou_thresholds[-1]:.2f} (class-average 3D IoU AP)"]
    result = {}
    for c in class_names:
        lines.append(f"{c}: {aps[c]:.4f}")
        result[c] = aps[c]
    lines.append(f"mAP: {mAP:.4f}")
    result["mAP"] = mAP
    return "\n".join(lines), result
