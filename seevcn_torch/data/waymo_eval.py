"""Native Waymo Open Dataset detection metrics, AP / APH at L1 / L2 (port of
seevcn_tpu/data/waymo_eval.py: host numpy, but for the IoU).

The reference shells out to TensorFlow + the waymo-open-dataset package
(pcdet/datasets/waymo/waymo_eval.py:23-178 builds a tf.graph around
detection_metrics.get_detection_metric_ops). This is a devkit-free numpy
re-implementation of the same protocol:

  * matching: greedy in descending score order on rotated 3D IoU
    (Vehicle 0.7, Pedestrian/Cyclist 0.5 — waymo_eval.py config).
  * difficulty: L2 = objects with <= 5 lidar points or labeled level 2,
    L1 = the rest; the L2 bucket ALSO contains L1 objects (Waymo evaluates
    L2 as "everything", L1 as the easy subset).
  * AP: 101-point interpolated precision integrated over recall.
  * APH: every true positive's contribution is weighted by
    min(|heading_err|, 2pi - |heading_err|) mapped to [0, 1] via
    1 - err / pi (the Waymo heading-accuracy weighting).

IoU matrices are computed on ``device`` by the port's ``ops.iou3d`` in f32
(one batched call per frame and class), the only part of the metric with
real FLOPs: on the card with a CUDA device, on the CPU with the CPU. An f32
IoU within rounding of 0.7 or 0.5 can match on one device and not on the
other (``near_threshold_pairs`` lists such pairs).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.iou3d import boxes_iou3d

IOU_THRESH = {"Vehicle": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5,
              "Sign": 0.5, "Car": 0.7}
N_RECALL_SAMPLES = 101


def _overlap_matrix(gt_boxes, dt_boxes, device="cuda"):
    if len(gt_boxes) == 0 or len(dt_boxes) == 0:
        return np.zeros((len(gt_boxes), len(dt_boxes)))
    return boxes_iou3d(torch.as_tensor(np.asarray(gt_boxes), dtype=torch.float32, device=device),
                       torch.as_tensor(np.asarray(dt_boxes), dtype=torch.float32, device=device)
                       ).cpu().numpy()


def _ap_from_pr(scores, tp_weight, is_tp, npos):
    """scores (D,), tp_weight (D,) in [0,1] (1 for AP, heading acc for APH)."""
    if npos == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(is_tp, float)[order]
    w = np.asarray(tp_weight, float)[order]
    cum_tp = np.cumsum(tp)
    cum_w = np.cumsum(tp * w)
    cum_fp = np.cumsum(1 - tp)
    rec = cum_tp / npos
    prec = np.where(cum_tp + cum_fp > 0, cum_w / (cum_tp + cum_fp), 0)
    rs = np.linspace(0, 1, N_RECALL_SAMPLES)
    p = np.interp(rs, rec, prec, right=0) if len(rec) else np.zeros_like(rs)
    # monotone non-increasing interpolation (standard AP smoothing)
    p = np.maximum.accumulate(p[::-1])[::-1]
    return float(p.mean())


def _match_frame(gt, dt, iou_thresh, device="cuda"):
    """Greedy score-ordered matching. Returns per-det (is_tp, heading_acc,
    matched_gt_idx)."""
    ov = _overlap_matrix(gt["boxes"], dt["boxes"], device)
    order = np.argsort(-dt["scores"])
    taken = np.zeros(len(gt["boxes"]), bool)
    is_tp = np.zeros(len(dt["boxes"]), bool)
    hacc = np.zeros(len(dt["boxes"]))
    match = np.full(len(dt["boxes"]), -1)
    for di in order:
        if not len(gt["boxes"]):
            break
        ious = ov[:, di].copy()
        ious[taken] = -1
        gi = int(np.argmax(ious))
        if ious[gi] >= iou_thresh:
            taken[gi] = True
            is_tp[di] = True
            match[di] = gi
            dh = abs(dt["boxes"][di][6] - gt["boxes"][gi][6])
            dh = min(dh % (2 * np.pi), 2 * np.pi - dh % (2 * np.pi))
            hacc[di] = max(0.0, 1.0 - dh / np.pi)
    return is_tp, hacc, match


def _class_frames(det_annos, gt_annos, cls):
    """-> [(gt boxes (G, 7), their levels, det boxes (D, 7), det scores)] of
    class ``cls``, a frame each (the frames paired by position)."""
    out = []
    for gt_a, dt_a in zip(gt_annos, det_annos):
        g_names = np.asarray(gt_a["name"])
        g_sel = g_names == cls
        g_all = np.asarray(gt_a.get("gt_boxes_lidar", np.zeros((0, 7))), np.float64)
        if g_all.ndim != 2:
            g_all = g_all.reshape(-1, 7)
        g_boxes = g_all[g_sel][:, :7]
        npts = np.asarray(gt_a.get("num_points_in_gt", np.full(len(g_names), 9999)))[g_sel]
        lvl = np.asarray(gt_a.get("difficulty", np.where(npts <= 5, 2, 1)))
        if lvl.shape != (g_sel.sum(),):
            lvl = np.asarray(gt_a["difficulty"])[g_sel]
        d_sel = np.asarray(dt_a["name"]) == cls
        d_all = np.asarray(dt_a["boxes_lidar"], np.float64)
        if d_all.ndim != 2:
            d_all = d_all.reshape(-1, 7)
        d_boxes = d_all[d_sel][:, :7] if d_sel.any() else np.zeros((0, 7))
        out.append((g_boxes, lvl, d_boxes, np.asarray(dt_a["score"], np.float64)[d_sel]))
    return out


def near_threshold_pairs(det_annos, gt_annos, class_names, device="cuda",
                         tol: float = 1e-6) -> list:
    """-> [(frame, class, gt index, det index, IoU)] of the pairs whose f32
    IoU on ``device`` lies within ``tol`` of their class's threshold: the
    matches that may differ between two devices."""
    out = []
    for cls in class_names:
        th = IOU_THRESH.get(cls, 0.5)
        for f, (g_boxes, _, d_boxes, _) in enumerate(_class_frames(det_annos, gt_annos, cls)):
            ov = _overlap_matrix(g_boxes, d_boxes, device)
            out += [(f, cls, int(gi), int(di), float(ov[gi, di]))
                    for gi, di in zip(*np.nonzero(np.abs(ov - th) <= tol))]
    return out


def waymo_eval(det_annos, gt_annos, class_names, device="cuda"):
    """det_annos: per-frame {'boxes_lidar' (D,7), 'name', 'score'};
    gt_annos: per-frame {'gt_boxes_lidar' (G,7), 'name',
    optional 'num_points_in_gt', optional 'difficulty'}; the IoUs on
    ``device``. Returns (report_str, result_dict)."""
    results = {}
    for cls in class_names:
        th = IOU_THRESH.get(cls, 0.5)
        per_level = {1: {"scores": [], "tp": [], "hacc": [], "npos": 0},
                     2: {"scores": [], "tp": [], "hacc": [], "npos": 0}}
        for g_boxes, lvl, d_boxes, d_scores in _class_frames(det_annos, gt_annos, cls):
            is_tp, hacc, match = _match_frame(
                {"boxes": g_boxes}, {"boxes": d_boxes, "scores": d_scores},
                th, device)
            for level in (1, 2):
                # L1 = easy subset; L2 = all objects (Waymo convention)
                g_in = (lvl <= level) if level == 1 else np.ones(len(g_boxes),
                                                                 bool)
                acc = per_level[level]
                acc["npos"] += int(g_in.sum())
                # dets matched to out-of-bucket gts are ignored (not FP);
                # bool arrays, so that a frame without detections of the
                # class holds (JAX's float empty array raises there)
                keep = ~is_tp | np.array(
                    [g_in[m] if m >= 0 else True for m in match], bool)
                acc["scores"].append(d_scores[keep])
                acc["tp"].append((is_tp & np.array(
                    [g_in[m] if m >= 0 else False for m in match], bool))[keep])
                acc["hacc"].append(hacc[keep])

        for level in (1, 2):
            acc = per_level[level]
            scores = np.concatenate(acc["scores"]) if acc["scores"] else \
                np.zeros(0)
            tp = np.concatenate(acc["tp"]) if acc["tp"] else np.zeros(0, bool)
            hacc = np.concatenate(acc["hacc"]) if acc["hacc"] else np.zeros(0)
            results[f"{cls}/L{level}/AP"] = _ap_from_pr(
                scores, np.ones_like(hacc), tp, acc["npos"])
            results[f"{cls}/L{level}/APH"] = _ap_from_pr(
                scores, hacc, tp, acc["npos"])

    lines = []
    for k in sorted(results):
        lines.append(f"{k}: {results[k]:.4f}")
    return "\n".join(lines), results
