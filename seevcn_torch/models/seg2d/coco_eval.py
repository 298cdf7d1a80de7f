"""COCO-protocol instance-segmentation AP, numpy (the port's own copy of
seevcn_tpu/models/seg2d/coco_eval.py).

Per-class mask (or box) AP with the COCO matching rules: score-sorted
greedy matching against unmatched ground truth at each IoU threshold,
101-point interpolated precision, and ``height_range`` buckets with COCO's
ignore semantics. The seg2d training CLI reports it.
"""
from __future__ import annotations

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (N, H, W) bool, b (M, H, W) bool -> (N, M) IoU."""
    a = a.reshape(a.shape[0], -1).astype(np.float32)
    b = b.reshape(b.shape[0], -1).astype(np.float32)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None] - inter
    return inter / np.maximum(union, 1e-6)


def box_iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-6)


def _ap_from_matches(scores, matched, n_gt):
    """COCO 101-point AP from per-detection (score, is-tp) pairs."""
    if n_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(matched, np.float32)[order]
    fp = 1.0 - tp
    tp_c, fp_c = np.cumsum(tp), np.cumsum(fp)
    recall = tp_c / n_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-6)
    # monotone envelope + 101-point interpolation
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    pts = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, pts, side="left")
    prec = np.where(idx < len(precision), precision[np.clip(idx, 0, len(precision) - 1)], 0.0)
    return float(prec.mean())


def evaluate_instances(predictions, ground_truths, iou_thresholds=None,
                       kind="mask", height_range=None):
    """predictions: list per image of dicts {masks (D,H,W) bool / boxes
    (D,4), scores (D,), labels (D,)}; ground_truths: same with valid masks
    only. Returns {"AP50": .., "AP": .., "per_thresh": {t: ap}} averaged
    over classes present in gt.

    ``height_range=(lo, hi)`` restricts evaluation to GT instances whose
    bbox pixel height is in [lo, hi) — the distance-bucket analog of the
    COCO area ranges (bbox height ~ 1/distance under perspective), with
    COCO's ignore semantics: out-of-bucket GTs are IGNORED, and a
    detection is dropped from scoring (neither TP nor FP) if it matches an
    ignored GT at the threshold, or is unmatched with its own height
    outside the bucket. Both dicts need "boxes" when a range is given.
    """
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    classes = sorted({int(c) for g in ground_truths for c in g["labels"]})
    per_thresh = {}
    for t in iou_thresholds:
        aps = []
        for c in classes:
            scores, matched, n_gt = [], [], 0
            for pred, gt in zip(predictions, ground_truths):
                g_cls = np.asarray(gt["labels"]) == c
                if height_range is not None:
                    gh = (np.asarray(gt["boxes"])[:, 3] -
                          np.asarray(gt["boxes"])[:, 1])
                    in_b = (gh >= height_range[0]) & (gh < height_range[1])
                    g_sel = g_cls & in_b
                    g_ign = g_cls & ~in_b
                else:
                    g_sel, g_ign = g_cls, np.zeros_like(g_cls)
                n_g = int(g_sel.sum())
                n_gt += n_g
                p_sel = np.asarray(pred["labels"]) == c
                p_scores = np.asarray(pred["scores"])[p_sel]
                if p_scores.size == 0:
                    continue
                if kind == "mask":
                    pm = np.asarray(pred["masks"])[p_sel]
                    gm = np.asarray(gt["masks"])
                    iou = mask_iou(pm, gm[g_sel]) \
                        if n_g else np.zeros((p_scores.size, 0))
                    iou_ign = mask_iou(pm, gm[g_ign]) \
                        if g_ign.any() else np.zeros((p_scores.size, 0))
                else:
                    pb = np.asarray(pred["boxes"])[p_sel]
                    gb = np.asarray(gt["boxes"])
                    iou = box_iou_xyxy(pb, gb[g_sel]) \
                        if n_g else np.zeros((p_scores.size, 0))
                    iou_ign = box_iou_xyxy(pb, gb[g_ign]) \
                        if g_ign.any() else np.zeros((p_scores.size, 0))
                if height_range is not None:
                    p_boxes = np.asarray(pred["boxes"])[p_sel]
                    ph = p_boxes[:, 3] - p_boxes[:, 1]
                    p_in_b = (ph >= height_range[0]) & \
                             (ph < height_range[1])
                order = np.argsort(-p_scores)
                taken = np.zeros(n_g, bool)
                for pi in order:
                    is_tp = False
                    if n_g:
                        j = int(np.argmax(np.where(taken, -1.0, iou[pi])))
                        if iou[pi, j] >= t and not taken[j]:
                            taken[j] = True
                            is_tp = True
                    if not is_tp and height_range is not None:
                        # ignore: matches an out-of-bucket GT, or is an
                        # unmatched detection outside the bucket itself
                        if (iou_ign.shape[1] and iou_ign[pi].max() >= t) \
                                or not p_in_b[pi]:
                            continue
                    scores.append(p_scores[pi])
                    matched.append(is_tp)
            ap = _ap_from_matches(scores, matched, n_gt)
            if not np.isnan(ap):
                aps.append(ap)
        per_thresh[round(float(t), 2)] = float(np.mean(aps)) if aps else 0.0
    ap50 = per_thresh.get(0.5, 0.0)
    return {"AP50": ap50,
            "AP": float(np.mean(list(per_thresh.values()))),
            "per_thresh": per_thresh}
