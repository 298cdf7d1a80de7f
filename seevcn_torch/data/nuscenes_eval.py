"""Native nuScenes detection metrics, mAP by center distance + NDS (port
of seevcn_tpu/data/nuscenes_eval.py, host numpy, copied).

The reference delegates to the nuscenes-devkit
(pcdet/datasets/nuscenes/nuscenes_dataset.py:334-351 -> nuscenes.eval
.detection.evaluate.NuScenesEval). This is a from-scratch numpy
implementation of that protocol so the metric runs without the devkit:

  * matching: greedy by descending score; a detection matches the nearest
    unmatched ground truth of the same class whose BEV center distance is
    under the threshold; thresholds {0.5, 1, 2, 4} m.
  * AP: 101-point interpolated precision, integrated over recall > 0.1
    with precision baseline 0.1 removed (devkit algo.py calc_ap).
  * TP metrics at the 2.0 m threshold: ATE (BEV center distance), ASE
    (1 - IoU of center/heading-aligned boxes), AOE (absolute yaw
    difference wrapped to pi), each averaged over the recall range as the
    cumulative mean interpolated to 101 recall points (devkit calc_tp).
    AVE/AAE need velocity/attribute annotations; they are reported only
    when the annos carry them, and NDS renormalizes over the metrics
    present (the devkit scores absent data as 1.0 = worst; renormalizing
    is the documented deviation, chosen so lidar-only pipelines are not
    penalized for fields the datasets here never produce).
  * NDS = (5 * mAP + sum(1 - min(1, mTP))) / (5 + n_tp_metrics).
"""
from __future__ import annotations

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_SAMPLES = 101


def _wrap_angle(a):
    return np.abs((a + np.pi) % (2 * np.pi) - np.pi)


def _aligned_iou3d(det_box, gt_box):
    """3D IoU after aligning center + heading (scale error only)."""
    inter = np.prod(np.minimum(det_box[3:6], gt_box[3:6]))
    union = np.prod(det_box[3:6]) + np.prod(gt_box[3:6]) - inter
    return inter / max(union, 1e-6)


def _accumulate(gt_by_frame, det_list, dist_th):
    """Match one class at one distance threshold.

    gt_by_frame: {frame: (G, 7) boxes}; det_list: [(score, frame, box)].
    Returns tp/fp flags in score order + per-match errors + total gt count.
    """
    npos = sum(len(b) for b in gt_by_frame.values())
    taken = {f: np.zeros(len(b), bool) for f, b in gt_by_frame.items()}
    det_list = sorted(det_list, key=lambda d: -d[0])
    tp = np.zeros(len(det_list), bool)
    errs = []                                   # (trans, scale, orient)
    for i, (score, frame, box) in enumerate(det_list):
        gts = gt_by_frame.get(frame)
        if gts is None or not len(gts):
            continue
        d = np.linalg.norm(gts[:, :2] - box[:2], axis=1)
        d[taken[frame]] = np.inf
        j = int(np.argmin(d))
        if d[j] < dist_th:
            taken[frame][j] = True
            tp[i] = True
            errs.append((d[j], 1.0 - _aligned_iou3d(box, gts[j]),
                         _wrap_angle(box[6] - gts[j][6])))
    return tp, errs, npos


def _calc_ap(tp, npos):
    if npos == 0 or len(tp) == 0:
        return 0.0
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    rec = cum_tp / npos
    prec = cum_tp / (cum_tp + cum_fp)
    rs = np.linspace(0, 1, N_RECALL_SAMPLES)
    p_interp = np.interp(rs, rec, prec, right=0)
    p = p_interp[int(round(100 * MIN_RECALL)) + 1:]
    p = np.clip(p - MIN_PRECISION, 0, None)
    return float(p.mean() / (1 - MIN_PRECISION))


def _calc_tp_metric(tp, errs, npos, col):
    """Average cumulative-mean error over the achieved recall range."""
    if npos == 0 or not len(errs):
        return 1.0                              # worst (devkit convention)
    e = np.array([er[col] for er in errs])
    cum = np.cumsum(e) / (np.arange(len(e)) + 1)
    rec_at_match = (np.arange(len(e)) + 1) / npos
    rs = np.linspace(0, 1, N_RECALL_SAMPLES)
    first = int(round(100 * MIN_RECALL)) + 1
    last = int(round(100 * min(rec_at_match[-1], 1.0)))
    if last < first:
        return 1.0
    curve = np.interp(rs, rec_at_match, cum)
    return float(curve[first:last + 1].mean())


def nuscenes_eval(det_annos, gt_annos, class_names):
    """det_annos/gt_annos: per-frame dicts with 'name' (N,) and box arrays
    ('boxes_lidar' for dets, 'gt_boxes_lidar' for gts), boxes (N, 7+).

    Returns (report_str, result_dict) matching dataset.evaluation's shape.
    """
    results = {}
    ap_all = []
    tp_names = ("trans_err", "scale_err", "orient_err")
    tp_all = {k: [] for k in tp_names}
    for cls in class_names:
        gt_by_frame = {}
        for f, gt in enumerate(gt_annos):
            names = np.asarray(gt["name"])
            boxes = np.asarray(gt.get("gt_boxes_lidar", gt.get("boxes_lidar",
                                                               [])),
                               np.float64).reshape(-1, boxesdim(gt))
            gt_by_frame[f] = boxes[names == cls][:, :7] if len(names) else \
                np.zeros((0, 7))
        det_list = []
        for f, det in enumerate(det_annos):
            names = np.asarray(det["name"])
            boxes = np.asarray(det["boxes_lidar"], np.float64)
            scores = np.asarray(det["score"], np.float64)
            for n, b, s in zip(names, boxes.reshape(-1, boxesdim(det)),
                               scores):
                if n == cls:
                    det_list.append((float(s), f, b[:7]))

        aps = {}
        for th in DIST_THRESHOLDS:
            tp, errs, npos = _accumulate(gt_by_frame, det_list, th)
            aps[th] = _calc_ap(tp, npos)
            if th == TP_THRESHOLD:
                for ci, k in enumerate(tp_names):
                    v = _calc_tp_metric(tp, errs, npos, ci)
                    results[f"{cls}/{k}"] = v
                    tp_all[k].append(v)
        m = float(np.mean(list(aps.values())))
        results[f"{cls}/mAP"] = m
        for th, v in aps.items():
            results[f"{cls}/AP@{th}"] = v
        ap_all.append(m)

    mAP = float(np.mean(ap_all)) if ap_all else 0.0
    m_tp = {k: float(np.mean(v)) if v else 1.0 for k, v in tp_all.items()}
    nds = (5 * mAP + sum(max(1 - min(1.0, m_tp[k]), 0.0) for k in tp_names)) \
        / (5 + len(tp_names))
    results.update({"mAP": mAP, "NDS": nds,
                    **{f"m{k}": v for k, v in m_tp.items()}})
    lines = [f"mAP: {mAP:.4f}", f"NDS: {nds:.4f}"]
    lines += [f"m{k}: {v:.4f}" for k, v in m_tp.items()]
    for cls in class_names:
        lines.append(f"{cls}: AP " + " ".join(
            f"{th}m={results[f'{cls}/AP@{th}']:.4f}" for th in DIST_THRESHOLDS))
    return "\n".join(lines), results


def boxesdim(anno):
    for key in ("boxes_lidar", "gt_boxes_lidar"):
        if key in anno:
            b = np.asarray(anno[key])
            if b.ndim == 2:
                return b.shape[1]
    return 7
