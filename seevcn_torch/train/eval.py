"""The detector evaluation loop (port of seevcn_tpu/train/eval.py; reference
tools/eval_utils/eval_utils.py:22-121): batched eval forwards,
post-processing and recall records, then the dataset's prediction dicts
and its official evaluation.

Across the ranks of a process group each rank takes the frames
``range(rank, n, world)`` (the reference's DistributedSampler), and the
(frame, prediction) pairs and the recall counts are merged over the ranks
(``parallel.collectives.merge_results_dist``, the reference's
merge_results_dist) before every rank runs the evaluation. Under an active
(dp, mp) mesh (``parallel.mesh.set_active_mesh``) the frames follow the dp
index and size instead: the mp ranks of a dp row run the same frames
(SECOND-IoU and SECONDNet each on its W slab of the BEV map), and the first
of them contributes the row's predictions and counts to the merge.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models.detectors.caddn import CaDDN
from ..models.detectors.second import post_processing
from ..ops.iou3d import boxes_iou3d
from ..parallel.collectives import get_rank, get_world_size, merge_results_dist
from ..parallel.mesh import active_mesh


def recall_record(pred_boxes, pred_mask, gt_boxes, gt_mask, thresh_list) -> dict:
    """One frame's recall counts (detector3d_template.py:286-328): the valid
    gts whose best 3D IoU with a kept box exceeds each threshold, and
    num_gt, as 0-d tensors."""
    iou = boxes_iou3d(gt_boxes[:, :7], pred_boxes[:, :7])
    best = torch.where(pred_mask[None, :], iou, 0.0).amax(1)
    out = {f"recalled_{t}": ((best > t) & gt_mask).sum() for t in thresh_list}
    out["num_gt"] = gt_mask.sum()
    return out


@torch.no_grad()
def eval_step(model, cfg, batch: dict) -> tuple[dict, dict]:
    """A batch (tensors on the model's device) -> (post-processed
    predictions, recall counts summed over the frames): the eval forward on
    points and points_valid (CaDDN: images and trans_cam_to_img),
    ``post_processing``, ``recall_record`` a frame."""
    post_cfg = cfg.MODEL.POST_PROCESSING
    thresh_list = [float(t) for t in post_cfg.get("RECALL_THRESH_LIST", [0.3, 0.5, 0.7])]
    if isinstance(model, CaDDN):
        out = model(batch["images"], batch["trans_cam_to_img"])
    else:
        out = model(batch["points"], batch["points_valid"])
    preds = post_processing(out, post_cfg, len(cfg.CLASS_NAMES), "ROI_HEAD" in cfg.MODEL,
                            points=batch.get("points"), points_valid=batch.get("points_valid"),
                            class_names=list(cfg.CLASS_NAMES))
    recs = [recall_record(pb, pm, gb[:, :7], gm, thresh_list) for pb, pm, gb, gm in zip(
        preds["pred_boxes"], preds["pred_mask"], batch["gt_boxes"], batch["gt_mask"])]
    return preds, {k: torch.stack([r[k] for r in recs]).sum() for k in recs[0]}


def eval_one_epoch(model, cfg, dataset, batch_size: int = 1, logger=print,
                   max_frames: int | None = None):
    """-> (AP report, AP dict, recall counts) of ``model`` (in eval mode, on
    its device) over ``dataset``'s first ``max_frames`` frames (all by
    default), which implements __getitem__, __len__,
    generate_prediction_dicts and evaluation. The tail batch is padded
    with its last frame, whose repeats are not counted twice in the
    predictions (the recall counts them, as the JAX package's do). In a
    process group each rank evaluates every world-th frame from its rank,
    and the predictions and recall counts of every rank are merged, sorted
    by frame, before the evaluation, which every rank runs."""
    dev = next(model.parameters()).device
    post_cfg = cfg.MODEL.POST_PROCESSING
    thresh_list = [float(t) for t in post_cfg.get("RECALL_THRESH_LIST", [0.3, 0.5, 0.7])]
    keys = ("images", "trans_cam_to_img") if isinstance(model, CaDDN) else \
        ("points", "points_valid")
    det_annos, frame_indices = [], []
    recall = {f"recalled_{t}": 0 for t in thresh_list}
    recall["num_gt"] = 0
    n = len(dataset) if max_frames is None else min(max_frames, len(dataset))
    t_start = time.time()
    mesh = active_mesh()
    rank, world = (mesh.dp_rank, mesh.dp) if mesh is not None else \
        (get_rank(), get_world_size())
    my_frames = list(range(rank, n, world))
    for s in range(0, len(my_frames), batch_size):
        idx = my_frames[s:s + batch_size]
        while len(idx) < batch_size:
            idx.append(idx[-1])                      # pad the tail batch
        frames = [dataset[i] for i in idx]
        batch = {k: torch.from_numpy(np.stack([f[k] for f in frames])).to(dev)
                 for k in keys + ("gt_boxes", "gt_mask")}
        preds, rec = eval_step(model, cfg, batch)
        preds = {k: v.cpu().numpy() for k, v in preds.items()}
        for k in recall:
            recall[k] += int(rec[k])
        for bi, fi in enumerate(idx):
            if fi in frame_indices:
                continue
            frame_indices.append(fi)
            m = preds["pred_mask"][bi]
            det_annos.append({"pred_boxes": preds["pred_boxes"][bi][m],
                              "pred_scores": preds["pred_scores"][bi][m],
                              "pred_labels": preds["pred_labels"][bi][m]})
    dt = time.time() - t_start
    logger(f"eval: {len(frame_indices)} frames, "
           f"{dt / max(len(frame_indices), 1):.4f} sec_per_example")
    annos = dataset.generate_prediction_dicts(frame_indices, det_annos, cfg.CLASS_NAMES,
                                              device=dev)
    if get_world_size() > 1:
        # the mp ranks of a dp row hold the same frames: the first one speaks
        first = mesh is None or mesh.mp_rank == 0
        pairs = sorted(merge_results_dist(list(zip(frame_indices, annos)) if first else []),
                       key=lambda p: p[0])[:n]
        annos = [p[1] for p in pairs]
        merged = merge_results_dist([recall] if first else [])
        recall = {k: sum(r[k] for r in merged) for k in recall}
    for t in thresh_list:
        logger(f"recall_{t}: {recall[f'recalled_{t}'] / max(recall['num_gt'], 1):.4f}")
    result = dataset.evaluation(annos, cfg.CLASS_NAMES, device=dev)
    if result is None or result[0] is None:
        return None, {}, recall
    report, ap_dict = result
    logger(report)
    return report, ap_dict, recall
