"""Rotated NMS on the device (port of seevcn_tpu/ops/nms.py).

Scores -> the top ``pre_maxsize`` (a stable descending sort, so ties keep
index order as ``jax.lax.top_k`` does) -> one (K, K) rotated-IoU matrix ->
a greedy scan over the rows in score order -> the kept boxes compacted into
a fixed ``min(post_maxsize, K)`` slots with a validity mask. The scan runs
on the device, one step per row with no host sync; at K = 1024 that is 1024
steps of two small launches each.
"""
from __future__ import annotations

import torch

from ..geom.boxes import boxes3d_to_aligned_bev, boxes_iou_normal
from .iou3d import boxes_iou_bev

NEG_INF = -1e9


def _greedy_suppress(overlap: torch.Tensor, valid: torch.Tensor,
                     thresh: float) -> torch.Tensor:
    """Greedy NMS over score-sorted boxes: box i, if still kept, removes
    every later box that overlaps it by more than ``thresh``. overlap (K, K),
    valid (K,) -> keep (K,) bool."""
    k = overlap.shape[0]
    later = torch.ones((k, k), dtype=torch.bool, device=overlap.device).triu(1)
    sup = ((overlap > thresh) & later).to(torch.float32)
    keep = valid.to(torch.float32)
    for i in range(k):
        # keep_j *= 1 - sup_ij * keep_i, exact on 0/1 values
        keep.addcmul_(sup[i] * keep[i], keep, value=-1.0)
    return keep > 0


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
            pre_maxsize: int = 4096, post_maxsize: int = 500,
            score_thresh: float | None = None,
            valid_mask: torch.Tensor | None = None,
            use_bev_aligned: bool = False, row_chunk: int | None = None):
    """Rotated-BEV NMS: boxes (N, 7), scores (N,) -> (indices into the
    inputs, keep mask, kept scores (NEG_INF where not kept)), each of
    min(post_maxsize, min(pre_maxsize, N)) rows, kept boxes first in score
    order. ``score_thresh`` keeps scores >= it; ``use_bev_aligned`` uses
    the axis-aligned nearest-BEV IoU (nms_normal_gpu)."""
    k = min(pre_maxsize, boxes.shape[0])
    ok = torch.isfinite(scores)
    if valid_mask is not None:
        ok &= valid_mask
    if score_thresh is not None:
        ok &= scores >= score_thresh
    masked = torch.where(ok, scores, NEG_INF)
    top_scores, order = torch.sort(masked, descending=True, stable=True)
    top_scores, order = top_scores[:k], order[:k]
    sboxes = boxes[order]
    top_valid = top_scores > NEG_INF / 2

    if use_bev_aligned:
        bev = boxes3d_to_aligned_bev(sboxes)
        overlap = boxes_iou_normal(bev, bev)
    else:
        if row_chunk is None and k > 2048:
            row_chunk = 512
        overlap = boxes_iou_bev(sboxes, sboxes, row_chunk=row_chunk)
    keep = _greedy_suppress(overlap, top_valid, thresh)

    pos = torch.arange(k, device=boxes.device)
    compact = torch.argsort(torch.where(keep, pos, k + pos))[:post_maxsize]
    out_keep = keep[compact]
    return (order[compact], out_keep,
            torch.where(out_keep, top_scores[compact], NEG_INF))


def class_agnostic_nms(box_scores, box_preds, nms_config,
                       score_thresh: float | None = None, valid_mask=None):
    """Config-driven wrapper (model_nms_utils.class_agnostic_nms)."""
    return nms_bev(box_preds, box_scores, thresh=float(nms_config.NMS_THRESH),
                   pre_maxsize=int(nms_config.NMS_PRE_MAXSIZE),
                   post_maxsize=int(nms_config.NMS_POST_MAXSIZE),
                   score_thresh=score_thresh, valid_mask=valid_mask,
                   use_bev_aligned=nms_config.get("NMS_TYPE", "nms_gpu")
                   == "nms_normal_gpu")
