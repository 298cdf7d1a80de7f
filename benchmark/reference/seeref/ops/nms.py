"""Greedy rotated NMS as its definition, scanned on the host.

The boxes that pass the score threshold, best first (a stable descending
sort: ties keep index order), at most ``pre_maxsize`` of them; then, in that
order, each box is kept unless a kept box overlaps it by more than
``thresh`` in rotated BEV IoU (``iou3d.boxes_iou_bev``), until
``post_maxsize`` are kept.
"""
from __future__ import annotations

import torch

from .iou3d import boxes_iou_bev

NEG_INF = -1e9


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
            pre_maxsize: int = 4096, post_maxsize: int = 500,
            score_thresh: float | None = None, valid_mask: torch.Tensor | None = None):
    """boxes (N, 7), scores (N,) -> (indices into the inputs, keep mask,
    kept scores (NEG_INF where not kept)), min(post_maxsize, pre_maxsize, N)
    rows, the kept boxes first in score order."""
    k = min(int(pre_maxsize), boxes.shape[0])
    rows = min(int(post_maxsize), k)
    ok = torch.isfinite(scores)
    if valid_mask is not None:
        ok &= valid_mask
    if score_thresh is not None:
        ok &= scores >= score_thresh
    cand = torch.nonzero(ok)[:, 0]
    order = cand[torch.argsort(-scores[cand], stable=True)][:k]
    over = (boxes_iou_bev(boxes[order, :7], boxes[order, :7]) > thresh).cpu().numpy()
    kept: list[int] = []
    for i in range(order.shape[0]):
        if len(kept) == rows:
            break
        if not over[i, kept].any():
            kept.append(i)
    idx = torch.zeros(rows, dtype=torch.long, device=boxes.device)
    keep = torch.zeros(rows, dtype=torch.bool, device=boxes.device)
    idx[:len(kept)] = order[torch.tensor(kept, dtype=torch.long, device=boxes.device)]
    keep[:len(kept)] = True
    out = torch.full((rows,), NEG_INF, dtype=scores.dtype, device=scores.device)
    out[:len(kept)] = scores[idx[:len(kept)]]
    return idx, keep, out
