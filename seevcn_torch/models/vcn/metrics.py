"""VCN evaluation metric battery in torch (port of
seevcn_tpu/models/vcn/metrics.py; reference see/.../models/vcn/utils/
metrics.py:20-531): chamfer L1/L2 (overall and per input-point-count
difficulty level L1-L4), F-scores, the 3D IoU of the keypoint box against
the GT box, rotation and translation errors, the out-of-box fraction, PCA
axis alignment and coherence, and the partial-mesh chamfer. Batched on the
predictions' device; ``MetricAccumulator`` gathers per-sample rows on the
host.
"""
from __future__ import annotations

import numpy as np
import torch

from ...geom import transforms as T
from ...ops.chamfer import chamfer_sq
from ...ops.iou3d import boxes_iou3d
from ...ops.sampling import fps, partial_mesh_batch
from .nets import get_bbox_from_keypoints

# per-input-point-count difficulty buckets, inclusive [min, max]
# (metrics.py:110-114: L1 densest .. L4 sparsest)
LEVELS = {"L1": (201, 1 << 30), "L2": (81, 200), "L3": (31, 80),
          "L4": (5, 30)}


def chamfer_metrics(pred: torch.Tensor, gt: torch.Tensor):
    """-> per-sample CDL1 (B,), CDL2 (B,)."""
    d1, d2 = chamfer_sq(pred, gt)
    cdl2 = d1.mean(1) + d2.mean(1)
    cdl1 = (torch.sqrt(d1 + 1e-12).mean(1) + torch.sqrt(d2 + 1e-12).mean(1)) / 2
    return cdl1, cdl2


def f_score(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.01):
    """Per-sample F-score at a distance threshold (the reference's default
    0.01; the battery also reports 0.03 and 0.10, which separate good from
    bad completions at a 1024-point car's sample spacing of about 10 cm)."""
    d1, d2 = chamfer_sq(pred, gt)
    precision = (torch.sqrt(d1) < threshold).float().mean(1)
    recall = (torch.sqrt(d2) < threshold).float().mean(1)
    return 2 * precision * recall / (precision + recall).clamp_min(1e-9)


def box_iou3d_metric(pred_pts: torch.Tensor, gt_boxes: torch.Tensor):
    """IoU between the box fitted to the predicted points (GT heading) and
    the GT box (metrics.py:411 _get_box_iou3d): -> (iou (B,), box (B, 7))."""
    pred_box = get_bbox_from_keypoints(pred_pts, gt_boxes)
    return boxes_iou3d(pred_box, gt_boxes[:, :7]).diagonal(), pred_box


def pose_errors(reg_rot: torch.Tensor, reg_centre: torch.Tensor,
                gt_boxes: torch.Tensor, symmetric: bool = True):
    """-> rotation error (rad), translation error (m) per sample. With
    ``symmetric`` the rotation error is the smaller of the geodesic
    distances to Rz(h) and Rz(h + pi), the car's 180-degree symmetry."""
    rot_err = T.geodesic_distance(reg_rot, T.rot_z(gt_boxes[:, -1]))
    if symmetric:
        rot_err = torch.minimum(rot_err, T.geodesic_distance(
            reg_rot, T.rot_z(gt_boxes[:, -1] + torch.pi)))
    trans_err = torch.linalg.vector_norm(reg_centre - gt_boxes[:, :3], dim=1)
    return rot_err, trans_err


def out_of_box_fraction(pred_pts: torch.Tensor, gt_boxes: torch.Tensor,
                        margin: float = 0.1):
    """Fraction of each sample's predicted points outside its GT box grown
    by ``margin`` on every side length (losses.py get_oob_error), the
    containment of geom.boxes.points_in_boxes per sample."""
    big = gt_boxes[:, :7] + gt_boxes.new_tensor([0, 0, 0, margin, margin, margin, 0])
    local = T.rotate_points_along_z(pred_pts[..., :3] - big[:, None, :3], -big[:, 6])
    inside = (local.abs() <= big[:, None, 3:6] / 2).all(-1)
    return 1.0 - inside.float().mean(1)


def _bev_pca(pc_bev: torch.Tensor):
    """Closed-form 2-D PCA per sample: -> (major axis (B, 2), explained
    variance (B,)), the variance with ddof 1 as sklearn's PCA gives it."""
    n = pc_bev.shape[1]
    x = pc_bev - pc_bev.mean(1, keepdim=True)
    cov = torch.einsum("bni,bnj->bij", x, x) / (n - 1)
    a, b, c = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    tr, det = a + c, a * c - b * b
    lam = tr / 2 + torch.sqrt((tr * tr / 4 - det).clamp_min(0.0))   # largest
    # the eigenvector of lam: (b, lam - a) or (lam - c, b), the stabler one
    v1 = torch.stack([b, lam - a], 1)
    v2 = torch.stack([lam - c, b], 1)
    v = torch.where((b.abs() + (lam - a).abs() > (lam - c).abs() + b.abs())[:, None],
                    v1, v2)
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp_min(1e-12)
    return v, lam


def axis_alignment(pred_pts: torch.Tensor, gt_boxes: torch.Tensor):
    """Angle (rad) between the PCA major axis of the predicted BEV points and
    the GT heading axis, sign-agnostic (metrics.py:358-384)."""
    major, _ = _bev_pca(pred_pts[:, :, :2])
    heading = gt_boxes[:, -1]
    gt_vec = torch.stack([torch.cos(heading), torch.sin(heading)], 1)
    return torch.arccos((gt_vec * major).sum(1).abs().clamp(0.0, 1.0))


def coherence(pred_pts: torch.Tensor):
    """PCA explained variance of the predicted BEV points, clamped to 1
    (metrics.py:387-409)."""
    _, lam = _bev_pca(pred_pts[:, :, :2])
    return lam.clamp_max(1.0)


def partial_chamfer_metrics(input_pts: torch.Tensor, pred: torch.Tensor,
                            gt_complete: torch.Tensor, sel_k: int = 30):
    """CDL1/CDL2 between the partial-mesh selections of the prediction and
    of the GT (FPS-downsampled to the prediction's count), the regions near
    the observed points (metrics.py:211-266)."""
    ds_gt = fps(gt_complete, pred.shape[1]) \
        if gt_complete.shape[1] != pred.shape[1] else gt_complete
    pred_surface = partial_mesh_batch(input_pts, pred, k=sel_k)
    gt_surface = partial_mesh_batch(input_pts, ds_gt, k=sel_k)
    return chamfer_metrics(pred_surface, gt_surface)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MetricAccumulator:
    """Per-sample metric rows, summarised overall and per difficulty level
    (metrics.py Metrics.get/items); an empty level reads -1."""

    def __init__(self):
        self.rows = []

    @torch.no_grad()
    def update(self, pred_pts, gt_complete, gt_boxes, num_input_pts,
               reg_rot=None, reg_centre=None, input_pts=None):
        cdl1, cdl2 = chamfer_metrics(pred_pts, gt_complete)
        row = {"CDL1": cdl1, "CDL2": cdl2,
               "F1": f_score(pred_pts, gt_complete),
               "F1_003": f_score(pred_pts, gt_complete, threshold=0.03),
               "F1_010": f_score(pred_pts, gt_complete, threshold=0.10),
               "IOU_3D": box_iou3d_metric(pred_pts, gt_boxes)[0],
               "OOB": out_of_box_fraction(pred_pts, gt_boxes),
               "AXIS_ALIGN": axis_alignment(pred_pts, gt_boxes),
               "COHERENCE": coherence(pred_pts), "npts": num_input_pts}
        if input_pts is not None:
            row["CDL1_PARTIAL"], row["CDL2_PARTIAL"] = partial_chamfer_metrics(
                input_pts, pred_pts, gt_complete)
        if reg_rot is not None:
            rot_err, trans_err = pose_errors(reg_rot, reg_centre, gt_boxes)
            row["ROT_ERR"] = rot_err                        # symmetry-aware
            row["ROT_ERR_RAW"] = pose_errors(reg_rot, reg_centre, gt_boxes,
                                             symmetric=False)[0]
            row["TRANS_ERR"] = trans_err
        self.rows.append({k: _np(v) for k, v in row.items()})

    def summary(self) -> dict:
        if not self.rows:
            return {}
        cat = {k: np.concatenate([r[k] for r in self.rows]) for k in self.rows[0]}
        npts = cat.pop("npts")
        out = {}
        for k, v in cat.items():
            out[k] = float(v.mean())
            for lvl, (lo, hi) in LEVELS.items():
                m = (npts >= lo) & (npts <= hi)
                out[f"{k}_{lvl}"] = float(v[m].mean()) if m.any() else -1.0
        return out
