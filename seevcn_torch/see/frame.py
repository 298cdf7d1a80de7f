"""One frame on the device: the 2D instance masks, then the SEE frame
(isolation -> VCN completion -> replacement), then the detector.

The port of the chain that bench.py composes from ``mask_stage``,
``see_stage``, ``vcn_stage``, ``replace_stage`` and ``det_stage``
(bench.py:157-231): Mask R-CNN on the camera image, the SEE program of the
reference, which turns a scan and those masks into the completed cloud, and
the detector, which reads that cloud: SECOND-IoU, bench.py's, or any
other detector of ``build_detector`` (PV-RCNN, PV-RCNN++, SECONDNet,
PointPillar, CenterPoint, Voxel R-CNN, PointRCNN, Part-A2). ``run_frame`` is bench.py's
``frame_fused`` (bench.py:238-246); ``see_and_detect`` is the same frame
with the masks given as an input.
"""
from __future__ import annotations

import torch

from .. import resolve_device, tf32_off
from ..models.detectors.second import post_processing
from . import device_pipeline as DP


@torch.no_grad()
def mask_stage(seg_model, image, *, device="cuda"):
    """bench.py's ``mask_stage``: the Mask R-CNN eval forward (``seg_model``,
    from ``build_seg2d`` on ``device``) on image (1, H, W, 3) -> the boxes
    (D, 4) xyxy, 28x28 masks (D, 28, 28) and scores (D,) of image 0, D =
    ``max_detections``. TF32 off, as in ``complete_frame``."""
    dev = resolve_device(device)
    tf32_off()
    out = seg_model(image.to(dev))
    return out["det_boxes"][0], out["det_masks"][0], out["det_scores"][0]


def isolate_stage(points, valid, det_boxes, det_masks, det_scores, proj,
                  lidar_to_cam, image_size, max_instance_pts: int = 2048,
                  out_pts: int = 1024):
    """Mask membership on the camera frame (3% shrink, 20% core) and
    isolation of each detection's object: -> ((D, out_pts, 3), (D,) ok)."""
    cam_pts = points @ lidar_to_cam.T
    member, core = DP.mask_membership(cam_pts, valid, proj, det_boxes,
                                      det_masks, det_scores, score_thresh=0.0,
                                      mask_thresh=0.5, image_size=image_size,
                                      shrink_pct=3.0, core_shrink_pct=20.0)
    return DP.isolate_and_resample(points, member,
                                   max_instance_pts=max_instance_pts,
                                   out_pts=out_pts, core_membership=core)


def vcn_stage(vcn, iso, max_dist: float = 2.0, gt_boxes=None):
    """VCN completion + partial mesh + largest cluster, then the guard
    (``max_dist``, 2 m) against completions that left their object: -> ((D,
    n, 3), (D,) sane). A VCN that normalises by a box (VCN_CN) takes the
    instances' boxes (D, 7) as ``gt_boxes``."""
    completed = vcn(iso, gt_boxes)[3]
    sane = DP.completion_sanity_mask(
        iso, completed, torch.ones(completed.shape[0], dtype=torch.bool,
                                   device=completed.device), max_dist=max_dist)
    return completed, sane


def replace_stage(points, valid, completed, inst_valid, cand_cap: int = 32768):
    """Drop scan points within 0.1 m of a completed point, append the
    completed points."""
    return DP.replace_with_completed(points, valid, completed, inst_valid,
                                     point_dist_thresh=0.1, cand_cap=cand_cap)


@torch.no_grad()
def complete_frame(points, valid, det_boxes, det_masks, det_scores, vcn, proj,
                   lidar_to_cam, image_size=(384, 1280), *,
                   max_instance_pts: int = 2048, out_pts: int = 1024,
                   cand_cap: int = 32768, device="cuda"):
    """Run one SEE frame on ``device`` (CUDA unless the caller passes "cpu").

    points (P, 3) lidar frame, valid (P,), det_* the D <= 32 detections of
    the camera image (boxes xyxy, 28x28 mask patches, scores), ``vcn`` a
    ``VCNInference`` on the same device, proj (3, 4) camera matrix,
    lidar_to_cam (3, 3). Returns (new_pts (P + D*n, 3), new_valid, stats)
    where stats holds the isolated and completed instances and their
    validity (``ok``, ``sane``, ``inst_valid = ok & sane``).

    TF32 is switched off for matrix products and cuDNN: the reference runs
    its geometry at full f32 precision (Precision.HIGHEST)."""
    dev = resolve_device(device)
    tf32_off()
    points, valid, det_boxes, det_masks, det_scores, proj, lidar_to_cam = (
        t.to(dev) for t in (points, valid, det_boxes, det_masks, det_scores,
                            proj, lidar_to_cam))
    iso, ok = isolate_stage(points, valid, det_boxes, det_masks, det_scores,
                            proj, lidar_to_cam, image_size,
                            max_instance_pts=max_instance_pts, out_pts=out_pts)
    completed, sane = vcn_stage(vcn, iso)
    inst_valid = ok & sane
    new_pts, new_valid = replace_stage(points, valid, completed, inst_valid,
                                       cand_cap=cand_cap)
    stats = {"isolated": iso, "completed": completed, "ok": ok, "sane": sane,
             "inst_valid": inst_valid}
    return new_pts, new_valid, stats


@torch.no_grad()
def detect_stage(model, cfg, points, valid, *, device="cuda"):
    """bench.py's ``det_stage``: the detector's eval forward on one frame
    (points (P, 3), valid (P,)), then its post-processing NMS. ``model`` is
    any detector of ``build_detector`` on ``device``, ``cfg`` the full
    config it was built from; post-processing takes its RCNN branch where
    the config has a ROI_HEAD (SECOND-IoU, PV-RCNN, PV-RCNN++, Voxel R-CNN,
    PointRCNN, Part-A2), its dense branch where not (SECONDNet,
    PointPillar, CenterPoint), and reads the frame's points
    and the class names, as the JAX package's eval does
    (seevcn_tpu/train/eval.py:38-47). Returns (post-processed dict with a
    batch axis of 1, the forward's output dict).

    Runs in the backbone's dtype (BACKBONE_3D.DTYPE) with f32 products and
    with TF32 off, as ``complete_frame`` leaves it."""
    dev = resolve_device(device)
    tf32_off()
    pts, vld = points.to(dev)[None], valid.to(dev)[None]
    out = model(pts, vld)
    pp = post_processing(out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES),
                         has_roi_head="ROI_HEAD" in cfg.MODEL, points=pts,
                         points_valid=vld, class_names=list(cfg.CLASS_NAMES))
    return pp, out


@torch.no_grad()
def see_and_detect(points, valid, det_boxes, det_masks, det_scores, vcn,
                   proj, lidar_to_cam, detector, det_cfg,
                   image_size=(384, 1280), *, device="cuda", **frame_kw):
    """One SEE frame (``complete_frame``) and the detector (any of
    ``build_detector``'s, ``detect_stage``) on its output cloud (``new_pts``,
    ``new_valid``), as bench.py's ``frame_fused`` does after its mask
    stage. Returns (post-processed detections, SEE stats, new_pts,
    new_valid)."""
    new_pts, new_valid, stats = complete_frame(
        points, valid, det_boxes, det_masks, det_scores, vcn, proj,
        lidar_to_cam, image_size, device=device, **frame_kw)
    pp, _ = detect_stage(detector, det_cfg, new_pts, new_valid, device=device)
    return pp, stats, new_pts, new_valid


@torch.no_grad()
def run_frame(image, points, valid, seg_model, vcn, detector, det_cfg, proj,
              lidar_to_cam, *, device="cuda", **frame_kw):
    """bench.py's ``frame_fused``: ``mask_stage`` on the camera image
    (1, H, W, 3), then ``complete_frame`` on the scan (points (P, 3), valid
    (P,)) with those detections, then ``detect_stage`` on the output cloud.
    The image size is the mask model's. Returns (post-processed detections,
    stats, new_pts, new_valid); stats holds the SEE frame's stats and the
    mask stage's ``det_boxes``, ``det_masks`` and ``det_scores``."""
    boxes, masks, scores = mask_stage(seg_model, image, device=device)
    pp, stats, new_pts, new_valid = see_and_detect(
        points, valid, boxes, masks, scores, vcn, proj, lidar_to_cam, detector,
        det_cfg, seg_model.cfg.image_size, device=device, **frame_kw)
    stats.update(det_boxes=boxes, det_masks=masks, det_scores=scores)
    return pp, stats, new_pts, new_valid
