"""Measure the DET path (trained seg2d masks) against the GT path (box
membership) through the same SEE pipeline on 3D-consistent synthetic
frames (port of scripts/measure_maskpath_impact.py).

The reference compares its config-1 (GT isolation) and config-2 (DET
isolation via HTC masks) preprocessing paths (see/SEE_VCN.py:117-265).
With no pretrained detector, the downstream quality proxies are geometric:
  - membership IoU: per-frame IoU of the raw point sets selected by DET
    vs GT. Structurally depressed: the DET mask silhouette admits occluded
    background behind the object (no depth test); the clustering step is
    what removes the bleed-through, so also report
  - isolated-set IoU (isoIoU): IoU of the unique source points each
    path's isolation feeds the VCN,
  - completed-cloud chamfer: symmetric chamfer between the two paths'
    added points (the detector input the two configs produce),
  - in-box fraction: of the completed points each path adds, the fraction
    inside a true GT 3D box.
Each path ends in the replacement, whose within-radius test is the pruned
min-distance kernel K1 on the card: two launches a frame.

Usage: python -m seevcn_torch.experiments.measure_maskpath_impact --ckpt <seg2d ckpt>
           [--frames 8] [--image_size 384 512] [--vcn_ckpt <VCN_VC .pth>] [--cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import resolve_device, tf32_off
from ..models.seg2d.backend import MaskRCNNBackend
from ..models.seg2d.synthetic import scene_to_bgr, synth_frame3d
from ..models.vcn.inference import VCNInference
from ..ops.resize import resize_linear
from ..see import device_pipeline as DP
from ..see.frame import replace_stage, vcn_stage
from ..see.gt_completion import gt_membership
from ..utils.ckpt import load_vcn_checkpoint
from .da_experiment import seeded_vcn

#: detection slots of a frame and the mask patch side
D, PATCH = 8, 56


def build_pipeline(vcn_ckpt=None, device="cuda"):
    """-> (run, run_gt) on ``device``, VCN_VC from ``vcn_ckpt`` (a reference
    ``.pth``) or at seeded weights. ``run(pts, valid, proj, l2c, boxes,
    masks, scores, image_size)`` isolates by the masks (3% shrink, the 20%
    core picking the object's cluster), ``run_gt(pts, valid, gt_boxes,
    gt_valid)`` by the ground-lifted GT boxes; both then complete and
    replace, and return (member, iso, ok, completed, new_pts, new_valid)."""
    dev = resolve_device(device)
    vcn = VCNInference("VCN_VC", load_vcn_checkpoint(vcn_ckpt, "VCN_VC"), device=dev) \
        if vcn_ckpt else seeded_vcn("VCN_VC", dev)

    def _tail(pts, valid, member, core=None):
        iso, ok = DP.isolate_and_resample(pts, member, max_instance_pts=2048,
                                          out_pts=1024, core_membership=core)
        # the 2 m guard rejects completions that left their observed points
        completed, sane = vcn_stage(vcn, iso)
        ok = ok & sane
        new_pts, new_valid = replace_stage(pts, valid, completed, ok)
        return member, iso, ok, completed, new_pts, new_valid

    @torch.no_grad()
    def run(pts, valid, proj, l2c, boxes, masks, scores, image_size):
        tf32_off()
        pts, valid, proj, l2c, boxes, masks, scores = (
            torch.as_tensor(x).to(dev) for x in (pts, valid, proj, l2c, boxes, masks, scores))
        member, core = DP.mask_membership(pts @ l2c.T, valid, proj, boxes, masks, scores,
                                          score_thresh=0.0, mask_thresh=0.5,
                                          image_size=image_size, shrink_pct=3.0,
                                          core_shrink_pct=20.0)
        return _tail(pts, valid, member, core)

    @torch.no_grad()
    def run_gt(pts, valid, gt_boxes, gt_valid):
        tf32_off()
        pts, valid, gt_boxes, gt_valid = (torch.as_tensor(x).to(dev)
                                          for x in (pts, valid, gt_boxes, gt_valid))
        return _tail(pts, valid, gt_membership(pts, valid, gt_boxes, gt_valid))

    return run, run_gt


def in_box_fraction(pts, boxes):
    """Fraction of pts inside any (x, y, z, L, W, H, yaw) box (z-up)."""
    if len(pts) == 0:
        return float("nan")
    hit = np.zeros(len(pts), bool)
    for x, y, z, L, W, H, yaw in boxes:
        d = pts - [x, y, z]
        ca, sa = np.cos(-yaw), np.sin(-yaw)
        lx = d[:, 0] * ca - d[:, 1] * sa
        ly = d[:, 0] * sa + d[:, 1] * ca
        hit |= ((np.abs(lx) <= L / 2 + 0.2) & (np.abs(ly) <= W / 2 + 0.2) &
                (np.abs(d[:, 2]) <= H / 2 + 0.3))
    return float(hit.mean())


def chamfer_np(a, b):
    if len(a) == 0 or len(b) == 0:
        return float("nan")
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.min(1)).mean() + np.sqrt(d2.min(0)).mean()) / 2


def to_fixed(mask_list):
    """[(mask_hw bool, score)] -> (D, 4) boxes, (D, 56, 56) patches, (D,)
    scores (zero-padded); each patch the mask's crop at its box resized as
    cv2.resize's float INTER_LINEAR does (``resize_linear``)."""
    boxes = np.zeros((D, 4), np.float32)
    patches = np.zeros((D, PATCH, PATCH), np.float32)
    scores = np.zeros((D,), np.float32)
    for i, (m, s) in enumerate(mask_list[:D]):
        ys, xs = np.nonzero(m)
        if len(xs) == 0:
            continue
        x1, y1 = xs.min(), ys.min()
        x2, y2 = xs.max() + 1, ys.max() + 1
        boxes[i] = [x1, y1, x2, y2]
        crop = torch.from_numpy(m[y1:y2, x1:x2].astype(np.float32))
        patches[i] = resize_linear(crop, (PATCH, PATCH)).numpy()
        scores[i] = s
    return boxes, patches, scores


def _mean(x):
    x = [v for v in x if np.isfinite(v)]
    return float(np.mean(x)) if x else float("nan")


def main(argv=None):
    ap = argparse.ArgumentParser(description="DET-path vs GT-path SEE on synthetic frames.")
    ap.add_argument("--ckpt", required=True, help="a seg2d checkpoint of either package")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--image_size", type=int, nargs=2, default=(384, 512))
    ap.add_argument("--vcn_ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--score_thresh", type=float, default=0.3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    h, w = args.image_size
    backend = MaskRCNNBackend(args.ckpt, score_thresh=args.score_thresh, device=dev)
    pipe, pipe_gt = build_pipeline(args.vcn_ckpt, dev)
    rng = np.random.RandomState(args.seed)

    ious, chs, inbox_det, inbox_gt, det_counts, iso_ious = [], [], [], [], [], []
    for fi in range(args.frames):
        img, pts, gt_boxes, calib, _ = synth_frame3d(h, w, rng)
        valid = np.ones(len(pts), bool)
        dets = backend(scene_to_bgr(img))
        det_list = [(d["mask"], d["score"]) for d in dets]
        det_counts.append(len(det_list))

        # GT path = points in ground-lifted GT boxes (reference config 1)
        gtb = np.zeros((D, 7), np.float32)
        gtv = np.zeros((D,), bool)
        gtb[:len(gt_boxes)] = gt_boxes[:D]
        gtv[:len(gt_boxes)] = True
        outs = {"gt": pipe_gt(pts, valid, gtb, gtv)}
        boxes, patches, scores = to_fixed(det_list)
        outs["det"] = pipe(pts, valid, calib["P2"], calib["lidar_to_cam"], boxes, patches,
                           scores, (h, w))
        outs = {k: [t.cpu().numpy() for t in v] for k, v in outs.items()}

        m_gt, m_det = outs["gt"][0].any(0), outs["det"][0].any(0)
        union = (m_gt | m_det).sum()
        ious.append((m_gt & m_det).sum() / union if union else float("nan"))

        def iso_set(out):
            """Unique source points each path's isolation feeds the VCN (iso
            is tiled, so dedupe by rounded coordinate)."""
            sel = out[1][out[2]].reshape(-1, 3)
            return {tuple(q) for q in np.round(sel, 4).tolist()}

        s_gt, s_det = iso_set(outs["gt"]), iso_set(outs["det"])
        iso_union = len(s_gt | s_det)
        iso_ious.append(len(s_gt & s_det) / iso_union if iso_union else float("nan"))

        def added(out):
            new_pts, new_valid = out[4], out[5]
            return new_pts[len(pts):][new_valid[len(pts):]]

        a_gt, a_det = added(outs["gt"]), added(outs["det"])
        chs.append(chamfer_np(a_det, a_gt))
        inbox_gt.append(in_box_fraction(a_gt, gt_boxes))
        inbox_det.append(in_box_fraction(a_det, gt_boxes))
        print(f"frame {fi}: dets={det_counts[-1]} memberIoU={ious[-1]:.3f} "
              f"isoIoU={iso_ious[-1]:.3f} "
              f"chamfer(det,gt)={chs[-1]:.3f} m inbox gt/det="
              f"{inbox_gt[-1]:.3f}/{inbox_det[-1]:.3f}", flush=True)

    summary = {"frames": args.frames, "mean_dets": float(np.mean(det_counts)),
               "memberIoU": _mean(ious), "isoIoU": _mean(iso_ious), "chamfer": _mean(chs),
               "inbox_gt": _mean(inbox_gt), "inbox_det": _mean(inbox_det)}
    print(f"\nSUMMARY frames={args.frames} mean_dets={summary['mean_dets']:.1f} "
          f"memberIoU={summary['memberIoU']:.3f} isoIoU={summary['isoIoU']:.3f} "
          f"chamfer={summary['chamfer']:.3f} m "
          f"inbox_gt={summary['inbox_gt']:.3f} inbox_det={summary['inbox_det']:.3f}")
    return summary


if __name__ == "__main__":
    main()
