"""End-to-end demo (port of seevcn_tpu/cli/demo.py; the reference's
demo/demo.ipynb as a program).

The demo pcd and its JSON calibration [and COCO masks] -> frustum
isolation -> VCN completion -> point replacement (K1 on the card) ->
SECOND-IoU at ``configs.mini_detector_cfg`` on a 60,000-row pad, shifted by
``--shift_coor`` (as JAX's, a longer frame loses its last rows there; the
count is printed and returned as ``rows_cut``) -> post-processing and the score threshold -> the BEV plot
(``utils/viz.save_bev``, a PNG) and the HTML scene viewer.

Without instance masks (the reference draws them live with HTC), pass
--masks <camera>=<coco.json>; otherwise the completion is skipped and the
detector runs on the raw cloud. ``--vcn_ckpt`` and ``--det_ckpt`` take the
reference's ``.pth`` files. Each stage runs in a named span
(``utils/profiling.annotate``: demo/see, demo/detector, demo/plots), which
a ``profiling.trace()`` around ``main`` records.

Usage:
  python -m seevcn_torch.cli.demo --root <demo tree> \\
      [--masks front=masks.json] [--vcn_ckpt VCN_VC.pth] \\
      [--det_ckpt waymo_secondiou_see_vcn.pth] [--out demo_out] [--device cuda]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

DET_ROWS = 60000


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True)
    p.add_argument("--frame", type=int, default=0)
    p.add_argument("--masks", nargs="*", default=[], help="camera=coco.json pairs")
    p.add_argument("--vcn_ckpt", default=None)
    p.add_argument("--det_ckpt", default=None)
    p.add_argument("--shift_coor", nargs=3, type=float, default=[0.0, 0.0, 1.8])
    p.add_argument("--score_thresh", type=float, default=0.3)
    p.add_argument("--out", default="demo_out")
    p.add_argument("--device", default="cuda", help="cuda, or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """-> {"instances": isolated, "completed_pts": (K, 3) or None,
    "dropped": scan points replaced, "frame_points": the detector's input
    cloud, "boxes", "scores": the detections kept (or None), "png",
    "html": the files written}."""
    import torch

    from ..data.demo_dataset import DemoObjects
    from ..see.pipeline import SEEVCN
    from ..utils.config import Cfg
    from ..utils.profiling import annotate
    from ..utils.viz import save_bev
    from ..utils.viz3d import save_scene_html

    args = parse_args(argv)
    masks = dict(kv.split("=", 1) for kv in args.masks)
    data_obj = DemoObjects(args.root, masks=masks)
    os.makedirs(args.out, exist_ok=True)

    points = data_obj.get_pointcloud(args.frame)
    completed_pts = None
    frame_points = points
    n_instances = dropped = 0

    if masks and args.vcn_ckpt:
        with annotate("demo/see"):
            see = SEEVCN(Cfg({
                "PC_ISOLATION": {"MIN_LIDAR_PTS": 30, "EPS_SCALING": 4.0,
                                 "MIN_EPS": 0.3, "MAX_EPS": 1.0},
                "SURFACE_COMPLETION": {"VRES": 0.4, "VCN": {
                    "MODEL": "VCN_VC", "CKPT_PATH": args.vcn_ckpt,
                    "NORM_WITH_GT": False, "SEL_K_NEAREST": 30,
                    "CLUSTER_EPS": 0.4, "BATCH_SIZE_LIMIT": 32}}}),
                data_obj=data_obj, device=args.device)
            proj = see.get_det_instances(args.frame)
            instances = see.isolate_det_pts(proj)
            ret = see.complete_det_pts(instances)
            completed_pts = ret["all_instances"]
            frame_points = see.replace_with_completed_pts(points, completed_pts)
            n_instances, dropped = len(instances), see.last_stats["dropped"]
        print(f"completed {len(instances)} instances "
              f"({0 if completed_pts is None else len(completed_pts)} pts)")

    boxes = scores = None
    rows_cut = 0
    if args.det_ckpt:
        from ..models.detectors import configs as DC
        from ..models.detectors.second import build_detector
        from ..see.frame import detect_stage
        from ..utils.ckpt import load_detector_checkpoint

        with annotate("demo/detector"), torch.no_grad():
            cfg = DC.mini_detector_cfg()
            model, _ = build_detector(cfg, load_detector_checkpoint(args.det_ckpt),
                                      device=args.device)
            shift = np.asarray(args.shift_coor, np.float32)
            pts = frame_points[:, :3] + shift
            p = np.zeros((DET_ROWS, 3), np.float32)
            n = min(len(pts), DET_ROWS)
            p[:n] = pts[:n]
            valid = np.zeros(DET_ROWS, bool)
            valid[:n] = True
            rows_cut = len(pts) - n
            if rows_cut:
                print(f"the detector's {DET_ROWS}-row input dropped the frame's last "
                      f"{rows_cut} points")
            post, _ = detect_stage(model, cfg, torch.from_numpy(p), torch.from_numpy(valid),
                                   device=args.device)
            pred_scores = post["pred_scores"][0].cpu().numpy()
            m = post["pred_mask"][0].cpu().numpy() & (pred_scores > args.score_thresh)
            boxes = post["pred_boxes"][0].cpu().numpy()[m]
            boxes[:, :3] -= np.asarray(args.shift_coor)
            scores = pred_scores[m]
        print(f"detected {len(boxes)} objects")

    with annotate("demo/plots"):
        path = save_bev(os.path.join(args.out, f"frame_{args.frame:06d}.png"),
                        frame_points, boxes=boxes, scores=scores, completed=completed_pts)
        print(f"wrote {path}")
        html = save_scene_html(os.path.join(args.out, f"frame_{args.frame:06d}.html"),
                               frame_points, ref_boxes=boxes, ref_scores=scores)
        print(f"wrote {html}")
    return {"instances": n_instances, "completed_pts": completed_pts, "dropped": dropped,
            "frame_points": frame_points, "boxes": boxes, "scores": scores,
            "rows_cut": rows_cut, "png": path, "html": html}


if __name__ == "__main__":
    main()
