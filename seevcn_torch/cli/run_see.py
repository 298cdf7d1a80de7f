"""SEE preprocessing CLI: complete every frame's cars and write .pcd + infos
(port of seevcn_tpu/cli/run_see.py; reference
see/surface_completion/sc_multiproc.py:17-119).

The GT path (source domain) and the DET path (target domain), resume by
output file, a line a frame with its time, the instances isolated and
completed and the scan points dropped. One process drives the device; with
``--workers N`` the frame loop is a thread pool (the reference's process
pool), so host IO (cloud and mask load, projection, .pcd write) overlaps
across frames while the device work queues on the card. The outputs are
disjoint files, so resume by file still holds. The demo, KITTI,
nuScenes, Waymo and Custom (Baraja) adapters run.

Usage:
  python -m seevcn_torch.cli.run_see --cfg_file <SEE yaml> [--frames N]
                                     [--path gt|det] [--workers 4] [--device cuda]
"""
from __future__ import annotations

import argparse
import copy
import os
import threading
import time

import numpy as np

def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--path", default="det", choices=["gt", "det"])
    p.add_argument("--save_dir", default=None)
    p.add_argument("--workers", type=int, default=1,
                   help="frame-level worker threads (sc_multiproc analog)")
    p.add_argument("--device", default="cuda",
                   help="the device of the batched steps (cuda, or cpu)")
    return p.parse_args(argv)


def build_data_obj(cfg):
    name = cfg.DATA.get("DATASET", "demo").lower()
    if name == "demo":
        from ..data.demo_dataset import DemoObjects

        masks = {c: p for c, p in cfg.DATA.get("MASKS", {}).items()}
        return DemoObjects(cfg.DATA.ROOT, camera_channels=cfg.DATA.get(
            "CAMERA_CHANNELS", ["front"]), masks=masks)
    if name == "kitti":
        from ..data.kitti.see_adapter import KittiObjects

        return KittiObjects(cfg.DATA)
    from ..data.see_adapters import SEE_ADAPTERS

    if name in SEE_ADAPTERS:
        return SEE_ADAPTERS[name](cfg.DATA)
    raise NotImplementedError(name)


def main(argv=None) -> dict:
    """-> {"frames": {frame index: {"s", "isolated", "completed",
    "dropped", "path"}} of the frames written, "infos": the updated infos
    pkl or None}."""
    from ..geom.pcd_io import write_pcd
    from ..see.pipeline import SEEVCN
    from ..utils.config import cfg_from_yaml_file

    args = parse_args(argv)
    cfg = cfg_from_yaml_file(args.cfg_file)
    data_obj = build_data_obj(cfg)
    n = args.frames or len(data_obj)
    shared = SEEVCN(cfg, data_obj=data_obj, device=args.device)
    local = threading.local()

    def pipeline():
        """The shared pipeline (its VCN, its adapter), with a last_stats of
        each worker thread's own."""
        if not hasattr(local, "see"):
            local.see = copy.copy(shared)
        return local.see

    def frame_out_path(idx):
        if args.save_dir:
            return os.path.join(args.save_dir, f"{data_obj.frames[idx]}.pcd")
        # adapter-defined location (training/vcn_<tag>/<frame>)
        return data_obj.get_save_fname(idx) + ".pcd"

    def process_one(idx):
        out_path = frame_out_path(idx)
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        if os.path.exists(out_path):  # resume by file (sc_multiproc.py:20-25)
            return None
        pipe = pipeline()
        t0 = time.time()
        if args.path == "det":
            completed = pipe.process_det_frame(idx)
        else:
            completed = pipe.process_gt_frame(data_obj.get_pointcloud(idx),
                                              data_obj.get_gt_boxes(idx))
        write_pcd(out_path, completed)
        rec = {"s": time.time() - t0, **pipe.last_stats, "path": out_path}
        print(f"frame {idx}: {rec['s']:.3f}s, {rec.get('isolated', 0)} instances isolated, "
              f"{rec.get('completed', 0)} completed, {rec.get('dropped', 0)} scan points "
              f"dropped -> {out_path}", flush=True)
        return idx, rec

    if args.workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.workers) as pool:
            done = [r for r in pool.map(process_one, range(n)) if r is not None]
    else:
        done = [r for r in map(process_one, range(n)) if r is not None]
    if done:
        print(f"avg time/frame: {np.mean([r['s'] for _, r in done]):.3f}s over "
              f"{len(done)} frames")
    infos = data_obj.update_infos() if hasattr(data_obj, "update_infos") else None
    print("infos:", infos)
    return {"frames": dict(done), "infos": infos}


if __name__ == "__main__":
    main()
