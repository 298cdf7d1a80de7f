"""Generate the domain-adaptation sets (port of scripts/da_generate.py;
host numpy, as there).

Products (under ``--out``, runs/da by default):
  src_train.npz   64-beam source frames (detector training)
  src_val.npz     64-beam source frames (in-domain eval)
  tgt_val.npz     16-beam target frames (the domain-shift eval)
  vc_data/        a VCDataset tree of car partial / complete pairs drawn
                  from the same frame distribution at 64, 16 and 32 beams

The beam-count shift (64 -> 16 over the same elevation span) is the
scan-pattern axis SEE-VCN exists to bridge. The frames are the port's
``data/synth_da.py`` and the surfaces ``vc_shapenet.sample_surface``, both
the JAX package's draws one for one, so every array equals the script's.

Usage: python -m seevcn_torch.experiments.da_generate [--out runs/da]
           [--n_train 512] [--n_val 64] [--n_tgt 128] [--vc_frames 150]
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

from ..data.synth_da import generate_da_set, spinning_lidar_frame
from ..models.vcn import vc_shapenet as VS


def gen_set(path, seed, n, beams, azim_res):
    """``n`` frames of ``beams`` beams from ``seed`` -> ``path``, an .npz of
    points, valid, gt_boxes, gt_mask and n_beams; an existing file is kept."""
    if os.path.exists(path):
        print(f"{path} exists, skip", flush=True)
        return
    t0 = time.time()
    pts, val, gtb, gtm = generate_da_set(
        seed, n, beams, azim_res_deg=azim_res,
        progress=lambda i, n: print(f"  {path}: {i}/{n} "
                                    f"({time.time()-t0:.0f}s)", flush=True))
    np.savez_compressed(path, points=pts, valid=val, gt_boxes=gtb,
                        gt_mask=gtm, n_beams=beams)
    print(f"wrote {path}: {pts.shape} in {time.time()-t0:.0f}s", flush=True)


def gen_vc(out_dir, seed, n_frames_per_beamcount, min_pts=30, n_complete=4096):
    """VC dataset in the VCDataset layout (``model%04d/{partial,surface}/000.npy``
    and ``labels.pkl``) from spinning-lidar frames at 64, 16 and 32 beams:
    each car of at least ``min_pts`` points, with ``n_complete`` points of
    its placed mesh's surface. An existing tree is kept."""
    if os.path.exists(os.path.join(out_dir, "model0000")):
        print(f"{out_dir} exists, skip", flush=True)
        return
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    srng = np.random.default_rng(seed + 1)
    k = 0
    t0 = time.time()
    for beams in (64, 16, 32):
        for _ in range(n_frames_per_beamcount):
            f = spinning_lidar_frame(rng, n_beams=beams, return_car_pts=True)
            for car in f["cars"]:
                if len(car["pts"]) < min_pts:
                    continue
                d = os.path.join(out_dir, f"model{k:04d}")
                os.makedirs(os.path.join(d, "partial"), exist_ok=True)
                os.makedirs(os.path.join(d, "surface"), exist_ok=True)
                np.save(os.path.join(d, "partial", "000.npy"),
                        car["pts"].astype(np.float32))
                # the view-frame complete surface of this placed mesh
                surf = VS.sample_surface(car["verts"], car["faces"], n_complete,
                                         rng=srng)
                np.save(os.path.join(d, "surface", "000.npy"), surf)
                with open(os.path.join(d, "labels.pkl"), "wb") as fh:
                    pickle.dump({"000": {"gtbox": car["gtbox"]}}, fh)
                k += 1
        print(f"vc_data: beams={beams} done, {k} objects "
              f"({time.time()-t0:.0f}s)", flush=True)
    print(f"wrote {out_dir}: {k} objects", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Generate the DA sets and the VC data.")
    ap.add_argument("--out", default="runs/da")
    ap.add_argument("--n_train", type=int, default=512)
    ap.add_argument("--n_val", type=int, default=64)
    ap.add_argument("--n_tgt", type=int, default=128)
    ap.add_argument("--vc_frames", type=int, default=150)
    ap.add_argument("--azim_res", type=float, default=0.25)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    gen_set(os.path.join(args.out, "tgt_val.npz"), 300, args.n_tgt, 16, args.azim_res)
    gen_set(os.path.join(args.out, "src_val.npz"), 200, args.n_val, 64, args.azim_res)
    gen_set(os.path.join(args.out, "src_train.npz"), 100, args.n_train, 64,
            args.azim_res)
    gen_vc(os.path.join(args.out, "vc_data"), 400, args.vc_frames)
    print("ALL DONE", flush=True)


if __name__ == "__main__":
    main()
