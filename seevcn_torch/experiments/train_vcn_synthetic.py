"""Train VCN_VC on a procedurally generated VC dataset (port of
scripts/train_vcn_synthetic.py).

The reference's ShapeNet cars are not available, so car-like meshes (a
body box, a cabin box and wheel boxes of varied proportions,
``vc_shapenet.procedural_car_mesh``) stand in, written as ``.obj`` files
and placed, raycast and paired by the port's VC-ShapeNet generator. The
checkpoint (``ckpt-last.pth``) serves ``measure_maskpath_impact --vcn_ckpt``,
so that the DET-vs-GT comparison runs with car-shaped completions.

Usage: python -m seevcn_torch.experiments.train_vcn_synthetic [--epochs 8] [--cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .. import resolve_device
from ..models.vcn import vc_shapenet as VS
from ..models.vcn.dataset import VCDataset
from ..models.vcn.runner import VCNTrainer
from .train_vcn_da import vcn_cfg


def write_car_obj(path, rng):
    """A procedural car mesh as .obj in the ShapeNet frame (y up, -z
    forward): ``load_obj`` + ``normalize_car_mesh`` apply the ShapeNet ->
    lidar axis swap, so lidar-frame vertices here would train on sideways
    cars."""
    verts, faces = VS.procedural_car_mesh(rng)
    with open(path, "w") as f:
        for x, y, z in verts:          # lidar (x fwd, z up) -> shapenet
            f.write(f"v {y:.4f} {z:.4f} {-x:.4f}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train VCN_VC on procedural cars.")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--meshes", type=int, default=6)
    ap.add_argument("--poses", type=int, default=60)
    ap.add_argument("--out", default="runs/vcn_vc_synth")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    rng = np.random.RandomState(0)
    mesh_dir = os.path.join(args.out, "meshes")
    data_dir = os.path.join(args.out, "vc_data")
    os.makedirs(mesh_dir, exist_ok=True)
    meshes = []
    for i in range(args.meshes):
        p = os.path.join(mesh_dir, f"car{i}.obj")
        write_car_obj(p, rng)
        meshes.append(p)

    if not os.path.exists(os.path.join(data_dir, "model0000")):
        poses = []
        for _ in range(args.poses):
            d = rng.uniform(6, 35)
            ang = rng.uniform(-0.5, 0.5)
            poses.append(np.array([d * np.cos(ang), d * np.sin(ang), 0.0,
                                   rng.uniform(3.8, 4.6), 0, 0,
                                   rng.uniform(-np.pi, np.pi)]))
        VS.generate_vc_dataset(meshes, poses, data_dir, n_complete=4096,
                               rng=np.random.default_rng(1))

    cfg = vcn_cfg("VCN_VC", {"type": "StepLR", "kwargs": {"step_size": 40, "gamma": 0.7}})
    train_ds = VCDataset(data_dir, transforms_cfg=[{"callback": "LidarSimulation"}],
                         n_points=1024, n_complete=2048)
    val_ds = VCDataset(data_dir, n_points=1024, n_complete=2048)
    print(f"dataset: {len(train_ds)} samples", flush=True)
    trainer = VCNTrainer(cfg, work_dir=args.out, device=dev)
    state = trainer.fit(train_ds, val_ds, epochs=args.epochs, batch_size=args.batch_size,
                        val_freq=max(args.epochs, 1))
    print(f"saved {args.out}/ckpt-last.pth", flush=True)
    return trainer, state


if __name__ == "__main__":
    main()
