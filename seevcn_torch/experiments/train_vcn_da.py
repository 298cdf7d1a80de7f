"""Train VCN_VC (or VCN_CN) on the DA-distribution VC dataset (port of
scripts/train_vcn_da.py).

The VC data are car partial / complete pairs from the same spinning-lidar
frame distribution the DA experiment completes (``da_generate.gen_vc``:
64, 32 and 16-beam scans with exact cross-car occlusion), so that VCN
trains on what it completes. Adam at 1e-3 with a cosine one-cycle
schedule, which decays to about 0 by the end of whatever budget is given;
LidarSimulation still applies on the training side (further beam
reduction, a wider density range). Every 10th model is held out for
validation. The port writes the reference's VCN ``.pth``
(``ckpt-best.pth``, ``ckpt-last.pth``), not the JAX runner's ``.pkl``.

Usage: python -m seevcn_torch.experiments.train_vcn_da [--epochs 60]
           [--data runs/da/vc_data] [--model VCN_VC|VCN_CN] [--cpu]
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from ..models.vcn.dataset import VCDataset
from ..models.vcn.runner import VCNTrainer
from ..utils.config import Cfg

#: the loss terms and weights of each net: VCN_CN (the reference's
#: source-domain, GT-canonical model) trains the coarse and partial terms only
LOSSES = {"VCN_VC": (["coarse", "partial", "translation", "rotation", "dims"],
                     [1.0, 1.0, 10.0, 1.0, 1.0]),
          "VCN_CN": (["coarse", "partial"], [1.0, 1.0])}


def vcn_cfg(model: str, scheduler: dict) -> Cfg:
    """The trainer config of ``model``: its losses, Adam at 1e-3, ``scheduler``."""
    losses, weights = LOSSES[model]
    return Cfg({"model": {"NAME": model}, "losses": losses, "loss_weights": weights,
                "optimizer": {"type": "Adam", "kwargs": {"lr": 1e-3}},
                "scheduler": scheduler})


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train VCN on the DA VC data.")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--data", default="runs/da/vc_data")
    ap.add_argument("--out", default="runs/vcn_da")
    ap.add_argument("--model", default="VCN_VC", choices=["VCN_VC", "VCN_CN"],
                    help="VCN_CN trains the reference's source-domain "
                         "(GT-canonical) model: coarse+partial losses only")
    ap.add_argument("--val_freq", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")

    cfg = vcn_cfg(args.model, {"type": "OneCycleLR", "kwargs": {}})
    train_ds = VCDataset(args.data, transforms_cfg=[{"callback": "LidarSimulation"}],
                         n_points=1024, n_complete=2048)
    val_ds = VCDataset(args.data, n_points=1024, n_complete=2048)
    train_ds.samples = [s for i, s in enumerate(train_ds.samples) if i % 10 != 0]
    val_ds.samples = [s for i, s in enumerate(val_ds.samples) if i % 10 == 0]
    print(f"dataset: {len(train_ds)} train / {len(val_ds)} val", flush=True)

    trainer = VCNTrainer(cfg, work_dir=args.out, device=dev)
    state = trainer.fit(train_ds, val_ds, epochs=args.epochs, batch_size=args.batch_size,
                        val_freq=args.val_freq)
    print(f"saved {args.out}/ckpt-last.pth (best: {args.out}/ckpt-best.pth)", flush=True)
    return trainer, state


if __name__ == "__main__":
    main()
