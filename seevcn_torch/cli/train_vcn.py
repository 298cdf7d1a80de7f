"""VCN training CLI (port of seevcn_tpu/cli/train_vcn.py; reference
models/vcn/main.py + tools/runner.py).

Usage:
  python -m seevcn_torch.cli.train_vcn --config <vcn yaml> --data <VC root> \
      [--val_data <VC root>] [--device cuda]
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--data", required=True, help="VC-ShapeNet root dir")
    p.add_argument("--val_data", default=None)
    p.add_argument("--exp_name", default="default")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--work_dir", default="vcn_experiments")
    p.add_argument("--resume", action="store_true",
                   help="parsed for the reference's command line; unused "
                        "(training starts from a fresh net)")
    p.add_argument("--device", default="cuda",
                   help="the device to train on (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    import os

    from ..models.vcn.dataset import VCDataset
    from ..models.vcn.runner import VCNTrainer
    from ..utils.config import cfg_from_yaml_file

    args = parse_args(argv)
    cfg = cfg_from_yaml_file(args.config)
    work_dir = os.path.join(args.work_dir, args.exp_name)
    trainer = VCNTrainer(cfg, work_dir=work_dir, device=args.device)

    train_ds = VCDataset(args.data,
                         transforms_cfg=cfg.get("train_transforms",
                                                [{"callback": "LidarSimulation"}]),
                         n_points=int(cfg.get("n_points", 1024)),
                         n_complete=int(cfg.get("n_complete", 2048)))
    val_ds = VCDataset(args.val_data, n_points=int(cfg.get("n_points", 1024)),
                       n_complete=int(cfg.get("n_complete", 2048))) \
        if args.val_data else None

    return trainer.fit(train_ds, val_ds=val_ds,
                       epochs=args.epochs or int(cfg.get("max_epoch", 100)),
                       batch_size=args.batch_size or int(cfg.get("total_bs", 32)))


if __name__ == "__main__":
    main()
