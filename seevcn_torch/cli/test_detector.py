"""Detector evaluation CLI on one device (port of
seevcn_tpu/cli/test_detector.py; reference tools/test.py:21-209).

``--ckpt`` takes a detector ``.pth`` of either package. Evaluation runs on
DATA_CONFIG_TAR when the config has one (test.py:184-190, the
domain-adaptation entry point: a source-trained checkpoint on the target's
completed clouds), its voxelizer inherited from DATA_CONFIG when it has
none. ``--eval_all`` watches the run's checkpoint directory for
``checkpoint_epoch_*.pth`` and evaluates each new one (test.py:86-132).
``--launcher`` other than ``none`` raises (ROADMAP queue 1, item 6).

Usage:
  python -m seevcn_torch.cli.test_detector --cfg_file <yaml> --ckpt <pth> [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--eval_all", action="store_true")
    p.add_argument("--max_waiting_mins", type=int, default=30)
    p.add_argument("--max_points", type=int, default=150000)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--output_dir", default="output")
    p.add_argument("--launcher", default="none",
                   choices=["none", "jax", "slurm", "auto"],
                   help="multi-process bring-up; the port evaluates on one device")
    p.add_argument("--device", default="cuda", help="the device to run on (cuda, or cpu)")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def eval_config(cfg):
    """-> the config the evaluation builds its model and dataset from:
    ``cfg`` with DATA_CONFIG_TAR (when present) as its DATA_CONFIG, the
    target's CLASS_NAMES if it names its own, and DATA_CONFIG's voxelizer
    appended when the target has none."""
    from ..utils.config import Cfg

    data_cfg = cfg.get("DATA_CONFIG_TAR", cfg.DATA_CONFIG)
    has_vox = any(p.NAME == "transform_points_to_voxels"
                  for p in data_cfg.get("DATA_PROCESSOR", []))
    if not has_vox:
        src_vox = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                   if p.NAME == "transform_points_to_voxels"]
        data_cfg["DATA_PROCESSOR"] = list(data_cfg.get("DATA_PROCESSOR", [])) + src_vox
    out = Cfg(dict(cfg))
    out["DATA_CONFIG"] = data_cfg
    out["CLASS_NAMES"] = list(data_cfg.get("CLASS_NAMES", cfg.CLASS_NAMES))
    return out


def evaluate_ckpt(cfg, ckpt_path, args):
    """-> (AP report, AP dict, recall counts) of the checkpoint."""
    from .. import resolve_device
    from ..data.registry import build_dataset
    from ..models.detectors.second import build_detector
    from ..train.eval import eval_one_epoch
    from .train_detector import load_weights

    ecfg = eval_config(cfg)
    dataset = build_dataset(ecfg.DATA_CONFIG, ecfg.CLASS_NAMES, training=False,
                            max_points=args.max_points)
    if len(dataset) == 0:
        raise ValueError("the eval dataset is empty: check INFO_PATH")
    model, _ = build_detector(ecfg, device=resolve_device(args.device))
    load_weights(model, ckpt_path)
    return eval_one_epoch(model.eval(), ecfg, dataset, batch_size=args.batch_size,
                          max_frames=args.max_frames)


def main(argv=None):
    """One checkpoint: -> (AP report, AP dict, recall counts). With
    ``--eval_all``: -> {checkpoint path: its AP dict} of those evaluated."""
    from ..utils.config import cfg_from_list, cfg_from_yaml_file
    from .train_detector import list_checkpoints

    args = parse_args(argv)
    if args.launcher != "none":
        raise NotImplementedError(f"--launcher {args.launcher}: multi-GPU evaluation is not "
                                  "ported yet (ROADMAP queue 1, item 6)")
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)

    if not args.eval_all:
        if not args.ckpt:
            raise SystemExit("--ckpt is required unless --eval_all")
        return evaluate_ckpt(cfg, args.ckpt, args)

    # watcher loop (test.py:86-132)
    ckpt_dir = os.path.join(args.output_dir, cfg.TAG, args.extra_tag, "ckpt")
    record = os.path.join(ckpt_dir, "eval_list.txt")
    evaluated, results = set(), {}
    if os.path.exists(record):
        with open(record) as f:
            evaluated = set(f.read().split())
    waited = 0.0
    while waited < args.max_waiting_mins * 60:
        todo = [c for c in list_checkpoints(ckpt_dir) if c not in evaluated]
        if not todo:
            time.sleep(30)
            waited += 30
            continue
        waited = 0.0
        for c in todo:
            print(f"evaluating {c}")
            results[c] = evaluate_ckpt(cfg, c, args)[1]
            evaluated.add(c)
            with open(record, "a") as f:
                f.write(c + "\n")
    print("eval_all: no new checkpoints, exiting")
    return results


if __name__ == "__main__":
    main()
