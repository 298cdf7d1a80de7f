"""Detector training CLI on one device (port of
seevcn_tpu/cli/train_detector.py; reference tools/train.py:21-203).

The reference's flags (--cfg_file, --batch_size, --epochs, --ckpt,
--extra_tag, --set, --fix_random_seed, --max_ckpt_save_num), and auto-resume
from the newest checkpoint of the run directory. The dataset is
DATA_CONFIG's (``data/registry.build_dataset``), its batches assembled on
``BackgroundLoader``'s threads and uploaded to the device, augmented there
(``augment_on_device``), then ``train/train.train_step``.

Checkpoints are OpenPCDet's ``.pth`` only (``checkpoint_epoch_<ep>.pth``,
``utils/ckpt.save_detector_checkpoint``); the JAX package's flax ``.pkl``
has no meaning without flax. A resume restores the weights, the epoch and
the step from the newest one, with a fresh optimizer, as the JAX package's
resume does; the oldest are removed past ``--max_ckpt_save_num``. The
random draws (augmentation, RoI sampling, dropout) come from
``torch.Generator``s seeded from the epoch. ``--launcher`` other than
``none`` raises: multi-GPU training is not ported yet (ROADMAP queue 1,
item 6).

Usage:
  python -m seevcn_torch.cli.train_detector --cfg_file <pcdet yaml> [--device cuda]
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import time

import numpy as np
import torch

#: the base of every generator's seed (the JAX package's PRNGKey(42))
SEED = 42


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--extra_tag", default="default")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--fix_random_seed", action="store_true")
    p.add_argument("--max_ckpt_save_num", type=int, default=30)
    p.add_argument("--max_points", type=int, default=150000)
    p.add_argument("--output_dir", default="output")
    p.add_argument("--launcher", default="none",
                   choices=["none", "jax", "slurm", "auto"],
                   help="multi-process bring-up; the port trains on one device")
    p.add_argument("--device", default="cuda", help="the device to train on (cuda, or cpu)")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def checkpoint_epoch(path: str) -> int:
    return int(re.search(r"checkpoint_epoch_(\d+)\.pth$", path).group(1))


def list_checkpoints(ckpt_dir: str) -> list:
    """The run's ``checkpoint_epoch_<ep>.pth`` files, oldest epoch first."""
    return sorted(glob.glob(os.path.join(ckpt_dir, "checkpoint_epoch_*.pth")),
                  key=checkpoint_epoch)


def load_weights(model, path: str) -> dict:
    """A detector ``.pth`` of either package into ``model`` (strict): the
    reference layout through ``detector_state_dict_from_torch``, or, for a
    detector whose modules that reader does not keep, the file's state dict
    as it is. -> the checkpoint dict (epoch, it, ...)."""
    from ..utils.ckpt import detector_state_dict_from_torch, load_torch_checkpoint

    ckpt = load_torch_checkpoint(path)
    raw = ckpt.get("model_state", ckpt)
    sd = detector_state_dict_from_torch(raw)
    if set(sd) != set(model.state_dict()):
        sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in raw.items()}
    model.load_state_dict(sd, strict=True)
    return ckpt


def main(argv=None) -> dict:
    """-> {"state": the TrainState, "start_epoch", "epochs", "ckpts": the
    run's checkpoints after rotation, "losses": the mean loss of each epoch
    trained, "steps_s": seconds a step, "resumed": None, or {"path", "epoch",
    "step", "state_dict": the weights as read, on the CPU}}."""
    from .. import resolve_device
    from ..data.loader import BackgroundLoader
    from ..data.registry import build_dataset
    from ..models.detectors.second import build_detector
    from ..train.train import create_train_state, train_step
    from ..utils.ckpt import save_detector_checkpoint
    from ..utils.config import cfg_from_list, cfg_from_yaml_file

    args = parse_args(argv)
    if args.launcher != "none":
        raise NotImplementedError(f"--launcher {args.launcher}: multi-GPU training is not "
                                  "ported yet (ROADMAP queue 1, item 6)")
    cfg = cfg_from_yaml_file(args.cfg_file)
    if args.set_cfgs:
        cfg_from_list(args.set_cfgs, cfg)
    dev = resolve_device(args.device)
    if args.fix_random_seed:
        np.random.seed(666)
        torch.manual_seed(666)

    ckpt_dir = os.path.join(args.output_dir, cfg.TAG, args.extra_tag, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    batch_size = args.batch_size or int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    epochs = args.epochs or int(cfg.OPTIMIZATION.NUM_EPOCHS)

    dataset = build_dataset(cfg.DATA_CONFIG, cfg.CLASS_NAMES, training=True,
                            max_points=args.max_points)
    if len(dataset) == 0:
        raise ValueError("the dataset is empty: check DATA_PATH and INFO_PATH")
    model, _ = build_detector(cfg, device=dev)
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    state = create_train_state(model, cfg.OPTIMIZATION, steps_per_epoch * epochs)

    # auto-resume (train.py:130-140): weights, epoch and step; a fresh optimizer
    existing = list_checkpoints(ckpt_dir)
    start_epoch, resumed = 0, None
    if args.ckpt or existing:
        path = args.ckpt or existing[-1]
        ckpt = load_weights(model, path)
        state.step = int(ckpt.get("it", 0))
        start_epoch = int(ckpt.get("epoch", 0)) + 1
        resumed = {"path": path, "epoch": start_epoch - 1, "step": state.step,
                   "state_dict": {k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()}}
        print(f"resumed from {path} at epoch {start_epoch}")

    loader = BackgroundLoader(dataset, batch_size, num_workers=4, seed=start_epoch,
                              device=dev)
    losses, step_s = [], []
    for ep in range(start_epoch, epochs):
        dataset.set_epoch(ep)
        seeds = torch.randint(0, 2 ** 62, (max(len(loader), 1), batch_size + 1),
                              generator=torch.Generator().manual_seed(SEED * 100003 + ep))
        ep_losses = []
        for it, batch in enumerate(loader):
            t0 = time.perf_counter()
            if dataset.aug_list:
                gens = [torch.Generator(device=dev).manual_seed(int(s)) for s in seeds[it, 1:]]
                batch = dataset.augment_on_device(batch, gens)
            metrics = train_step(state, batch["points"], batch["points_valid"],
                                 batch["gt_boxes"],
                                 torch.Generator(device=dev).manual_seed(int(seeds[it, 0])))
            ep_losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
            if it % 50 == 0:
                print(f"epoch {ep} it {it}: " + " ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()), flush=True)
        losses.append(float(np.mean(ep_losses)) if ep_losses else float("nan"))
        path = os.path.join(ckpt_dir, f"checkpoint_epoch_{ep}.pth")
        save_detector_checkpoint(path, model, epoch=ep, it=state.step)
        # rotate old checkpoints (train_utils.py:123-135)
        for old in list_checkpoints(ckpt_dir)[:-args.max_ckpt_save_num]:
            os.remove(old)
    print("training done")
    return {"state": state, "start_epoch": start_epoch, "epochs": epochs,
            "ckpts": list_checkpoints(ckpt_dir), "losses": losses, "steps_s": step_s,
            "resumed": resumed}


if __name__ == "__main__":
    main()
