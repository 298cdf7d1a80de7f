"""VCN training runner (port of seevcn_tpu/models/vcn/runner.py; reference
see/.../models/vcn/tools/runner.py:24-549 and its optimizer and checkpoint
helpers).

One train step is the net in training mode, its loss terms weighted by the
config's ``losses`` / ``loss_weights`` lists, the backward and the
scheduled update (with ``step_per_update`` gradient accumulation).
Validation runs the metric battery and keeps the best CDL1 checkpoint. A
checkpoint is the reference's VCN ``.pth`` layout (``{"base_model":
state_dict, "epoch"}``) plus the best metric so far, written
atomically. The validation images are PNGs written from a numpy raster, so
no plotting library is needed.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch
from torch import nn

from ... import resolve_device
from ...train.optim import build_vcn_optimizer
from ...train.train import TrainState, apply_gradients
from ...utils.viz3d import save_scene_html
from ..modules.common import lecun_normal
from .dataset import VCDataset
from .metrics import MetricAccumulator
from .nets import build_vcn

@torch.no_grad()
def init_vcn_weights(model: nn.Module, generator: torch.Generator) -> None:
    """A fresh net at flax's default init: every Conv1d / Linear weight
    lecun normal, biases zero, batch norm at identity (scale 1, shift 0,
    running mean 0 and variance 1)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            m.weight.copy_(lecun_normal(m.weight.shape, m.weight[0].numel(), generator))
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()


def _png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG (no filter)."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def _bev_panels(clouds, size: int = 300, margin: int = 10) -> np.ndarray:
    """Side-by-side bird's-eye scatter panels, one per (N, 3+) cloud: x to
    the right, y up, equal aspect, each panel scaled to its own cloud."""
    img = np.full((size, size * len(clouds), 3), 255, np.uint8)
    for i, pts in enumerate(clouds):
        xy = np.asarray(pts, np.float64)[:, :2]
        if len(xy):
            lo, hi = xy.min(0), xy.max(0)
            scale = (size - 2 * margin - 1) / max(float((hi - lo).max()), 1e-6)
            col = (margin + (xy[:, 0] - lo[0]) * scale).astype(int)
            row = (size - 1 - margin - (xy[:, 1] - lo[1]) * scale).astype(int)
            img[row, i * size + col] = (31, 119, 180)
        img[:, i * size] = 160
    return img


class VCNTrainer:
    """Trains the VCN net named by the config's ``model`` block on one
    device, writing its checkpoints and validation images under
    ``work_dir``. Runs on CUDA unless ``device`` names the CPU."""

    def __init__(self, cfg, work_dir: str = "./vcn_runs", device="cuda"):
        self.cfg = cfg
        self.work_dir = work_dir
        self.device = resolve_device(device)
        os.makedirs(work_dir, exist_ok=True)
        mcfg = cfg.model if "model" in cfg else cfg.MODEL
        name = mcfg["NAME"] if isinstance(mcfg, dict) and "NAME" in mcfg else mcfg
        self.model = build_vcn(name if isinstance(name, str) else name["NAME"])
        self.loss_names = list(cfg.get("losses", ["coarse", "partial"]))
        self.loss_weights = [float(w) for w in cfg.get(
            "loss_weights", [1.0] * len(self.loss_names))]
        self.best = np.inf

    def init_state(self, total_steps: int, seed: int = 0) -> TrainState:
        """The net at flax's default init from ``seed``, on the device and in
        training mode, with the optimizer over ``total_steps`` updates."""
        init_vcn_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device).train()
        opt = build_vcn_optimizer(self.cfg.get("optimizer"), self.cfg.get("scheduler"),
                                  total_steps, self.model.parameters(),
                                  every_k=int(self.cfg.get("step_per_update", 1)))
        return TrainState(self.model, opt)

    def to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def train_step(self, state: TrainState, batch: dict) -> dict:
        """One step on a batch of tensors on the device (input (B, N, 3),
        complete (B, M, 3), gt_boxes (B, 7)): -> {"loss", **terms},
        detached."""
        in_dict = {k: batch[k] for k in ("input", "complete", "gt_boxes")}
        state.model.train()
        losses = state.model.loss(state.model(in_dict), in_dict)
        total = sum(w * losses[n] for n, w in zip(self.loss_names, self.loss_weights)
                    if n in losses)
        apply_gradients(state, total)
        return {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict) -> dict:
        state.model.eval()
        return state.model({"input": batch["input"], "gt_boxes": batch["gt_boxes"]})

    # ------------------------------------------------------------------ #
    def validate(self, state: TrainState, dataset: VCDataset,
                 batch_size: int = 32) -> dict:
        acc = MetricAccumulator()
        for batch in dataset.batches(batch_size, shuffle=False):
            tb = self.to_device(batch)
            out = self.eval_step(state, tb)
            acc.update(out["coarse"], tb["complete"], tb["gt_boxes"],
                       batch["num_pts"], out.get("reg_rot"), out.get("reg_centre"),
                       input_pts=tb["input"])
        return acc.summary()

    def fit(self, train_ds: VCDataset, val_ds: VCDataset | None = None,
            epochs: int = 1, batch_size: int = 32, val_freq: int = 1,
            log_every: int = 50, logger=print) -> TrainState:
        steps_per_epoch = max(len(train_ds) // batch_size, 1)
        state = None
        for ep in range(epochs):
            for it, batch in enumerate(train_ds.batches(batch_size)):
                if state is None:
                    state = self.init_state(epochs * steps_per_epoch)
                metrics = self.train_step(state, self.to_device(batch))
                if it % log_every == 0:
                    logger(f"ep {ep} it {it}: " + " ".join(
                        f"{k}={float(v):.4f}" for k, v in metrics.items()))
            if val_ds is not None and (ep + 1) % val_freq == 0:
                summary = self.validate(state, val_ds, batch_size)
                logger(f"ep {ep} val: {summary}")
                self.render_val_examples(state, val_ds, epoch=ep)
                if summary.get("CDL1", np.inf) < self.best:
                    self.best = summary["CDL1"]
                    self.save_checkpoint(state, "ckpt-best", epoch=ep)
            self.save_checkpoint(state, "ckpt-last", epoch=ep)
        return state

    def render_val_examples(self, state: TrainState, dataset: VCDataset,
                            epoch: int = 0, n_examples: int = 3):
        """Per-validation images (the reference logs input / prediction /
        complete clouds to TensorBoard, runner.py:252-268): a 3-panel BEV PNG
        (input | prediction | complete) per example under work_dir/val_vis/,
        and one interactive HTML scene."""
        out_dir = os.path.join(self.work_dir, "val_vis")
        os.makedirs(out_dir, exist_ok=True)
        batch = next(dataset.batches(min(n_examples, 8), shuffle=False))
        coarse = self.eval_step(state, self.to_device(batch))["coarse"].cpu().numpy()
        for i in range(min(n_examples, coarse.shape[0])):
            img = _bev_panels([batch["input"][i], coarse[i], batch["complete"][i]])
            with open(os.path.join(out_dir, f"ep{epoch:03d}_{i}.png"), "wb") as f:
                f.write(_png_bytes(img))
        save_scene_html(os.path.join(out_dir, f"ep{epoch:03d}.html"),
                        np.concatenate([coarse[0], batch["input"][0]]),
                        gt_boxes=batch["gt_boxes"][:1])

    # ------------------------------------------------------------------ #
    def save_checkpoint(self, state: TrainState, name: str, epoch: int = 0) -> str:
        """Write work_dir/<name>.pth in the reference's VCN layout, with the
        epoch and the best CDL1 so far; atomic (tmp + replace), so a kill
        mid-write leaves the previous checkpoint whole."""
        path = os.path.join(self.work_dir, f"{name}.pth")
        sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        torch.save({"base_model": sd, "epoch": epoch, "best_metrics": float(self.best)},
                   path + ".tmp")
        os.replace(path + ".tmp", path)
        return path

    def load_checkpoint(self, path: str) -> dict:
        """-> {"base_model", "epoch", "best_metrics"}, tensors on the CPU."""
        return torch.load(path, map_location="cpu", weights_only=False)
