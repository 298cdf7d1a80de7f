"""OPTIMIZATION's adam_onecycle (OpenPCDet's train_utils/optimization):
AdamW, whose learning rate rises along a cosine from LR / DIV_FACTOR to LR
over the first PCT_START of the steps and falls along a cosine to LR /
(DIV_FACTOR * 1e4) by the last, while Adam's b1 falls from MOMS[0] to
MOMS[1] and rises back. The warm-up ends at round(PCT_START * steps),
kept within [1, steps - 1]. Before each update the gradients are scaled
down to GRAD_NORM_CLIP where their global norm reaches it. Step ``count``
uses the schedules at ``count``."""
from __future__ import annotations

import math

import torch


def onecycle(total_steps: int, low: float, peak: float, end: float, pct_start: float):
    """count -> low, cosine up to ``peak`` at the warm-up's end, cosine to
    ``end`` at total_steps, constant after."""
    t = max(int(total_steps), 2)
    warm = min(max(int(round(pct_start * t)), 1), t - 1)

    def at(count: int) -> float:
        if count < warm:
            a, b, pct = low, peak, count / warm
        elif count < t:
            a, b, pct = peak, end, (count - warm) / (t - warm)
        else:
            return end
        return b + (a - b) * (math.cos(math.pi * pct) + 1) / 2

    return at


class Optimizer:
    def __init__(self, inner: torch.optim.Optimizer, lr, b1, grad_clip: float):
        self.inner, self.lr, self.b1, self.grad_clip = inner, lr, b1, grad_clip
        self.params = [p for g in inner.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self, count: int) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip > 0:
            norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in self.params))
            if float(norm) >= self.grad_clip:
                for p in self.params:
                    p.grad.mul_(self.grad_clip / norm)
        for g in self.inner.param_groups:
            g["lr"] = self.lr(count)
            g["betas"] = (self.b1(count), g["betas"][1])
        self.inner.step()


def build_optimizer(opt_cfg, total_steps: int, params) -> Optimizer:
    if opt_cfg.OPTIMIZER != "adam_onecycle":
        raise NotImplementedError(opt_cfg.OPTIMIZER)
    lr, div = float(opt_cfg.LR), float(opt_cfg.get("DIV_FACTOR", 10))
    pct = float(opt_cfg.get("PCT_START", 0.4))
    moms = [float(m) for m in opt_cfg.get("MOMS", [0.95, 0.85])]
    lr_at = onecycle(total_steps, lr / div, lr, lr / div / 1e4, pct)
    b1_at = onecycle(total_steps, moms[0], moms[1], moms[0], pct)
    inner = torch.optim.AdamW(list(params), lr=lr_at(0), betas=(b1_at(0), 0.999), eps=1e-8,
                              weight_decay=float(opt_cfg.get("WEIGHT_DECAY", 0.0)))
    return Optimizer(inner, lr_at, b1_at, float(opt_cfg.get("GRAD_NORM_CLIP", 0.0)))
