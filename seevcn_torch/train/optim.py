"""Optimizers and learning-rate schedules from the reference's OPTIMIZATION
config (port of seevcn_tpu/train/optim.py; reference detector3d/tools/
train_utils/optimization/).

``adam_onecycle``, the optimizer of every shipped detector, is AdamW with a
one-cycle cosine learning rate and Adam's b1 cycled against it; ``adam``,
``adamw`` and ``sgd`` take a step decay with optional LR_CLIP and LR_WARMUP.
The schedules are the port's own copies of optax's formulas
(``cosine_onecycle_schedule``, ``piecewise_constant_schedule``), evaluated
at the step count before it is incremented, as optax's
``inject_hyperparams`` does: step 0 uses lr(0) and b1(0). Gradients are
clipped to GRAD_NORM_CLIP by optax's ``clip_by_global_norm`` rule, scaled
by max / |g| only when |g| >= max, with no epsilon.

One deliberate departure: the reference builds b1 as a one-cycle with
``final_div_factor = MOMS[1] / MOMS[0]``, which ends at 0.85 / (0.85 /
0.95)^2 = 1.0618, not at 0.95; past b1 = 1 Adam's bias correction 1 - b1^t
crosses 0 and the update spikes. The port follows the intent stated
there, high -> low -> high: b1 runs 0.95 -> 0.85 -> 0.95, the same as the
reference over the first phase.

``build_vcn_optimizer`` is VCN's (port of seevcn_tpu/models/vcn/runner.py:
build_vcn_optimizer): Adam, AdamW or SGD with StepLR or OneCycleLR, and
``MultiSteps`` its gradient accumulation (the reference's
``step_per_update``, optax.MultiSteps in the JAX package).

``build_seg2d_optimizer`` is the Mask R-CNN recipe's
(seevcn_tpu/cli/train_seg2d.py: ``clip_by_global_norm(10)`` then
``adamw(warmup_cosine_decay_schedule(0, lr, warmup, decay_steps))``).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    """optax's one-cycle: a cosine from peak / div_factor up to peak at
    int(pct_start * transition_steps), then down to peak / (div_factor *
    final_div_factor) at transition_steps, constant after."""
    if transition_steps <= 0:
        raise ValueError("a one-cycle schedule needs transition_steps > 0")
    boundaries_and_scales = {int(pct_start * transition_steps): div_factor,
                             int(transition_steps): 1.0 / (div_factor * final_div_factor)}
    boundaries, scales = zip(*sorted(boundaries_and_scales.items()))
    bounds = np.array((0,) + boundaries)
    values = np.cumprod(np.array((peak_value / div_factor,) + scales))

    def schedule(count: int) -> float:
        for i in range(len(boundaries)):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return float(end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1))
        return float(values[-1])

    return schedule


def piecewise_constant_schedule(init_value: float, boundaries_and_scales=None):
    """optax's: init_value times every scale whose boundary count has been
    reached."""
    def schedule(count: int) -> float:
        v = init_value
        for threshold, scale in sorted((boundaries_and_scales or {}).items()):
            if count >= threshold:
                v = v * scale
        return float(v)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax's: linear from init_value to peak_value over warmup_steps, then
    a cosine from peak_value to end_value reached at decay_steps, which
    counts the warm-up; end_value after. Read at the count before the
    update, so step 0 runs at init_value."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("a warmup-cosine schedule needs decay_steps > warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return float((init_value - peak_value) * frac + peak_value)
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return float(peak_value * ((1.0 - alpha) * cosine + alpha))

    return schedule


def _safe_cosine_onecycle(total_steps: int, peak_value: float, pct_start: float,
                          div_factor: float, final_div_factor: float):
    """The one-cycle with its warm-up clamped to [1, total_steps - 1] whole
    steps (at 2 steps and pct_start 0.4 the floored boundary would be 0 and
    the schedule NaN), pct_start re-derived so the floor lands there."""
    t = max(int(total_steps), 2)
    warm = min(max(int(round(pct_start * t)), 1), t - 1)
    return cosine_onecycle_schedule(t, peak_value, pct_start=(warm + 0.5) / t,
                                    div_factor=div_factor,
                                    final_div_factor=final_div_factor)


def build_lr_schedule(opt_cfg, total_steps: int):
    """step count -> learning rate, from OPTIMIZATION."""
    name = opt_cfg.OPTIMIZER
    lr = float(opt_cfg.LR)
    if name in ("adam_onecycle", "onecycle"):
        return _safe_cosine_onecycle(total_steps, lr,
                                     pct_start=float(opt_cfg.get("PCT_START", 0.4)),
                                     div_factor=float(opt_cfg.get("DIV_FACTOR", 10)),
                                     final_div_factor=1e4)
    # step decay (train_utils/optimization/__init__.py:38-63)
    decay = float(opt_cfg.get("LR_DECAY", 0.1))
    steps_per_epoch = max(total_steps // max(int(opt_cfg.get("NUM_EPOCHS", 1)), 1), 1)
    sched = piecewise_constant_schedule(
        lr, {int(e) * steps_per_epoch: decay for e in opt_cfg.get("DECAY_STEP_LIST", [])})
    clip = float(opt_cfg.get("LR_CLIP", 0.0))
    if clip > 0:
        decayed = sched
        sched = lambda step: max(decayed(step), clip)  # noqa: E731
    if opt_cfg.get("LR_WARMUP", False):
        # CosineWarmupLR from eta_min = LR / DIV_FACTOR up to LR over
        # WARMUP_EPOCH epochs (train_utils/optimization/__init__.py:58-61),
        # then the decay schedule
        warm_steps = max(int(opt_cfg.get("WARMUP_EPOCH", 1)) * steps_per_epoch, 1)
        eta_min = lr / float(opt_cfg.get("DIV_FACTOR", 10))
        after = sched

        def sched(step):  # noqa: F811
            if step >= warm_steps:
                return after(step)
            return eta_min + (lr - eta_min) * (1 - math.cos(math.pi * step / warm_steps)) / 2
    return sched


def build_b1_schedule(opt_cfg, total_steps: int):
    """adam_onecycle's b1: MOMS[0] -> MOMS[1] over the warm-up, back to
    MOMS[0] by the end (final_div_factor 1; the reference's MOMS[1] /
    MOMS[0] overshoots past 1)."""
    moms = opt_cfg.get("MOMS", [0.95, 0.85])
    return _safe_cosine_onecycle(total_steps, float(moms[1]),
                                 pct_start=float(opt_cfg.get("PCT_START", 0.4)),
                                 div_factor=float(moms[1]) / float(moms[0]),
                                 final_div_factor=1.0)


class Optimizer:
    """A torch optimizer driven by the reference's schedules: ``step(count)``
    sets lr (and b1) for step ``count``, clips the gradients by their global
    norm, and updates. Every parameter is updated, a missing gradient taken
    as zero, as optax updates every leaf (weight decay included)."""

    def __init__(self, inner: torch.optim.Optimizer, lr_schedule, b1_schedule=None,
                 grad_clip: float = 0.0):
        self.inner = inner
        self.lr_schedule = lr_schedule
        self.b1_schedule = b1_schedule
        self.grad_clip = grad_clip
        self.params = [p for g in inner.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self, count: int) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.grad_clip > 0:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            clip = norm >= self.grad_clip
            for g in grads:
                g.copy_(torch.where(clip, g / norm * self.grad_clip, g))
        for group in self.inner.param_groups:
            group["lr"] = self.lr_schedule(count)
            if self.b1_schedule is not None:
                group["betas"] = (self.b1_schedule(count), group["betas"][1])
        self.inner.step()


def build_optimizer(opt_cfg, total_steps: int, params) -> Optimizer:
    """OPTIMIZATION (OPTIMIZER adam_onecycle | adam | adamw | sgd, LR,
    WEIGHT_DECAY, GRAD_NORM_CLIP, ...) over ``params``. adam_onecycle is
    AdamW (decoupled decay, as optax.adamw: biases and batch norm decay too);
    adam and sgd add the decay to the gradient, as the reference's torch
    optimizers do."""
    name = opt_cfg.OPTIMIZER
    wd = float(opt_cfg.get("WEIGHT_DECAY", 0.0))
    lr = build_lr_schedule(opt_cfg, total_steps)
    b1 = None
    params = list(params)
    if name == "adam_onecycle":
        b1 = build_b1_schedule(opt_cfg, total_steps)
        inner = torch.optim.AdamW(params, lr=lr(0), betas=(b1(0), 0.999), eps=1e-8,
                                  weight_decay=wd)
    elif name == "adam":
        inner = torch.optim.Adam(params, lr=lr(0), eps=1e-8, weight_decay=wd)
    elif name == "adamw":
        inner = torch.optim.AdamW(params, lr=lr(0), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=wd)
    elif name == "sgd":
        inner = torch.optim.SGD(params, lr=lr(0),
                                momentum=float(opt_cfg.get("MOMENTUM", 0.9)),
                                weight_decay=wd)
    else:
        raise NotImplementedError(name)
    return Optimizer(inner, lr, b1, float(opt_cfg.get("GRAD_NORM_CLIP", 0.0)))


class MultiSteps:
    """optax.MultiSteps over an ``Optimizer``: ``step(count)`` folds the
    gradients into their running mean (acc + (g - acc) / (n + 1), n the
    calls since the last update) and updates only on every ``every_k``-th
    call, with the mean and the schedules at count // every_k; in between
    the parameters do not move."""

    def __init__(self, inner: Optimizer, every_k: int):
        self.inner = inner
        self.every_k = every_k
        self.params = inner.params
        self.acc = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def step(self, count: int) -> None:
        n = count % self.every_k
        for p, a in zip(self.params, self.acc):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            a.add_((g - a) / (n + 1))
        if n == self.every_k - 1:
            for p, a in zip(self.params, self.acc):
                p.grad = a.clone()
                a.zero_()
            self.inner.step(count // self.every_k)


def build_vcn_optimizer(opt_cfg, sched_cfg, total_steps: int, params,
                        every_k: int = 1):
    """VCN's optimizer, as the reference's VCN tools build it, from the
    ``optimizer`` and ``scheduler`` config blocks, over ``params``: Adam,
    AdamW or SGD (momentum 0.9 unless given); StepLR as optax's staircase
    ``exponential_decay`` with the reference's step_size scaled by
    max(total_steps // 100, 1), OneCycleLR as optax's one-cycle over
    ``total_steps``; an unknown scheduler keeps lr constant. Only AdamW
    reads ``weight_decay``: Adam and SGD drop it, as the JAX package does.
    With ``every_k`` > 1 the gradients of every_k calls are averaged into
    one update (``MultiSteps``)."""
    name = (opt_cfg or {}).get("type", "Adam").lower()
    kw = dict((opt_cfg or {}).get("kwargs", {"lr": 1e-4}))
    lr = float(kw.pop("lr", 1e-4))
    sched = lambda count: lr  # noqa: E731
    if sched_cfg:
        st = sched_cfg.get("type", "StepLR")
        skw = sched_cfg.get("kwargs", {})
        if st == "StepLR":
            every = int(skw.get("step_size", 40)) * max(total_steps // 100, 1)
            gamma = float(skw.get("gamma", 0.7))
            sched = lambda count: lr * gamma ** (count // every)  # noqa: E731
        elif st == "OneCycleLR":
            sched = cosine_onecycle_schedule(total_steps, lr)
    wd = float(kw.pop("weight_decay", 0.0))
    params = list(params)
    if name == "adamw":
        inner = torch.optim.AdamW(params, lr=sched(0), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=wd)
    elif name == "sgd":
        inner = torch.optim.SGD(params, lr=sched(0),
                                momentum=float(kw.pop("momentum", 0.9)))
    else:
        inner = torch.optim.Adam(params, lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
    opt = Optimizer(inner, sched)
    return opt if every_k == 1 else MultiSteps(opt, every_k)


def build_seg2d_optimizer(params, lr: float = 1e-3, weight_decay: float = 1e-4,
                          warmup_steps: int = 200, decay_steps: int = 2000) -> Optimizer:
    """The Mask R-CNN recipe's optimizer over ``params``: gradients clipped
    to 10 by their global norm (fixed, as the reference's
    ``optax.clip_by_global_norm(10.0)`` in cli/train_seg2d.py:210), then
    AdamW (b1 0.9, b2 0.999, eps 1e-8; decoupled decay on every parameter,
    biases and batch norm too, as optax.adamw without a mask) at
    warmup_cosine_decay_schedule(0, lr, warmup_steps, decay_steps)."""
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup_steps, decay_steps)
    inner = torch.optim.AdamW(list(params), lr=sched(0), betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=weight_decay)
    return Optimizer(inner, sched, grad_clip=10.0)
