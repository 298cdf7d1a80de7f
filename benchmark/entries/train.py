"""Detector training: ``seevcn_torch.train.train.train_step`` at the
configuration's batch, steps back to back, on batches drawn in a seeded
order from the traffic's pool of completed frames.

Set-up builds one train state (the model with the seed's weights and its
optimizer) and drives it through its first three steps with the window's
own call and feed, on 12 different frames; the window then continues the
same state. The reference (built from the same seeded weights) follows
those three steps afterwards. Compared: step 1's RPN loss (the RoI head's share of step 1
turns on which RoIs a near-tie samples), each step's loss, the first
gradient as the optimizer got it (worked out from Adam's first moment
after one step), and the parameters' change over the three steps, each
leaf's norm against the reference's (``worst_leaf_gap``).
"""
from __future__ import annotations

import statistics
import time
from contextlib import nullcontext
from pathlib import Path

import torch

from ..roofline import detector as DF
from ..traffic.raycast import device_generator, make_pool
from .common import (PROGRAM, REFERENCE, STREAM_DROPOUT, STREAM_ORDER, STREAM_ROI, Side,
                     control_precision, cycle_order, median_leaf_gap, set_tf32,
                     worst_leaf_gap)

CHECK_STEPS = 3


class Cell:
    def __init__(self, work: dict, config: dict, seed: int, device, *, program: str = PROGRAM,
                 control: bool = False, fault: str | None = None):
        self.work, self.seed, self.dev = work, int(seed), torch.device(device)
        self.det = config["detector"]
        self.total_steps = int(config["train_total_steps"])
        self.batch = int(work["batch"])
        self.roi_rows = work.get("roi_rows")
        self.fault = fault
        self.pool = make_pool(work["traffic"], seed, self.det["DATA_CONFIG"]["POINT_CLOUD_RANGE"],
                              self.dev, Path(work["bench_dir"]) / "traffic")
        self.order = cycle_order(seed, STREAM_ORDER, self.pool["points"].shape[0])
        self.roi_gen = device_generator(seed, STREAM_ROI, self.dev)
        self.side = Side(program)
        self._precision = control_precision(self.side) if control else nullcontext()
        self._precision.__enter__()
        set_tf32(control)
        self.model, self.state = self._build(self.side)
        self.gen = device_generator(seed, STREAM_DROPOUT, self.dev)
        start = {n: p.detach().clone() for n, p in self.model.named_parameters()}
        self.first = [self._next() for _ in range(CHECK_STEPS)]
        self.losses, self.terms = [], []
        for i, b in enumerate(self.first):
            m = self._step(self.side, self.state, b, self.gen)
            self.terms.append({k: float(v) for k, v in m.items()})
            self.losses.append(self.terms[-1]["loss"])
            if i == 0:
                self.grad1 = first_grad_norms(self.state)
        self.change = {n: float((p.detach() - start[n]).float().norm())
                       for n, p in self.model.named_parameters()}
        del start
        for _ in range(int(work.get("warmup_steps", 2))):
            self._step(self.side, self.state, self._next(), self.gen)
        self.window_frames = []

    def _build(self, side: Side):
        model, cfg = side.detector(self.det, self.seed, self.dev, train=True)
        return model, side.train.create_train_state(model, cfg.OPTIMIZATION, self.total_steps)

    def _next(self):
        idx = torch.tensor([next(self.order) for _ in range(self.batch)], device=self.dev)
        roi_u = None if not self.roi_rows else torch.rand(
            (self.batch, int(self.roi_rows)), generator=self.roi_gen, device=self.dev)
        return idx, roi_u

    def _step(self, side: Side, state, b, gen, fault=None) -> dict:
        fault = self.fault if fault is None else fault
        idx, roi_u = b
        if fault == "half_batch":
            idx = idx[: self.batch // 2]
            roi_u = None if roi_u is None else roi_u[: self.batch // 2]
        pts, valid, gt = (self.pool[k][idx] for k in ("points", "valid", "gt_boxes"))
        if fault == "unchanged":
            loss, tb, _ = side.train.train_forward(state, pts, valid, gt, gen, roi_u)
            return {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}
        return side.train.train_step(state, pts, valid, gt, gen, roi_u=roi_u)

    def objects(self) -> dict:
        return {"detector": self.model}

    def window(self, seconds: float, tick=lambda: 0.0) -> dict:
        losses, steps = [], 0
        t0 = time.perf_counter()
        while True:
            b = self._next()
            self.window_frames.extend(b[0].tolist())
            losses.append(self._step(self.side, self.state, b, self.gen)["loss"])
            steps += 1
            t0 += tick()
            if time.perf_counter() - t0 >= seconds:
                break
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        n = steps * self.batch
        return {"attempted": n, "failed": bad * self.batch, "calls": steps, "samples": n,
                "frames": n, "elapsed_s": elapsed, "latencies_s": []}

    def release(self) -> None:
        self._precision.__exit__(None, None, None)
        del self.model, self.state
        self.side = None

    def flops_in_window(self) -> dict:
        """Operations of the window's steps: three times each frame's
        forward (``roofline/detector.py``)."""
        per = {}
        tot = {"bfloat16": 0, "float32": 0}
        for i in self.window_frames:
            if i not in per:
                per[i] = self.frame_work(i)["flops"]
            for k, v in per[i].items():
                tot[k] += 3 * v
        return tot

    def frame_work(self, i: int) -> dict:
        return DF.forward_flops(self.pool["points"][i], self.pool["valid"][i], self.det, train=True)

    def counts(self) -> list:
        c = self.pool["counts"]
        lines = [f"traffic {self.work['traffic']}: points a frame {c['points']}; cars {c['cars']}; "
                 f"completed cars {c['completed']}; points past the capacity {c['truncated']}"]
        work = [self.frame_work(i) for i in range(len(c["points"]))]
        lines.append(f"voxels a frame before the cap {[w['voxels'] for w in work]} "
                     f"(train cap {work[0]['cap']}; the cap binds in "
                     f"{sum(w['voxels'] > w['cap'] for w in work)} of {len(work)} frames)")
        lines.append("active sites a backbone layer (input first), frame 0: "
                     f"{work[0]['active']}; the largest: "
                     f"{[max(w['active'][j] for w in work) for j in range(len(work[0]['active']))]}")
        lines.append(f"setup losses of steps 1-{CHECK_STEPS}: {self.losses}")
        return lines

    def check(self) -> dict:
        """The reference follows the first three steps; -> {name: (value,
        limit)}."""
        set_tf32(False)
        ref = Side(REFERENCE)
        _, state = self._build(ref)
        gen = device_generator(self.seed, STREAM_DROPOUT, self.dev)
        model = state.model
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses, terms = [], []
        for i, b in enumerate(self.first):
            m = self._step(ref, state, b, gen, fault="none")
            terms.append({k: float(v) for k, v in m.items()})
            losses.append(terms[-1]["loss"])
            if i == 0:
                grad1 = first_grad_norms(state)
        change = {n: float((p.detach() - start[n]).float().norm())
                  for n, p in model.named_parameters()}
        med = statistics.median(grad1.values())
        moved = {n for n, g in grad1.items() if g >= 1e-3 * med}
        self.diagnostics = {"terms": self.terms, "ref_terms": terms,
                            "grad": _worst(self.grad1, grad1), "change": _worst(self.change, change, moved),
                            "excluded": sorted(set(grad1) - moved)}
        gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(self.losses, losses)]
        rpn = self.terms[0]["rpn_loss"], terms[0]["rpn_loss"]
        numbers = {"rpn1_gap": abs(rpn[0] - rpn[1]) / max(abs(rpn[1]), 1e-30),
                   "loss1_gap": gaps[0], "loss_gap": max(gaps),
                   "grad_gap": worst_leaf_gap(self.grad1, grad1),
                   "grad_median_gap": median_leaf_gap(self.grad1, grad1),
                   "change_gap": worst_leaf_gap(self.change, change, keep=moved),
                   "change_median_gap": median_leaf_gap(self.change, change, keep=moved)}
        self.diagnostics["numbers"] = numbers
        return {k: (numbers[k], lim) for k, lim in self.work["limits"].items()}


def first_grad_norms(state) -> dict:
    """Each leaf's first gradient as the optimizer got it (clipped), from
    Adam's first moment after one step: m / (1 - b1)."""
    opt = state.optimizer.inner
    b1 = opt.param_groups[0]["betas"][0]
    out = {}
    for n, p in state.model.named_parameters():
        st = opt.state.get(p, {})
        out[n] = float(st["exp_avg"].float().norm()) / (1 - b1) if "exp_avg" in st else 0.0
    return out


def _worst(got: dict, ref: dict, keep=None, n: int = 6) -> list:
    """The leaves with the widest gaps: (name, program's norm, reference's)."""
    med = statistics.median(ref.values())
    keys = [k for k in ref if keep is None or k in keep]
    keys.sort(key=lambda k: -abs(got.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30))
    return [(k, got.get(k, 0.0), ref[k]) for k in keys[:n]] + [("median", med)]
