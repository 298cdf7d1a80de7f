"""The source-domain SEE pass: ``seevcn_torch.see.gt_completion.
complete_gt_frames`` with VCN_CN and the GT boxes, a call at a time on
``frames_per_call`` frames drawn in a seeded order from the traffic's pool
of raw frames, each call's completed clouds read back to the host (what the
pass writes out). No detector runs.

A sample of the window's calls, drawn from the seed, keeps the program's
clouds and instance validity; after the window the reference completes the
same frames. Each instance valid on both sides is compared as a point set
(its rows are a cyclic tiling, which one point more or less in a selection
shifts): the symmetric Hausdorff distance of the program's completion from
the reference's. Compared: the median instance's (``moved_median_m``) and
the share of instances farther apart than ``MOVED_M`` (``inst_moved``).
Instances valid on one side only and scan points kept on one side only are
reported beside them.
"""
from __future__ import annotations

import math
import sys
import time
from contextlib import nullcontext
from pathlib import Path

import torch

from ..roofline import vcn as VF
from ..traffic.raycast import make_pool
from .common import (PROGRAM, REFERENCE, STREAM_ORDER, Reservoir, Side, control_precision,
                     cycle_order, see_counts, set_tf32)

# a completion farther than this from the reference's has moved
MOVED_M = 1e-4


class Cell:
    def __init__(self, work: dict, config: dict, seed: int, device, *, program: str = PROGRAM,
                 control: bool = False, fault: str | None = None):
        self.work, self.seed, self.dev = work, int(seed), torch.device(device)
        self.det, self.see = config["detector"], config["see"]
        self.fault = fault
        self.per_call = int(work["frames_per_call"])
        self.pool = make_pool(work["traffic"], seed, self.det["DATA_CONFIG"]["POINT_CLOUD_RANGE"],
                              self.dev, Path(work["bench_dir"]) / "traffic")
        self.order = cycle_order(seed, STREAM_ORDER, self.pool["points"].shape[0])
        self.side = Side(program)
        self._precision = control_precision(self.side) if control else nullcontext()
        self._precision.__enter__()
        set_tf32(control)
        self.vcn = self.side.vcn(self.see["gt_vcn"], seed, self.dev)
        # the warm-up calls' counts: isolated, sane, spliced, K1 launches
        self.warm_counts = []
        for _ in range(int(work.get("warmup_calls", 2))):
            k1 = self.side.launches.get("min_sqdist_pruned", 0)
            self._call(self.side, self.vcn, self._next())
            self.warm_counts.append(see_counts(self.side, self.stats, k1))
        self.sample = Reservoir(int(work["check_calls"]), seed)
        self.window_frames = []

    def _next(self) -> torch.Tensor:
        return torch.tensor([next(self.order) for _ in range(self.per_call)], device=self.dev)

    def _call(self, side, vcn, idx):
        p = self.pool
        new_pts, new_valid, self.stats = side.gt.complete_gt_frames(
            vcn, p["points"][idx], p["valid"][idx], p["gt_boxes"][idx], p["gt_mask"][idx],
            device=self.dev, sanity_max_dist=float(self.see["sanity_max_dist_m"]),
            vcn_boxes=bool(self.see["gt_vcn"]["vcn_boxes"]))
        out = (new_pts.cpu(), new_valid.cpu(), self.stats["inst_valid"].cpu())
        if self.fault == "alter_answer" and side is self.side:
            out = (out[0] + 0.05, out[1], out[2])
        return out

    def objects(self) -> dict:
        return {}

    def window(self, seconds: float, tick=lambda: 0.0) -> dict:
        calls = 0
        t0 = time.perf_counter()
        while True:
            idx = self._next()
            out = self._call(self.side, self.vcn, idx)
            self.window_frames.extend(idx.tolist())
            calls += 1
            self.sample.offer(lambda: (idx, out))
            t0 += tick()
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        n = calls * self.per_call
        return {"attempted": n, "failed": 0, "calls": calls, "frames": n,
                "elapsed_s": elapsed, "latencies_s": []}

    def release(self) -> None:
        self._precision.__exit__(None, None, None)
        del self.vcn
        self.side = None

    def flops_in_window(self) -> dict:
        """VCN_CN on each window frame's GT boxes, padding slots left out."""
        v = self.see["gt_vcn"]
        per_box = VF.forward_flops(v["model"], 1, int(v["num_points"]), int(v["num_points"]))
        boxes = self.pool["gt_mask"].sum(1).tolist()
        return {"bfloat16": 0, "float32": per_box * sum(boxes[i] for i in self.window_frames)}

    def counts(self) -> list:
        c = self.pool["counts"]
        lines = [f"traffic {self.work['traffic']}: points a frame {c['points']}; cars {c['cars']}; "
                 f"points past the capacity {c['truncated']}"]
        if self.warm_counts:
            cols = list(zip(*self.warm_counts))
            lines.append(f"a warm-up call of {self.per_call} frames each: instances isolated "
                         f"{list(cols[0])}, sane {list(cols[1])}, spliced {list(cols[2])}; "
                         f"K1 launches {list(cols[3])}")
        return lines

    def check(self) -> dict:
        set_tf32(False)
        ref = Side(REFERENCE)
        vcn = ref.vcn(self.see["gt_vcn"], self.seed, self.dev)
        flips = inst = 0.0
        gaps = []
        for idx, (pts, valid, iv) in self.sample.items:
            r_pts, r_valid, r_iv = self._call(ref, vcn, idx)
            p = pts.shape[1] - iv.shape[1] * int(self.see["gt_vcn"]["num_points"])
            for f in range(pts.shape[0]):
                scan_flips = (valid[f, :p] ^ r_valid[f, :p]).sum()
                flips = max(flips, float(scan_flips) / max(float(r_valid[f, :p].sum()), 1.0))
                got = pts[f, p:].view(iv.shape[1], -1, 3)
                want = r_pts[f, p:].view(iv.shape[1], -1, 3)
                gaps += [hausdorff(got[j], want[j])
                         for j in torch.nonzero(iv[f] & r_iv[f])[:, 0].tolist()]
            inst += float((iv ^ r_iv).sum())
        gaps.sort()
        median = gaps[len(gaps) // 2] if gaps else math.inf
        moved = sum(g > MOVED_M for g in gaps) / max(len(gaps), 1)
        decades = [sum(10.0 ** (e - 1) < g <= 10.0 ** e for g in gaps) for e in range(-6, 2)]
        self.diagnostics = {"instances": len(gaps), "inst_flips": inst, "cloud_flips": flips,
                            "hausdorff_largest_m": gaps[-4:],
                            "hausdorff_by_decade_1e-7_to_10_m": decades}
        print(f"compared {len(gaps)} instances; valid on one side only {inst:g}; scan points "
              f"kept on one side only, the largest share of a frame {flips:.3g}", file=sys.stderr)
        lim = self.work["limits"]
        return {"moved_median_m": (median, lim["moved_median_m"]),
                "inst_moved": (moved, lim["inst_moved"])}


def hausdorff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The symmetric Hausdorff distance of two point sets (N, 3), (M, 3)."""
    d = torch.cdist(a.double(), b.double())
    return float(torch.maximum(d.amin(1).amax(), d.amin(0).amax()))
