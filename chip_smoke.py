#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (seevcn_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from seevcn_torch/csrc (K1, K2, K3 of the
min-distance family), holds each against its plain PyTorch version on the
card (K1 to its contract and bit for bit to the plain version of its
ordered route, K2 bit for bit, K3 at the reference's Gram tolerance), runs
one SEE frame (isolation -> VCN completion -> replacement) at the
shapes bench.py uses (150,000 scan points, 32 detections on a 384x1280
image, VCN_VC at full width with weights made from a seed) through
``seevcn_torch.see.frame.complete_frame``, runs K2 and K3 through
``min_sqdist`` on that frame's scan and completed points, and runs the
SECOND-IoU detector at ``_flagship_detector_cfg`` (weights made from a seed)
on the frame's output cloud through ``detect_stage``, and then bench.py's
whole fused frame through ``run_frame``: Mask R-CNN at bench.py's
``Seg2DConfig(image_size=(384, 1280), max_detections=32)`` (weights made
from a seed) on a random camera image, its 32 detections into the SEE frame,
the detector on the output. It checks that each path went through its
kernels and that its output is right (the detector and the mask model
against the port's CPU path at their tiny configs, and the detector's first
sparse conv against a dense conv3d at the flagship input), and prints
timings. The training phases follow: the GT completion and SECOND-IoU train
steps at the flagship's widths (phase 9), then VCN training (phase 10):
VCN_VC at full width and batch 32 on VC data that the port's vc_shapenet
generates, checked against the CPU, timed, validated, its checkpoint
reloaded into VCNInference.
Every failed check raises, so the exit code is not 0. The last line of
standard output is one JSON object naming the device; the line before it
holds the kernel summary.

It needs one CUDA card and nvcc; it imports nothing of JAX or seevcn_tpu.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from seevcn_torch.models.detectors import configs as DC
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.models.modules import roi_heads as RH
from seevcn_torch.models.seg2d import maskrcnn as SM
from seevcn_torch.models.seg2d.backend import build_seg2d
from seevcn_torch.geom.boxes import boxes_iou_normal
from seevcn_torch.models.vcn import vc_shapenet as VS
from seevcn_torch.models.vcn.dataset import VCDataset
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.models.vcn.metrics import MetricAccumulator
from seevcn_torch.models.vcn.nets import build_vcn
from seevcn_torch.models.vcn.runner import VCNTrainer
from seevcn_torch.ops import cuda as K
from seevcn_torch.ops import nms as NMS
from seevcn_torch.ops import sparse as SP
from seevcn_torch.ops.clustering import largest_cluster_batch
from seevcn_torch.ops.cuda import min_dist as MD
from seevcn_torch.ops.iou3d import boxes_iou_bev
from seevcn_torch.ops.nms import nms_bev
from seevcn_torch.ops.sampling import farthest_point_sample, fps, partial_mesh_batch
from seevcn_torch.ops.voxelize import voxelize_batch
from seevcn_torch.see import device_pipeline as DP
from seevcn_torch.see import frame as F
from seevcn_torch.see.gt_completion import complete_gt_frames
from seevcn_torch.train.optim import build_lr_schedule
from seevcn_torch.train.train import (apply_gradients, create_train_state,
                                      train_forward, train_step)
from seevcn_torch.testing import (K2_CARD_EDGES, VCN_BIASES_BEFORE_BN,
                                  assert_vcn_grads_close, k2_edge_case,
                                  plain_sparse_backward, tiny_seg2d_cfg,
                                  vcn_loss_selections, vcn_pool_points,
                                  vcn_selection_flips)
from seevcn_torch.utils.ckpt import load_vcn_checkpoint
from seevcn_torch.utils.config import Cfg

# bench.py:165-170: KITTI P2-style camera for a 384x1280 image, and the
# lidar -> camera axes (x -> depth, y -> -u, z -> -v)
PROJ = np.array([[720.0, 0.0, 640.0, 0.0], [0.0, 720.0, 190.0, 0.0],
                 [0.0, 0.0, 1.0, 0.0]], np.float32)
LIDAR_TO_CAM = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0],
                         [1.0, 0.0, 0.0]], np.float32)
IMAGE_SIZE = (384, 1280)
CAR_DIMS = (4.2, 1.8, 1.5)

# H100 SXM published peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
RADIUS = 0.1
# K1's bound counts the pairs (i, j) where query row i lies within r of the
# box of the BOUND_GROUP-row support group holding j: a constant of this
# measurement, not read from the kernel module, so that a new tiling of the
# kernel does not move its own yardstick
BOUND_GROUP = 32
# the reference's tolerance for its Gram kernel (tests/test_pallas_min_dist.py)
GRAM_ATOL, GRAM_RTOL = 2e-3, 1e-3


def _box_corners(centre, dims, heading):
    sx, sy, sz = np.asarray(dims) / 2
    c = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)])
    cs, sn = np.cos(heading), np.sin(heading)
    rot = np.array([[cs, sn, 0], [-sn, cs, 0], [0, 0, 1]])
    return c @ rot + centre


def _visible_surface(rng, centre, heading, n):
    """~n points on the faces of a car box that face the sensor."""
    dx, dy, dz = CAR_DIMS
    faces = [(0, 1, dy * dz), (0, -1, dy * dz), (1, 1, dx * dz),
             (1, -1, dx * dz), (2, 1, dx * dy)]
    area = np.array([f[2] for f in faces])
    cs, sn = np.cos(heading), np.sin(heading)
    rot = np.array([[cs, sn, 0], [-sn, cs, 0], [0, 0, 1]])
    out = []
    for (axis, sign, _), k in zip(faces, rng.multinomial(2 * n, area / area.sum())):
        local = (rng.rand(k, 3) - 0.5) * CAR_DIMS
        local[:, axis] = sign * CAR_DIMS[axis] / 2
        normal = np.zeros(3)
        normal[axis] = sign
        if (normal @ rot) @ centre < 0:            # the face looks at the sensor
            out.append(local @ rot + centre)
    pts = np.concatenate(out) if out else np.zeros((0, 3))
    return pts + rng.randn(*pts.shape) * 0.01


def make_scene(seed: int, n_points: int, n_cars: int,
               image_size=IMAGE_SIZE, proj=PROJ, lidar_to_cam=LIDAR_TO_CAM,
               pts_per_car: int = 600):
    """A lidar scan in bench.py's layout (x 1..69, y -39..39, z -2.9..0.9 m)
    holding ``n_cars`` box-surface cars in the camera's view, and one
    detection per car: its projected 2D box, a 28x28 mask patch that covers
    the car's projection, and a score; and each car's ground-truth box
    (n_cars, 8): centre, CAR_DIMS, heading, label 1. Returns numpy arrays."""
    rng = np.random.RandomState(seed)
    h, w = image_size
    cars, det_boxes, det_masks = [], [], []
    for i in range(n_cars):
        rng_m = 12.0 + 6.0 * (i // 4) + rng.uniform(-1, 1)
        bearing = (-0.45, -0.15, 0.15, 0.45)[i % 4]
        centre = np.array([rng_m * np.cos(bearing), rng_m * np.sin(bearing),
                           -1.0 + rng.uniform(-0.1, 0.1)])
        heading = bearing + rng.uniform(-0.3, 0.3)
        surf = _visible_surface(rng, centre, heading, pts_per_car)
        cars.append((centre, heading, surf))

        def project(p):
            cam = p @ lidar_to_cam.T
            uvw = cam @ proj[:, :3].T + proj[:, 3]
            return uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]

        u, v = project(_box_corners(centre, CAR_DIMS, heading))
        box = np.array([max(u.min(), 0), max(v.min(), 0), min(u.max(), w - 1),
                        min(v.max(), h - 1)])
        su, sv = project(surf)
        mi = np.clip(((sv - box[1]) / (box[3] - box[1]) * 28).astype(int), 0, 27)
        mj = np.clip(((su - box[0]) / (box[2] - box[0]) * 28).astype(int), 0, 27)
        occ = np.zeros((30, 30), bool)
        occ[mi + 1, mj + 1] = True
        grown = np.zeros((28, 28), bool)          # 3x3 dilation
        for di in range(3):
            for dj in range(3):
                grown |= occ[di:di + 28, dj:dj + 28]
        det_boxes.append(box)
        det_masks.append(np.where(grown, 0.9, 0.1) + rng.uniform(-0.05, 0.05,
                                                                 (28, 28)))

    def outside_cars(p):
        keep = np.ones(len(p), bool)
        for centre, heading, _ in cars:
            cs, sn = np.cos(heading), np.sin(heading)
            rel = p - centre
            lx = rel[:, 0] * cs + rel[:, 1] * sn
            ly = -rel[:, 0] * sn + rel[:, 1] * cs
            keep &= ~((np.abs(lx) < CAR_DIMS[0] / 2 + 0.3)
                      & (np.abs(ly) < CAR_DIMS[1] / 2 + 0.3)
                      & (np.abs(rel[:, 2]) < CAR_DIMS[2] / 2 + 0.3))
        return keep

    car_pts = np.concatenate([c[2] for c in cars])[: n_points // 2]
    n_bg = n_points - len(car_pts)
    bg = np.stack([rng.uniform(1, 69, 2 * n_bg), rng.uniform(-39, 39, 2 * n_bg),
                   rng.uniform(-2.9, 0.9, 2 * n_bg)], 1)
    bg = bg[outside_cars(bg)][:n_bg]
    pts = np.concatenate([car_pts, bg])[rng.permutation(n_points)]
    return {"points": pts.astype(np.float32),
            "valid": np.ones(n_points, bool),
            "det_boxes": np.stack(det_boxes).astype(np.float32),
            "det_masks": np.stack(det_masks).astype(np.float32),
            "det_scores": rng.uniform(0.6, 1.0, n_cars).astype(np.float32),
            "gt_boxes": np.array([[*c, *CAR_DIMS, h, 1.0] for c, h, _ in cars],
                                 np.float32).reshape(-1, 8)}


def seeded_vcn_state_dict(seed: int, model_name: str = "VCN_VC",
                          num_coarse: int = 1024) -> dict:
    """Random VCN weights from a torch.Generator at the scale of flax's
    default init, which bench.py's VCN gets: every Conv1d/Linear weight
    normal with std 1/sqrt(fan_in) (lecun normal), biases zero, BatchNorm at
    identity statistics."""
    gen = torch.Generator().manual_seed(seed)
    sd = build_vcn(model_name, num_coarse=num_coarse).state_dict()
    out = {}
    for k, v in sd.items():
        mod, leaf = k.rsplit(".", 1)
        if leaf == "weight" and v.dim() >= 2:
            out[k] = torch.randn(v.shape, generator=gen) / math.sqrt(v.shape[1])
        elif leaf == "bias" and f"{mod}.running_mean" not in sd:
            out[k] = torch.zeros_like(v)
        else:                               # BatchNorm: identity statistics
            out[k] = v.clone()
    return out


def _to(dev, scene):
    return {k: torch.from_numpy(v).to(dev) for k, v in scene.items()}


def time_cuda(fn, reps: int = 11, warmup: int = 2) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_contract(got, plain, r):
    """The pruned kernel's contract against its plain version: the same
    within-radius set, equal values where the plain one is <= r^2, and never
    below it, except that a row no support box is near may read 1e18 where
    the truth is farther still (the frame's padding rows at 1e9). Returns
    the worst |difference| inside the radius."""
    r2 = torch.tensor(r * r, dtype=torch.float32)
    inside = plain <= r2.to(plain.device)
    if not torch.equal(got <= r2.to(got.device), inside):
        raise AssertionError("kernel and plain version disagree on the "
                             "within-radius set")
    err = (got[inside] - plain[inside]).abs().max().item() if inside.any() else 0.0
    if err > 1e-4:
        raise AssertionError(f"kernel differs from plain by {err} inside r")
    finite = torch.isfinite(plain)
    floor = plain[finite].clamp_max(MD.PRUNED_INIT)
    if not (got[finite] >= floor * (1 - 1e-5) - 1e-4).all():
        raise AssertionError("kernel reads below the true minimum")
    if not (got[~finite] >= 1e17).all():
        raise AssertionError("kernel reads a finite distance with no valid b")
    return err


def contract_cases(dev):
    """K1 cases, as in tests/test_torch_min_dist.py: wide queries against
    clustered supports, N and M not multiples of 32, invalid rows, a support
    with no valid row, N = 1; and the cases of the ordered route: rows in
    scan order on 9 clusters, a row exactly r from a sub-tile box's face,
    rows within r of two clusters, 24k copies of one row. Yields (name, a,
    b, valid, r)."""
    rng = np.random.RandomState(0)

    def case(name, a, b, valid, r):
        return (name, torch.from_numpy(np.asarray(a, np.float32)).to(dev),
                torch.from_numpy(np.asarray(b, np.float32)).to(dev),
                torch.from_numpy(np.asarray(valid, bool)).to(dev), r)

    for n, k_c, per, r, inval in ((2500, 4, 300, 0.8, 0.0), (1029, 3, 347, 0.3, 0.2),
                                  (3, 1, 5, 1.0, 0.0), (1, 2, 600, 0.5, 0.0),
                                  (300, 2, 100, 0.5, 1.0), (40000, 8, 1000, 0.1, 0.1),
                                  (3000, 9, 700, 0.2, 0.1)):
        a = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
        centres = rng.uniform(-40, 40, (k_c, 3))
        b = (centres[:, None] + rng.uniform(-2, 2, (k_c, per, 3))).reshape(-1, 3)
        b = b.astype(np.float32)
        q = max(n // 4, 1)
        a[:q] = b[rng.randint(0, len(b), q)] + rng.uniform(-r, r, (q, 3))
        a = a[rng.permutation(n)]          # the rows in scan order
        yield case(f"clusters_n{n}_m{len(b)}", a, b, rng.rand(len(b)) >= inval, r)
    b = rng.uniform(0, 1, (96, 3))
    b[40] = [0.0, 0.5, 0.5]                # on the face x = 0 of sub-tile 1
    yield case("row_at_r_from_face", [[-0.5, 0.5, 0.5], [-0.5, 0.1, 0.9],
                                      [-0.5, 3.0, 0.5], [0.25, 0.25, 0.25]],
               b, np.ones(96, bool), 0.5)
    b = np.concatenate([rng.uniform(-1, 0, (1024, 3)), rng.uniform(0.3, 1.3, (1100, 3))])
    a = np.stack([rng.uniform(-0.3, 0.6, 500), rng.uniform(0, 0.3, 500),
                  rng.uniform(-0.3, 0.3, 500)], 1)
    yield case("near_two_clusters", a, b, np.ones(len(b), bool), 0.5)
    b = rng.uniform(-2, 2, (2000, 3)) + [20.0, -5.0, -1.0]
    yield case("copies_of_one_row", np.repeat(b[7:8] + 0.03, 24576, axis=0), b,
               np.ones(2000, bool), 0.1)


def check_k1(a, b, valid, r):
    """K1 on one case: its contract against min_sqdist_plain, and bit for
    bit the plain version of its route (pruned_sweep_plain). Returns (worst
    |kernel - plain| inside r, pairs the route swept)."""
    got = MD.min_sqdist(a, b, valid, prune_radius=r)
    torch.cuda.synchronize()
    err = check_contract(got, MD.min_sqdist_plain(a, b, valid), r)
    route, swept = MD.pruned_sweep_plain(a, b, valid, r)
    if not torch.equal(got, route):
        raise AssertionError("K1 differs from the plain version of its route")
    return err, swept


def dense_cases(dev):
    """K2 / K3 cases: those of tests/test_pallas_min_dist.py (and of the
    port's tests), N and M that are not tile multiples, a support with
    invalid rows and one with no valid row."""
    rng = np.random.RandomState(1)
    cases = {
        "randn_scaled": (rng.randn(700, 3) * 5, rng.randn(1300, 3) * 5, None),
        "lidar_range": (rng.randn(500, 3) * 3 + [45.0, -20.0, 0.0],
                        rng.randn(900, 3) * 3 + [44.0, -19.0, 0.0], None),
        "b_valid_mask": ([[10.0, 0, 0]], [[10.1, 0, 0], [15.0, 0, 0]],
                         [False, True]),
        "tiny_ragged": (rng.randn(3, 3), rng.randn(5, 3), None),
        "past_two_tiles": (rng.uniform(-30, 30, (2051, 3)),
                           rng.uniform(-30, 30, (2305, 3)),
                           rng.rand(2305) > 0.3),
        "no_valid_row": (rng.uniform(-30, 30, (300, 3)),
                         rng.uniform(-30, 30, (200, 3)), np.zeros(200, bool)),
        "wide_vs_clustered": next(contract_cases("cpu"))[1:3] + (None,),
    }
    yield from _on_device(dev, cases)


def k2_edge_cases(dev):
    """K2 cases at the edges of its tiling, the same as the card tests'
    (seevcn_torch.testing.K2_CARD_EDGES): N of 1, one below and one above a
    unit's 1,024 rows; M of 1, one below and one above one and two 512-row
    tiles; a support all at the pushed value 1e9; query rows at 1e9;
    several blocks meeting on each row; more units than resident blocks,
    so that runs cross row groups."""
    yield from _on_device(dev, {name: k2_edge_case(name) for name in K2_CARD_EDGES})


def _on_device(dev, cases):
    for name, (a, b, v) in cases.items():
        yield (name, torch.as_tensor(np.asarray(a, np.float32)).to(dev),
               torch.as_tensor(np.asarray(b, np.float32)).to(dev),
               None if v is None else torch.as_tensor(np.asarray(v)).to(dev))


def gram_err(k3, ref):
    """max |K3 - ref|, raising unless K3 is within the reference's Gram
    tolerance (atol 2e-3, rtol 1e-3) of ref everywhere."""
    err = (k3 - ref).abs()
    if not (err <= GRAM_ATOL + GRAM_RTOL * ref.abs()).all():
        raise AssertionError(f"K3 off by {err.max().item()}, past the Gram tolerance")
    return err.max().item() if err.numel() else 0.0


def check_dense_kernels(dev):
    """K2 bit for bit against its plain version and the exact difference
    form; K3 within atol 2e-3, rtol 1e-3 (the reference's own tolerance for
    its Gram kernel) of both its plain version min_sqdist_gram_plain (the
    same algebra with each product and sum rounded on its own; the kernel
    fuses them) and the exact difference form. A support with no valid row
    reads about 3e18 on both kernels, as the reference's do. Then K2 bit for
    bit at the edges of its tiling. Returns the worst |K3 - plain| and |K3 -
    exact| over valid rows."""
    worst_plain = worst_exact = 0.0
    for name, a, b, v in dense_cases(dev):
        k2 = MD.min_sqdist(a, b, v, form="diff")
        k3 = MD.min_sqdist(a, b, v, form="gram")
        torch.cuda.synchronize()
        if not torch.equal(k2, MD.min_sqdist_plain(a, MD.push_invalid(b, v))):
            raise AssertionError(f"K2 differs from its plain version on {name}")
        exact = MD.min_sqdist_plain(a, b, v)
        ok = torch.isfinite(exact)
        if not torch.equal(k2[ok], exact[ok]):
            raise AssertionError(f"K2 differs from the exact form on {name}")
        worst_plain = max(worst_plain,
                          gram_err(k3[ok], MD.min_sqdist_gram_plain(a, b, v)[ok]))
        worst_exact = max(worst_exact, gram_err(k3[ok], exact[ok]))
        for k in (k2, k3):
            if not ((k[~ok] > 1e18) & torch.isfinite(k[~ok])).all():
                raise AssertionError(f"no-valid-row support on {name}")
    for name, a, b, v in k2_edge_cases(dev):
        k2 = MD.min_sqdist(a, b, v, form="diff")
        torch.cuda.synchronize()
        if not torch.equal(k2, MD.min_sqdist_plain(a, MD.push_invalid(b, v))):
            raise AssertionError(f"K2 differs from its plain version on {name}")
    return worst_plain, worst_exact


def sustained(fn, seconds: float = 1.0):
    """Run ``fn`` back to back for about ``seconds`` while nvidia-smi samples
    the SM clock and the power draw every 50 ms: -> (ms per call, median SM
    MHz, median W)."""
    n = max(1, int(seconds * 1e3 / time_cuda(fn, reps=3)))
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "50"],
                           stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                           text=True)
    try:
        time.sleep(0.3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines()
            if line.count(",") == 1]
    mhz = statistics.median(r[0] for r in rows) if rows else float("nan")
    watts = statistics.median(r[1] for r in rows) if rows else float("nan")
    return start.elapsed_time(end) / n, mhz, watts


def host_enqueue_us(fn, reps: int = 50) -> float:
    """Host µs per call of ``fn`` to enqueue its work, the card drained
    before and after."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_us_by_kernel(fn, reps: int = 20):
    """Device µs per call of ``fn`` by kernel (torch.profiler), as
    {short name: µs}."""
    fn()
    torch.cuda.synchronize()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type == torch.autograd.DeviceType.CUDA and t:
            m = re.search(r"k1_\w+", e.key)
            key = m.group(0) if m else e.key[:48]
            out[key] = out.get(key, 0.0) + t / reps
    return out


def kernel_entry(name, source_line, launches, max_err, k_ms, plain_ms,
                 bound_ms, bound_by, lib_ms, steady, usage):
    """One kernel of the summary line. ``k_ms`` (ms, kernel_ms) is a median
    of a few CUDA-event calls, as the line has always given it; ``steady``
    is (ms a call, median SM MHz) of the same call back to back for 1 s;
    ``usage`` is (registers, spilled bytes) of its main launch."""
    return {"name": name, "route": "cuda", "source": "seevcn_torch/csrc/min_dist.cu",
            "replaces": f"seevcn_tpu/ops/pallas/min_dist.py:{source_line}",
            "launches": launches, "max_abs_err": max_err, "ms": k_ms,
            "kernel_ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "steady_ms": steady[0],
            "steady_mhz": steady[1], "registers": usage[0], "spill_bytes": usage[1]}


def ptxas_usage(log):
    """{entry function: (registers, spill stores + loads in bytes)} from
    ``nvcc -Xptxas -v``'s output."""
    usage, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)), spill)
    return usage


def usage_of(usage, short):
    """The (registers, spilled bytes) of the entry function named ``short``,
    or (None, None) where this run did not build it."""
    return next((v for k, v in usage.items() if short in k), (None, None))


def seeded_state_dict(seed: int, model, random_stats: bool = False) -> dict:
    """Random weights for ``model`` (the SECOND-IoU detector, Mask R-CNN)
    from a torch.Generator at the scale of flax's default init, as
    seeded_vcn_state_dict does for VCN_VC: every conv / linear weight normal
    with std 1/sqrt(fan_in), biases zero, batch norm at identity statistics.
    fan_in is the product of all dimensions but the output one: the first
    for every layout but a transposed conv's (in, out, kh, kw), which the
    model's module types tell apart. ``random_stats`` draws the biases and
    the batch-norm affine and running statistics too, so that no norm is an
    identity and empty BEV cells do not all score alike."""
    gen = torch.Generator().manual_seed(seed)
    transposed = {f"{name}.weight" for name, m in model.named_modules()
                  if isinstance(m, (torch.nn.ConvTranspose1d, torch.nn.ConvTranspose2d,
                                    torch.nn.ConvTranspose3d))}
    sd = model.state_dict()
    out = {}
    for k, v in sd.items():
        mod, leaf = k.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            out[k] = v.clone()
        elif f"{mod}.running_var" in sd:                   # batch norm
            if not random_stats:
                out[k] = v.clone()
            elif leaf in ("weight", "running_var"):
                out[k] = 0.5 + torch.rand(v.shape, generator=gen)
            else:
                out[k] = 0.1 * torch.randn(v.shape, generator=gen)
        elif leaf == "bias":
            out[k] = 0.1 * torch.randn(v.shape, generator=gen) if random_stats \
                else torch.zeros_like(v)
        else:
            fan = v.shape[0] * math.prod(v.shape[2:]) if k in transposed \
                else math.prod(v.shape[1:])
            out[k] = torch.randn(v.shape, generator=gen) / math.sqrt(fan)
    return out


def blob_points(seed: int, n: int = 600):
    """One small frame for _tiny_detector_cfg: three car-sized blobs and a
    strip of ground points, as numpy (points (n, 3), valid (n,))."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    for c in range(3):
        ctr = [rng.uniform(3, 13), rng.uniform(-5, 5), rng.uniform(-1, 0.5)]
        pts[60 * c:60 * c + 60] = ctr + rng.uniform(-1, 1, (60, 3)) * [2.0, 0.9, 0.7]
    pts[180:220] = np.stack([rng.uniform(0, 16, 40), rng.uniform(-8, 8, 40),
                             rng.uniform(-1.9, -1.7, 40)], 1)
    return pts, np.arange(n) < 220


@torch.no_grad()
def check_tiny_detector_against_cpu(dev):
    """_tiny_detector_cfg with TF32 off: the detector on the card against
    the port's CPU path (which the tests hold against JAX): pre-NMS class
    and box predictions within atol 1e-4, rtol 1e-4 (f32 sums in another
    order), and the same kept boxes after both NMS passes (the same set,
    each box within 1e-3: scores that tie to f32 rounding may list two kept
    boxes in the other order)."""
    cfg = DC.tiny_detector_cfg()
    cpu = torch.device("cpu")
    model, _ = build_detector(cfg, device=cpu)
    sd = seeded_state_dict(2, model, random_stats=True)
    pts, valid = blob_points(3)
    res = {}
    for w in (dev, cpu):
        m, _ = build_detector(cfg, sd, device=w)
        res[w] = F.detect_stage(m, cfg, torch.from_numpy(pts),
                                torch.from_numpy(valid), device=w)
    (pp_d, out_d), (pp_c, out_c) = res[dev], res[cpu]
    worst = {}
    for k in ("batch_cls_preds", "batch_box_preds", "rcnn_iou"):
        got, ref = out_d[k].cpu(), out_c[k]
        worst[k] = (got - ref).abs().max().item()
        if not ((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all():
            raise AssertionError(f"tiny detector: {k} off the CPU by {worst[k]}")
    for k in ("roi_mask", "roi_labels"):
        if not torch.equal(out_d[k].cpu(), out_c[k]):
            raise AssertionError(f"tiny detector: proposal NMS differs ({k})")
    for k in ("pred_mask", "pred_labels"):
        if not torch.equal(pp_d[k].cpu().sum(-1), pp_c[k].sum(-1)):
            raise AssertionError(f"tiny detector: final NMS differs ({k})")

    def kept(pp):
        b = pp["pred_boxes"][pp["pred_mask"]].cpu().double()
        return b[np.lexsort(b[:, :2].T.numpy()[::-1].copy())]

    box_err = (kept(pp_d) - kept(pp_c)).abs().max().item()
    if box_err > 1e-3:
        raise AssertionError(f"tiny detector: kept boxes differ by {box_err}")
    kept = int(pp_c["pred_mask"].sum())
    print(f"tiny detector, card vs CPU (TF32 off): max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; proposals {int(out_c['roi_mask'].sum())} and kept boxes {kept} "
          f"equal, max |box diff| {box_err:.3g}")
    if kept < 1:
        raise AssertionError("tiny detector kept no box")


@torch.no_grad()
def check_conv_input_dense(model, dcfg, points, valid):
    """conv_input, a submanifold conv, through the rulebook at the flagship
    input against a dense F.conv3d of the scattered grid, read at the active
    sites (f32, TF32 off). Returns (active voxels, max |diff|, scale)."""
    feats, coords, mask = voxelize_batch(
        points[None], valid[None], point_cloud_range=dcfg.point_cloud_range,
        voxel_size=dcfg.voxel_size, max_voxels=dcfg.max_voxels,
        max_points_per_voxel=dcfg.max_points_per_voxel)
    st = SP.make_sparse_tensor(feats, coords, mask, dcfg.sparse_shape, 1)
    conv = model.backbone_3d.conv_input._modules["0"]
    got = SP.subm_conv3d(st, conv.rulebook(torch.float32), 3, 1).features
    dense = SP.to_dense(st).permute(0, 4, 1, 2, 3)          # (1, C, D, H, W)
    ref = torch.nn.functional.conv3d(
        dense, conv.weight.permute(0, 4, 1, 2, 3).float(), padding=1)
    c = coords[mask].long()
    ref = ref[0].permute(1, 2, 3, 0)[c[:, 1], c[:, 2], c[:, 3]]   # (N, C)
    err = (got[mask] - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not err <= 1e-5 * scale + 1e-4:
        raise AssertionError(f"conv_input off the dense conv3d by {err}")
    return int(mask.sum()), err, scale


def time_nms(out, dcfg, cfg):
    """CUDA-event ms of the two NMS passes of a detector frame, fed the
    frame's own inputs, and of the proposal pass's greedy scan alone."""
    rcfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG["TEST"]
    post = cfg.MODEL.POST_PROCESSING
    scores, _ = out["batch_cls_preds"][0].max(-1)
    boxes = out["batch_box_preds"][0, :, :7]
    k = min(int(rcfg.NMS_PRE_MAXSIZE), boxes.shape[0])
    top = boxes[torch.topk(scores, k).indices]
    overlap = boxes_iou_bev(top, top)
    valid = torch.ones(k, dtype=torch.bool, device=top.device)
    iou = torch.sigmoid(out["rcnn_iou"][0])
    return {
        "proposal_nms": time_cuda(lambda: nms_bev(
            boxes, scores, float(rcfg.NMS_THRESH), int(rcfg.NMS_PRE_MAXSIZE),
            int(rcfg.NMS_POST_MAXSIZE)), reps=5),
        "proposal_greedy_scan": time_cuda(lambda: NMS._greedy_suppress(
            overlap, valid, float(rcfg.NMS_THRESH)), reps=5),
        "final_nms": time_cuda(lambda: nms_bev(
            out["rois"][0, :, :7], iou, float(post.NMS_CONFIG.NMS_THRESH),
            int(post.NMS_CONFIG.NMS_PRE_MAXSIZE),
            int(post.NMS_CONFIG.NMS_POST_MAXSIZE), float(post.SCORE_THRESH),
            out["roi_mask"][0]), reps=5),
        "k": k}


@torch.no_grad()
def check_small_frame_against_cpu(dev):
    """Each SEE stage on the card against the port's CPU path (which the
    tests hold against JAX) on a small scene, both stages fed the CPU's
    inputs, so a difference cannot cascade from one stage to the next."""
    cpu = torch.device("cpu")
    small = make_scene(1, 4096, 4, pts_per_car=300)
    sd = seeded_vcn_state_dict(1)
    sc = {w: _to(w, small) for w in (dev, cpu)}
    vcn = {w: VCNInference("VCN_VC", sd, device=w) for w in (dev, cpu)}
    cam = {w: (torch.from_numpy(PROJ).to(w), torch.from_numpy(LIDAR_TO_CAM).to(w))
           for w in (dev, cpu)}
    iso, ok = {}, {}
    for w in (dev, cpu):
        iso[w], ok[w] = F.isolate_stage(
            sc[w]["points"], sc[w]["valid"], sc[w]["det_boxes"],
            sc[w]["det_masks"], sc[w]["det_scores"], *cam[w], IMAGE_SIZE)
    iso_err = (iso[dev].cpu() - iso[cpu]).abs().max().item()
    x = iso[cpu]
    coarse = {w: vcn[w].model({"input": x.to(w)})["coarse"].cpu()
              for w in (dev, cpu)}
    coarse_err = (coarse[dev] - coarse[cpu]).abs().max().item()
    # partial mesh, cluster and the sanity guard, fed the CPU's coarse cloud
    comp, sane = {}, {}
    for w in (dev, cpu):
        xs, cs = x.to(w), coarse[cpu].to(w)
        surface = partial_mesh_batch(xs, cs, k=30, surface_pts=cs.shape[1])
        c = largest_cluster_batch(surface, eps=0.4, min_points=2,
                                  total_pts=cs.shape[1])
        comp[w] = c.cpu()
        sane[w] = DP.completion_sanity_mask(
            xs, c, torch.ones(c.shape[0], dtype=torch.bool, device=w)).cpu()
    comp_diff = int((comp[dev] != comp[cpu]).any(-1).sum())
    iv = ok[cpu] & sane[cpu]
    nv = {w: F.replace_stage(sc[w]["points"], sc[w]["valid"], comp[cpu].to(w),
                             iv.to(w), cand_cap=512)[1].cpu() for w in (dev, cpu)}
    nv_diff = int((nv[dev] != nv[cpu]).sum())
    print(f"small frame, card vs CPU stage by stage: isolation ok equal "
          f"{torch.equal(ok[dev].cpu(), ok[cpu])}, max |iso diff| {iso_err:.3g} m; "
          f"max |coarse diff| {coarse_err:.3g} m; completed points that differ "
          f"{comp_diff}, sane equal {torch.equal(sane[dev], sane[cpu])}; "
          f"replacement validity differences {nv_diff} "
          f"({int(iv.sum())} valid instances)")
    if not torch.equal(ok[dev].cpu(), ok[cpu]) or iso_err > 1e-5:
        raise AssertionError("small frame: isolation differs from the CPU path")
    if coarse_err > 1e-3 or comp_diff or not torch.equal(sane[dev], sane[cpu]):
        raise AssertionError("small frame: VCN differs from the CPU path")
    if nv_diff or not iv.any():
        raise AssertionError("small frame: replacement differs from the CPU path")


def _check_close(name, got, ref, worst, tol=1e-4):
    """Raise unless |got - ref| <= tol * (max |ref| + |ref|) everywhere;
    record the worst |difference| under ``name``."""
    got, ref = got.cpu(), ref.cpu()
    err = (got - ref).abs()
    worst[name] = err.max().item()
    if not (err <= tol * (ref.abs().max() + ref.abs())).all():
        raise AssertionError(f"tiny seg2d: {name} off the CPU by {worst[name]}")


@torch.no_grad()
def check_tiny_seg2d_against_cpu(dev):
    """The tiny Mask R-CNN (tiny_seg2d_cfg, weights from a seed with random
    biases and batch-norm statistics) with TF32 off, on the card against the
    port's CPU path (which the tests hold against JAX). The RPN outputs, and
    the box head's logits and deltas and the mask head's logits, each on
    the card from the CPU's maps and boxes (RoIAlign included), so that a
    difference cannot cascade: within 1e-4 of (their scale + |value|), f32
    sums in another order. Then the whole forward: the same number of kept
    detections, their scores within 1e-5, and in every slot whose score
    lies more than 1e-5 from every other slot's the same class, its box
    within 1e-3 px and its mask within 1e-4 (zero-score slots tie, and fill
    in index order)."""
    cfg = tiny_seg2d_cfg()
    cpu = torch.device("cpu")
    sd = seeded_state_dict(4, build_seg2d(cfg, device=cpu), random_stats=True)
    m_c, m_d = build_seg2d(cfg, sd, device=cpu), build_seg2d(cfg, sd, device=dev)
    image = torch.from_numpy(np.random.RandomState(5).rand(
        1, *cfg.image_size, 3).astype(np.float32))
    worst = {}
    feats, obj, box = m_c.features(image)
    feats_d, obj_d, box_d = m_d.features(image.to(dev))
    for k, (fc, fd) in enumerate(zip(feats, feats_d)):
        _check_close(f"P{k + 2}", fd, fc, worst)
    _check_close("rpn_obj", obj_d, obj, worst)
    _check_close("rpn_box", box_d, box, worst)
    rois, valid, _ = SM.proposals(cfg, m_c.anchors, obj[0], box[0])
    strides = cfg.strides[:4]
    maps = m_c.roi_maps(feats, 0)
    maps_d = [m.to(dev) for m in maps]
    cls, deltas = m_c.box_head(SM.roi_align(maps, strides, rois, 7))
    cls_d, deltas_d = m_d.box_head(SM.roi_align(maps_d, strides, rois.to(dev), 7))
    _check_close("cls_logits", cls_d, cls, worst)
    _check_close("box_deltas", deltas_d, deltas, worst)
    boxes, _, _ = SM.decode_detections(cfg, rois, valid, cls, deltas)
    logits = m_c.mask_head(SM.roi_align(maps, strides, boxes, 14))
    logits_d = m_d.mask_head(SM.roi_align(maps_d, strides, boxes.to(dev), 14))
    _check_close("mask_logits", logits_d, logits, worst)

    out_c, out_d = m_c(image), m_d(image.to(dev))
    sc, sd_ = out_c["det_scores"][0], out_d["det_scores"][0].cpu()
    n_kept = int((sc > 0).sum())
    if int((sd_ > 0).sum()) != n_kept or not torch.allclose(
            sd_.sort().values, sc.sort().values, atol=1e-5, rtol=0):
        raise AssertionError("tiny seg2d: detection scores differ from the CPU")
    gap = (sc[:, None] - sc[None, :]).abs() + torch.eye(len(sc)) * 1e9
    apart = gap.min(1).values > 1e-5
    for k, tol in (("det_boxes", 1e-3), ("det_masks", 1e-4)):
        err = (out_d[k][0].cpu() - out_c[k][0])[apart].abs()
        worst[k] = err.max().item() if err.numel() else 0.0
        if worst[k] > tol:
            raise AssertionError(f"tiny seg2d: {k} off the CPU by {worst[k]}")
    if not torch.equal(out_d["det_cls"][0].cpu()[apart], out_c["det_cls"][0][apart]):
        raise AssertionError("tiny seg2d: detection classes differ from the CPU")
    print(f"tiny seg2d, card vs CPU (TF32 off): max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; {n_kept} kept detections, {int(apart.sum())} slots apart compared")
    if n_kept < 1:
        raise AssertionError("tiny seg2d kept no detection")


@torch.no_grad()
def time_seg2d_nms(seg, image):
    """CUDA-event ms of the mask model's two NMS passes, fed the inputs of
    its own forward on ``image``: the proposal pass (top 1,024 of the RPN's
    scores, decode, IoU, greedy scan, compaction) and its greedy scan
    alone; the detection pass (softmax, decode, sort, IoU, greedy scan, top
    32) and its greedy scan alone."""
    cfg = seg.cfg
    feats, obj, box = seg.features(image)
    obj, box = obj[0], box[0]
    rois, valid, _ = SM.proposals(cfg, seg.anchors, obj, box)
    cls, deltas = seg.box_head(SM.roi_align(seg.roi_maps(feats, 0), cfg.strides[:4],
                                            rois, 7))
    top, order = torch.sort(obj, descending=True, stable=True)
    k = cfg.pre_nms_topk
    props = SM.decode_deltas(box[order[:k]], seg.anchors[order[:k]], cfg.image_size)
    prop_iou = boxes_iou_normal(props, props)
    prop_ok = torch.isfinite(top[:k])
    score = torch.where(valid, torch.softmax(cls, -1)[:, 1], 0.0)
    s, order = torch.sort(score, descending=True, stable=True)
    dets = SM.decode_deltas(deltas[:, 0], rois, cfg.image_size)[order]
    det_iou = boxes_iou_normal(dets, dets)
    return {
        "proposal_nms": time_cuda(lambda: SM.proposals(cfg, seg.anchors, obj, box),
                                  reps=5),
        "proposal_greedy_scan": time_cuda(lambda: NMS._greedy_suppress(
            prop_iou, prop_ok, cfg.proposal_nms_thresh), reps=5),
        "detection_nms": time_cuda(lambda: SM.decode_detections(
            cfg, rois, valid, cls, deltas), reps=5),
        "detection_greedy_scan": time_cuda(lambda: NMS._greedy_suppress(
            det_iou, s > cfg.test_score_thresh, cfg.test_nms_thresh), reps=5),
        "k": [k, int(rois.shape[0])]}


def profile_frame(args, fn=F.complete_frame):
    """One call of ``fn`` (a SEE frame by default) under torch.profiler:
    (device ms summed over its kernels, the six PyTorch ops and kernels
    whose own launches took most device time, as (name, ms))."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    busy, per_op = 0.0, {}
    for e in prof.key_averages():
        ms = (getattr(e, "self_device_time_total", 0) or 0) / 1e3
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += ms
        elif ms:
            per_op[e.key] = per_op.get(e.key, 0.0) + ms
    return busy, sorted(per_op.items(), key=lambda kv: -kv[1])[:6]


def tiny_train_inputs(dev):
    """Two blob frames for _tiny_detector_cfg, ground-truth cars on them,
    and fixed RoI-sampler priorities u, as tensors on ``dev``."""
    frames = [blob_points(seed, 600) for seed in (1, 2)]
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, 0] = [8.0, 0.0, -0.5, 4.0, 1.8, 1.5, 0.3, 1.0]
    gt[0, 1] = [5.0, 3.0, -0.5, 4.0, 1.8, 1.5, 1.3, 1.0]
    gt[1, 1] = [11.0, -4.0, -0.3, 3.9, 1.7, 1.5, -0.4, 1.0]
    u = np.random.RandomState(8).rand(2, 32).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in
            (np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
             gt, u)]


def check_tiny_train_step_against_cpu(dev):
    """One train step at _tiny_detector_cfg (DP_RATIO 0, fixed RoI
    priorities, TF32 off) on the card and on the CPU from the same weights
    (which the tests hold against JAX's make_train_step). Tolerances, as the
    tests hold the CPU to JAX: loss terms 1e-5 (absolute and relative);
    gradients (after the clip) 5e-4 of their tensor's largest; updated
    parameters 1e-5 where the gradient is sure (at least 5% of its tensor's
    largest and 1e-6 after the clip), 2 lr elsewhere (Adam's first step is
    lr g / (|g| + 1e-8): a gradient that is rounding noise may take either
    sign); running statistics 1e-5 (absolute and relative). Returns the
    worst |diff| of each group."""
    cfg = DC.tiny_detector_cfg()
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    cpu = torch.device("cpu")
    sd = seeded_state_dict(5, build_detector(cfg, device=cpu)[0], random_stats=True)
    res = {}
    for w in (dev, cpu):
        model, _ = build_detector(cfg, sd, max_voxels=512, device=w)
        state = create_train_state(model, cfg.OPTIMIZATION, 100)
        pts, valid, gt, u = tiny_train_inputs(w)
        loss, tb, _ = train_forward(state, pts, valid, gt, roi_u=u)
        apply_gradients(state, loss)
        res[w] = ({"loss": loss.detach().cpu(), **{k: v.detach().cpu() for k, v in tb.items()}},
                  {n: p.grad.cpu() for n, p in model.named_parameters()},
                  {n: p.detach().cpu() for n, p in model.named_parameters()},
                  {n: b.cpu() for n, b in model.named_buffers()
                   if not n.endswith("num_batches_tracked")})
    (terms_d, grads_d, params_d, stats_d), (terms_c, grads_c, params_c, stats_c) = \
        res[dev], res[cpu]
    lr = build_lr_schedule(cfg.OPTIMIZATION, 100)(0)
    worst = {}

    def group(name, pairs, tol_fn):
        worst[name] = 0.0
        for key, (got, ref) in pairs.items():
            err = (got - ref).abs()
            worst[name] = max(worst[name], err.max().item())
            if not (err <= tol_fn(key, ref)).all():
                raise AssertionError(f"tiny train step: {name} {key} off the CPU by "
                                     f"{err.max().item()}")

    group("loss terms", {k: (terms_d[k], terms_c[k]) for k in terms_c},
          lambda k, ref: 1e-5 + 1e-5 * ref.abs())
    group("gradients", {k: (grads_d[k], grads_c[k]) for k in grads_c},
          lambda k, ref: 5e-4 * ref.abs().max() + 1e-9)

    def param_tol(k, ref):
        g = grads_c[k].abs()
        sure = (g >= 0.05 * g.max()) & (g >= 1e-6)
        return torch.where(sure, 1e-5, 2 * lr)

    group("updated parameters", {k: (params_d[k], params_c[k]) for k in params_c},
          param_tol)
    group("running statistics", {k: (stats_d[k], stats_c[k]) for k in stats_c},
          lambda k, ref: 1e-5 + 1e-5 * ref.abs())
    print("tiny train step, card vs CPU (TF32 off, DP_RATIO 0, fixed RoI priorities): "
          "max |diff| " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; loss {terms_c['loss'].item():.5f}")
    return worst


def check_gt_completion(vcn, scenes, dev):
    """GT-box SEE completion of the frames on the card, K1 counted: it must
    launch at least once a frame, and each frame's new_valid must equal the
    plain full-cloud recomputation of the replacement (points within 1e-5
    r^2 of r^2 excepted). Returns (new_pts, new_valid, gt_boxes, stats,
    launches, ms a frame)."""
    pts, valid, gt = (torch.from_numpy(np.stack([sc[k] for sc in scenes])).to(dev)
                      for k in ("points", "valid", "gt_boxes"))
    gt_mask = torch.ones(gt.shape[:2], dtype=torch.bool, device=dev)
    K.reset_launches()
    new_pts, new_valid, stats = complete_gt_frames(vcn, pts, valid, gt, gt_mask)
    torch.cuda.synchronize()
    launches = K.LAUNCHES["min_sqdist_pruned"]
    f, p = pts.shape[:2]
    if launches < f:
        raise AssertionError(f"K1 launched {launches} times for {f} GT frames")
    inst_valid = stats["inst_valid"]
    mismatches = ties = 0
    for i in range(f):
        flat = stats["completed"][i].reshape(-1, 3)
        flat_valid = inst_valid[i].repeat_interleave(stats["completed"].shape[2])
        d = MD.min_sqdist_plain(pts[i], flat, flat_valid)
        expect = valid[i] & ~(d <= RADIUS * RADIUS)
        tie = (d - RADIUS * RADIUS).abs() <= 1e-5 * RADIUS * RADIUS
        mismatches += int(((expect != new_valid[i, :p]) & ~tie).sum())
        ties += int(tie.sum())
        if not torch.equal(new_valid[i, p:], flat_valid):
            raise AssertionError("GT completion: spliced points' validity is wrong")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        complete_gt_frames(vcn, pts, valid, gt, gt_mask)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / f)
    ms = statistics.median(times)
    dropped = int((valid & ~new_valid[:, :p]).sum())
    print(f"GT completion of {f} frames ({p} points, {gt.shape[1]} GT boxes each): "
          f"isolated {int(stats['ok'].sum())}, sane {int(stats['sane'].sum())}, "
          f"spliced {int(inst_valid.sum())} of {f * gt.shape[1]}; {dropped} scan "
          f"points dropped; K1 launches {launches}; new_valid vs the plain "
          f"full-cloud sweep: {mismatches} mismatches ({ties} points within 1e-5 "
          f"r^2 of r^2); {ms:.2f} ms a frame (host clock, median of 3 batches)")
    if mismatches:
        raise AssertionError("GT completion's replacement disagrees with the plain sweep")
    if int(inst_valid.sum()) < f or dropped < 1:
        raise AssertionError("GT completion did no real work")
    return new_pts, new_valid, gt, stats, launches, ms


def check_conv_backward_bf16(dcfg, pts, valid, cap, dev):
    """The rulebook conv's backward in bf16 at the flagship's training
    shapes: a 16 -> 16 submanifold conv (conv1's width) on the voxels of the
    train frames at the train cap, more rows than one matrix product's
    GEMM_ROWS, held against its plain version (autograd of
    gather_matmul_plain) run in f32 on the same bf16 values. Tolerances: dW
    1e-4 of max |dW| (f32 products and sums, in another order); dx 2^-7 of
    each element plus 1e-4 of max |dx| (a bf16 result). Returns the summary
    dict: rows, each error over its max, and forward + backward ms of both."""
    _, coords, mask = voxelize_batch(
        pts, valid, point_cloud_range=dcfg.point_cloud_range,
        voxel_size=dcfg.voxel_size, max_voxels=cap,
        max_points_per_voxel=dcfg.max_points_per_voxel)
    gen = torch.Generator(device=dev).manual_seed(3)
    n = coords.shape[0]
    x = torch.randn((n, 16), generator=gen, device=dev).bfloat16()
    w = (torch.randn((27, 16, 16), generator=gen, device=dev) * 0.1).bfloat16().float()
    r = torch.randn((n, 16), generator=gen, device=dev).bfloat16().float()

    def grads(feats):
        xg, wg = feats.detach().requires_grad_(True), w.detach().requires_grad_(True)
        st = SP.make_sparse_tensor(xg, coords, mask, dcfg.sparse_shape, pts.shape[0])
        (SP.subm_conv3d(st, wg).features.float() * r).sum().backward()
        return xg.grad.float(), wg.grad

    dx, dw = grads(x)
    ms = time_cuda(lambda: grads(x), reps=3, warmup=1)
    with plain_sparse_backward():
        dx_p, dw_p = grads(x.float())
        plain_ms = time_cuda(lambda: grads(x.float()), reps=3, warmup=1)
    dw_scale, dx_scale = dw_p.abs().max().item(), dx_p.abs().max().item()
    dw_err = (dw - dw_p).abs().max().item()
    dx_bad = int(((dx - dx_p).abs() > 2 ** -7 * dx_p.abs() + 1e-4 * dx_scale).sum())
    res = {"rows": int(mask.sum()), "dw_err_over_max": dw_err / dw_scale,
           "dx_err_over_max": (dx - dx_p).abs().max().item() / dx_scale,
           "ms": ms, "plain_f32_ms": plain_ms}
    print(f"bf16 sparse conv backward at the flagship's train shapes ({res['rows']} "
          f"active rows, {SP.GEMM_ROWS} a matrix product, 16 -> 16 subm) vs its plain "
          f"version in f32: max |dW diff| {res['dw_err_over_max']:.3g} of max |dW|, "
          f"max |dx diff| {res['dx_err_over_max']:.3g} of max |dx| ({dx_bad} elements "
          f"past 2^-7 relative + 1e-4 of max); forward + backward {ms:.2f} ms, plain "
          f"f32 {plain_ms:.2f} ms (CUDA events, median of 3)")
    if not res["rows"] > SP.GEMM_ROWS:
        raise AssertionError("the bf16 conv check did not span two matrix products")
    if dw_err > 1e-4 * dw_scale or dx_bad:
        raise AssertionError("the bf16 sparse conv backward disagrees with its plain version")
    return res


def check_roi_sampler_against_cpu(det_cfg, gt, dev):
    """The RoI sampler and the IoU loss at the flagship's training shapes
    (NMS_CONFIG.TRAIN's NMS_POST_MAXSIZE RoIs a frame, ROI_PER_IMAGE sampled,
    the frames' GT boxes), on the card against the CPU, for RoIs jittered
    around the GT boxes (foreground, hard and easy background, an invalid
    tail) with fixed priorities. Sampled RoIs, labels, masks and assigned GT
    boxes equal; IoUs and IoU labels within 1e-5; the loss within 1e-5
    (relative). Returns the sampled foreground, hard and easy background
    counts and the loss's |diff|."""
    rcfg = det_cfg.MODEL.ROI_HEAD
    r = int(rcfg.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
    rng = np.random.RandomState(21)
    gt_np = gt.cpu().numpy()
    rois, u = [], rng.rand(gt_np.shape[0], r).astype(np.float32)
    for g in gt_np:
        src = g[rng.randint(0, len(g), r), :7]
        jitter = rng.randn(r, 7).astype(np.float32) * [0.4, 0.4, 0.1, 0.3, 0.2, 0.1, 0.2]
        scale = rng.uniform(0, 2, (r, 1))
        scale[r // 5: r // 5 + r // 4] *= 0.1            # near copies: foreground
        b = (src + jitter * scale).astype(np.float32)
        b[: r // 5, :2] += 20.0
        b[:, 3:6] = np.maximum(np.abs(b[:, 3:6]), 0.5)
        rois.append(b)
    roi_mask = np.broadcast_to(np.arange(r) < 7 * r // 8, u.shape)
    rois = np.where(roi_mask[..., None], np.stack(rois), 0.0).astype(np.float32)
    inputs = (u, rois, roi_mask.astype(np.int32), rng.randn(*u.shape).astype(np.float32),
              roi_mask, gt_np)
    logits = rng.randn(gt_np.shape[0], int(rcfg.TARGET_CONFIG.ROI_PER_IMAGE)).astype(
        np.float32)
    lcfg = rcfg.LOSS_CONFIG
    res = []
    for w in (dev, torch.device("cpu")):
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(w) for a in inputs]
        per = [RH.sample_rois_for_rcnn(*a, rcfg.TARGET_CONFIG) for a in zip(*t)]
        tg = {k: torch.stack([p[k] for p in per]).cpu() for k in per[0]}
        loss = RH.rcnn_iou_loss(torch.from_numpy(logits).to(w), tg["rcnn_cls_labels"].to(w),
                                loss_type=lcfg.IOU_LOSS,
                                weight=float(lcfg.LOSS_WEIGHTS["rcnn_iou_weight"]))
        res.append((tg, loss.cpu()))
    (got, loss_d), (ref, loss_c) = res
    for k in ("rois", "roi_labels", "reg_valid_mask", "gt_of_rois", "roi_sample_mask"):
        if not torch.equal(got[k], ref[k]):
            raise AssertionError(f"RoI sampler on the card: {k} differs from the CPU")
    iou_err = max((got[k] - ref[k]).abs().max().item()
                  for k in ("gt_iou_of_rois", "rcnn_cls_labels"))
    loss_err = (loss_d - loss_c).abs().item()
    tcfg = rcfg.TARGET_CONFIG
    sel, iou = ref["roi_sample_mask"], ref["gt_iou_of_rois"]
    fg = (sel & (iou >= float(tcfg.REG_FG_THRESH))).sum(1).tolist()
    hard = (sel & (iou >= float(tcfg.CLS_BG_THRESH_LO))
            & (iou < float(tcfg.REG_FG_THRESH))).sum(1).tolist()
    easy = (sel & (iou < float(tcfg.CLS_BG_THRESH_LO))).sum(1).tolist()
    print(f"RoI sampler and IoU loss at the flagship's shapes ({r} RoIs a frame around "
          f"{gt_np.shape[1]} GT boxes), card vs CPU: sampled RoIs, labels, masks and GT "
          f"equal; max |IoU diff| {iou_err:.3g}; loss {loss_c.item():.5f}, |diff| "
          f"{loss_err:.3g}; sampled fg {fg}, hard bg {hard}, easy bg {easy}")
    if iou_err > 1e-5 or loss_err > 1e-5 * max(1.0, abs(loss_c.item())):
        raise AssertionError("RoI sampler or IoU loss on the card off the CPU")
    if min(fg) < 1 or min(hard) < 1 or min(easy) < 1:
        raise AssertionError("the RoI sampler check did not fill every stratum")
    return {"fg": fg, "hard_bg": hard, "easy_bg": easy, "iou_err": iou_err,
            "loss_err": loss_err}


def train_flagship(det_cfg, pts, valid, gt, dev, steps: int = 10):
    """SECOND-IoU train steps at _flagship_detector_cfg (bf16 3D backbone,
    MAX_NUMBER_OF_VOXELS' train cap, weights from a seed) on the completed
    frames: a warm-up step and ``steps`` timed ones (host clock ending in a
    synchronize), one split by CUDA events into forward, loss and
    backward+update, one under torch.profiler. Raises unless every loss is
    finite, every parameter's gradient finite and non-zero somewhere, and
    every parameter moved. Returns the summary dict."""
    cap = int(det_cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    cpu_model, _ = build_detector(det_cfg, max_voxels=cap, device="cpu")
    model, dcfg = build_detector(det_cfg, seeded_state_dict(0, cpu_model),
                                 max_voxels=cap, device=dev)
    state = create_train_state(model, det_cfg.OPTIMIZATION, total_steps=1000)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, tb, out = train_forward(state, pts, valid, gt, gen)
    apply_gradients(state, loss)
    losses = [{"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}]
    for n, p in model.named_parameters():
        if not torch.isfinite(p.grad).all() or not p.grad.any():
            raise AssertionError(f"gradient of {n} is not finite or all zero")
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_step(state, pts, valid, gt, gen))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    fwd = model(pts, valid, gt_boxes=gt, generator=gen)
    ev[1].record()
    loss, _ = model.loss(fwd, gt)
    ev[2].record()
    apply_gradients(state, loss)
    ev[3].record()
    torch.cuda.synchronize()
    split = {k: ev[i].elapsed_time(ev[i + 1])
             for i, k in enumerate(("forward", "loss", "backward_update"))}
    busy, top = profile_frame((state, pts, valid, gt, gen), train_step)
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError("a training loss is not finite")
    still = [n for n, p in model.named_parameters() if torch.equal(p, start[n])]
    if still:
        raise AssertionError(f"parameters did not move: {still[:5]}")
    _, coords, mask = voxelize_batch(
        pts, valid, point_cloud_range=dcfg.point_cloud_range,
        voxel_size=dcfg.voxel_size, max_voxels=cap,
        max_points_per_voxel=dcfg.max_points_per_voxel)
    per_frame = torch.bincount(coords[mask][:, 0].long(), minlength=pts.shape[0])
    tg = out["rcnn_targets"]
    fg_thresh = float(det_cfg.MODEL.ROI_HEAD.TARGET_CONFIG.REG_FG_THRESH)
    fg = (tg["roi_sample_mask"] & (tg["gt_iou_of_rois"] >= fg_thresh)).sum(1)
    bg = tg["roi_sample_mask"].sum(1) - fg
    step_ms = statistics.median(times)
    summary = {
        "step_ms": step_ms, "frames_per_s": pts.shape[0] * 1e3 / step_ms,
        "step_ms_all": times, "split_ms": split, "peak_gib": peak,
        "device_busy_ms": busy, "top_ops": top,
        "losses": [m["loss"] for m in values], "last_terms": values[-1],
        "active_voxels": per_frame.tolist(), "voxel_cap": cap,
        "cap_bound": [int(v) >= cap for v in per_frame],
        "proposals": out["roi_mask"].sum(1).tolist(),
        "sampled_fg": fg.tolist(), "sampled_bg": bg.tolist()}
    print(f"flagship train steps on {pts.shape[0]} completed frames "
          f"({pts.shape[1]} points each): losses "
          + ", ".join(f"{v:.4f}" for v in summary["losses"])
          + f"; last terms " + ", ".join(f"{k} {v:.4f}" for k, v in values[-1].items())
          + f"; active voxels per frame {summary['active_voxels']} (cap {cap}, "
          f"bound {summary['cap_bound']}); proposals {summary['proposals']}; "
          f"sampled RoIs fg {summary['sampled_fg']} bg {summary['sampled_bg']}")
    print(f"train step {step_ms:.2f} ms (host clock to a synchronize, median of "
          f"{steps}) = {summary['frames_per_s']:.2f} frames/s; CUDA events: forward "
          f"{split['forward']:.2f} ms, loss {split['loss']:.2f} ms, backward + update "
          f"{split['backward_update']:.2f} ms; peak device memory {peak:.2f} GiB; "
          f"profiled step: device busy {busy:.2f} ms; device time by op: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top))
    return summary


# scripts/train_vcn_synthetic.py:78-84: the repo's VCN_VC training recipe
VCN_RECIPE = {"model": {"NAME": "VCN_VC"},
              "losses": ["coarse", "partial", "translation", "rotation", "dims"],
              "loss_weights": [1.0, 1.0, 10.0, 1.0, 1.0],
              "optimizer": {"type": "Adam", "kwargs": {"lr": 1e-3}},
              "scheduler": {"type": "StepLR", "kwargs": {"step_size": 40, "gamma": 0.7}}}


def make_vc_data(out_dir: str, n_meshes: int = 6, n_poses: int = 12) -> str:
    """The VCN recipe's training data (scripts/train_vcn_synthetic.py:22-34,
    :56-73), made by the port's vc_shapenet: procedural car meshes written
    as .obj in ShapeNet's frame (y up, -z forward), poses drawn from the same
    RandomState(0) after them, generate_vc_dataset(n_complete=4096,
    rng=default_rng(1)). -> the VC-ShapeNet directory."""
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(out_dir, "meshes"))
    meshes = []
    for i in range(n_meshes):
        verts, faces = VS.procedural_car_mesh(rng)
        meshes.append(os.path.join(out_dir, "meshes", f"car{i}.obj"))
        with open(meshes[-1], "w") as f:
            for x, y, z in verts:
                f.write(f"v {y:.4f} {z:.4f} {-x:.4f}\n")
            for a, b, c in faces:
                f.write(f"f {a + 1} {b + 1} {c + 1}\n")
    poses = []
    for _ in range(n_poses):
        d, ang = rng.uniform(6, 35), rng.uniform(-0.5, 0.5)
        poses.append(np.array([d * np.cos(ang), d * np.sin(ang), 0.0,
                               rng.uniform(3.8, 4.6), 0, 0, rng.uniform(-np.pi, np.pi)]))
    data_dir = os.path.join(out_dir, "vc_data")
    VS.generate_vc_dataset(meshes, poses, data_dir, n_complete=4096,
                           rng=np.random.default_rng(1), logger=lambda s: None)
    return data_dir


@contextlib.contextmanager
def relu_signs(net, pinned=None):
    """Within the block, record where the input of each of the net's ReLUs
    and LeakyReLUs is positive, into the list yielded (bool, on the CPU).
    Given ``pinned``, such a list from another run, each takes its slope
    from there in place of its own input's sign. Only forwards that record
    gradients count: vcn_pool_points re-runs the pose encoder under
    no_grad."""
    signs, queue = [], None if pinned is None else list(pinned)

    def record(mod, inputs, out):
        if not torch.is_grad_enabled():
            return None
        x = inputs[0]
        signs.append((x > 0).cpu())
        if queue is None:
            return None
        slope = getattr(mod, "negative_slope", 0.0)
        return torch.where(queue.pop(0).to(x.device), x, slope * x)

    hooks = [m.register_forward_hook(record) for m in net.modules()
             if isinstance(m, (torch.nn.ReLU, torch.nn.LeakyReLU))]
    try:
        yield signs
    finally:
        for h in hooks:
            h.remove()


def tiny_vcn_step(name, tiny, work, device, pinned=(None, None)):
    """One SGD step of a tiny ``name`` (num_coarse 128, the recipe's losses,
    weights from init_vcn_weights seed 1) on ``device``, its loss's choices
    and its ReLUs' signs recorded or, given ``pinned``, taken from another
    run (vcn_loss_selections, relu_signs): -> (loss terms, gradients,
    running statistics, the loss's choices, the max-pools' picks, the ReLUs'
    signs), on the CPU."""
    cfg = Cfg({**VCN_RECIPE, "model": {"NAME": name},
               "optimizer": {"type": "SGD", "kwargs": {"lr": 1e-3}}})
    tr = VCNTrainer(cfg, work_dir=work, device=device)
    tr.model = build_vcn(name, num_coarse=128)
    state = tr.init_state(10, seed=1)
    with vcn_pool_points(state.model) as pools, \
            relu_signs(state.model, pinned[1]) as signs, \
            vcn_loss_selections(pinned[0]) as choices:
        terms = tr.train_step(state, tr.to_device(tiny))
    return ({k: v.cpu() for k, v in terms.items()},
            {n: p.grad.cpu() for n, p in state.model.named_parameters()},
            {n: b.cpu() for n, b in state.model.named_buffers() if "running" in n},
            choices, pools, signs)


def worst_rel(got, ref):
    """(max |got - ref| / max |ref|, name) over the tensors of two gradient
    dicts, but VCN_BIASES_BEFORE_BN (rounding noise on both sides)."""
    return max((float((got[k] - ref[k]).abs().max() / ref[k].abs().max()), k)
               for k in ref if k not in VCN_BIASES_BEFORE_BN)


def check_tiny_vcn_steps_against_cpu(batch, work, dev):
    """One SGD train step of a tiny VCN_VC and VCN_CN on the first 4 samples
    of a data batch cut to 128 input and 256 complete points, on the card
    and on the CPU (which the tests hold against JAX), f32 with TF32 off:
    loss terms and running statistics within 1e-5 (absolute and relative).
    Both record the step's discrete choices: the loss's (FPS, the partial
    meshes' top-30 masks, the chamfers' nearest neighbours, the rotation's
    target and clamp: vcn_loss_selections), the max-pools' picks and the
    ReLUs' signs. One that sits within rounding of its switch can go the
    other way on the card and move the gradients by design: the choices
    that differ are printed, with the gradient difference they make and the
    tensor it is largest in. Then the card's step runs again with its
    loss's choices and its ReLUs' signs pinned to the CPU's (relu_signs),
    and its gradients are held within
    5e-4 of each tensor's largest (assert_vcn_grads_close); the max-pools'
    picks and the rotation's target and clamp must agree already
    (precondition). The pinned step with TF32 on is printed beside, the
    size of error that the bound is there to catch. Returns the worst
    |diff| of each group and model, and the choices that differed."""
    tiny = {k: batch[k][:4, :n] for k, n in (("input", 128), ("complete", 256))}
    tiny["gt_boxes"] = batch["gt_boxes"][:4]
    worst = {}
    for name in ("VCN_VC", "VCN_CN"):
        t_c, g_c, s_c, ch_c, pool_c, relu_c = tiny_vcn_step(name, tiny, work,
                                                            torch.device("cpu"))
        t_d, g_d, s_d, ch_d, pool_d, relu_d = tiny_vcn_step(name, tiny, work, dev)
        w_terms = max(abs(float(t_d[k] - t_c[k])) for k in t_c)
        w_stats = max(float((s_d[k] - s_c[k]).abs().max()) for k in s_c)
        for k in t_c:
            if abs(float(t_d[k] - t_c[k])) > 1e-5 + 1e-5 * abs(float(t_c[k])):
                raise AssertionError(f"tiny {name} step: {k} off the CPU")
        for k in s_c:
            if not ((s_d[k] - s_c[k]).abs() <= 1e-5 + 1e-5 * s_c[k].abs()).all():
                raise AssertionError(f"tiny {name} step: {k} off the CPU")
        flips = {w: n for w, (n, _) in vcn_selection_flips(ch_d, ch_c).items() if n}
        flips["max-pool picks"] = sum(int((a != b).sum()) for a, b in zip(pool_d, pool_c))
        flips["ReLU signs"] = sum(int((a != b).sum()) for a, b in zip(relu_d, relu_c))
        unpinned = worst_rel(g_d, g_c)
        g_pin = tiny_vcn_step(name, tiny, work, dev, pinned=(ch_c, relu_c))[1]
        pinned = worst_rel(g_pin, g_c)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = worst_rel(tiny_vcn_step(name, tiny, work, dev, pinned=(ch_c, relu_c))[1],
                             g_c)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        print(f"tiny {name} step, card vs CPU (f32, TF32 off): max |diff| loss terms "
              f"{w_terms:.3g}, running statistics {w_stats:.3g}; choices that differ "
              f"{flips}: gradients {unpinned[0]:.3g} of a tensor's largest (worst in "
              f"{unpinned[1]}); with the loss's choices and the ReLUs' signs pinned to "
              f"the CPU's {pinned[0]:.3g} ({pinned[1]}; bound 5e-4), and with TF32 on "
              f"as well {tf32[0]:.3g} ({tf32[1]}); loss {float(t_c['loss']):.5f}")
        if flips["max-pool picks"] or flips.get("rotation target") or \
                flips.get("geodesic clamp"):
            raise AssertionError(f"precondition: tiny {name} step: a max-pool pick or "
                                 f"the rotation's target or clamp differs on the card")
        w_grads = assert_vcn_grads_close(g_pin, g_c)
        worst[name] = {"loss_terms": w_terms, "running_stats": w_stats, "grads": w_grads,
                       "choices_differing": flips, "grads_over_max_unpinned": unpinned,
                       "grads_over_max_pinned": pinned, "grads_over_max_pinned_tf32": tf32}
    return worst


def check_fps_against_cpu(complete):
    """farthest_point_sample of (B, N, 3) points -> 1024 on the card and on
    the CPU: the same indices, or where a row first differs, a near-tie:
    both candidates' running min distances (recomputed on the CPU from the
    shared prefix) within 2 ulp. Returns [(row, step, card's, CPU's)]."""
    got = farthest_point_sample(complete, 1024).cpu()
    pts = complete.cpu()
    ref = farthest_point_sample(pts, 1024)
    flips = []
    for b in torch.nonzero((got != ref).any(1)).flatten().tolist():
        step = int(torch.nonzero(got[b] != ref[b])[0])
        diff = pts[b][:, None] - pts[b][ref[b, :step]][None]
        dx, dy, dz = diff.unbind(-1)
        min_d = (dx * dx + dy * dy + dz * dz).amin(1)
        a, c = float(min_d[got[b, step]]), float(min_d[ref[b, step]])
        flips.append((b, step, a, c))
        print(f"  fps flip: row {b} step {step}: card's pick at {a!r}, CPU's at {c!r}")
        if abs(a - c) > 2 * float(np.spacing(np.float32(max(a, c)))):
            raise AssertionError("fps on the card picks another point than the CPU")
    return flips


def check_metrics_against_cpu(out, batch, num_pts, dev):
    """MetricAccumulator.summary of one batch's predictions on the card and
    on the CPU. The F-scores count distances under a threshold and the
    partial-mesh chamfers take a top-30 selection, so where a distance sits
    within f32 rounding of its switch the two devices' f32 summaries differ
    by design: every key is held within 1e-5 (absolute and relative) in
    f64, where no switch sits that close, and the f32 keys off by more are
    printed. -> (worst f64 |diff|, worst f32 |diff|, the f32 keys off)."""
    worst, off = [], []
    for dtype in (torch.float64, torch.float32):
        sums = []
        for w in (dev, torch.device("cpu")):
            acc = MetricAccumulator()
            acc.update(*(t.to(w, dtype) for t in (out["coarse"], batch["complete"],
                                                 batch["gt_boxes"])), num_pts,
                       *(t.to(w, dtype) for t in (out["reg_rot"], out["reg_centre"])),
                       input_pts=batch["input"].to(w, dtype))
            sums.append(acc.summary())
        got, ref = sums
        if set(got) != set(ref):
            raise AssertionError("metrics on the card have other keys than the CPU's")
        off.append([k for k in ref if abs(got[k] - ref[k]) > 1e-5 + 1e-5 * abs(ref[k])])
        worst.append(max(abs(got[k] - ref[k]) for k in ref))
    print(f"MetricAccumulator.summary, card vs CPU on one batch ({len(ref)} keys): f64 "
          f"max |diff| {worst[0]:.3g}; f32 max |diff| {worst[1]:.3g}, past 1e-5 in "
          f"{off[1]} (thresholds and top-30 selections at a near-tie, not held)")
    if off[0]:
        raise AssertionError(f"metrics on the card off the CPU in f64: {off[0]}")
    return worst[0], worst[1], off[1]


def train_vcn(dev, card, steps: int = 10):
    """VCN training at the recipe's full width (VCN_VC, num_coarse 1024,
    batch 32 of 1024 input and 2048 complete points, Adam lr 1e-3, StepLR) on
    data the port generates: the checks against the CPU, a warm-up step and
    ``steps`` timed ones (host clock to a synchronize), one split by CUDA
    events into forward, loss and backward + update with FPS timed alone,
    one under torch.profiler; then a validation pass, and the checkpoint
    saved and reloaded into VCNInference. Raises unless every loss term is
    finite, every parameter and batch-norm statistic moved, the last timed
    step's loss is below the warm-up step's, the metrics are finite and the reloaded net is the
    trained one bit for bit. Returns the summary dict."""
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        data_dir = make_vc_data(work)
        gen_s = time.perf_counter() - t0
        ds = VCDataset(data_dir, transforms_cfg=[{"callback": "LidarSimulation"}],
                       n_points=1024, n_complete=2048)
        t0 = time.perf_counter()
        batches = []
        while len(batches) < steps + 2:
            batches += list(ds.batches(32))
        batches = batches[:steps + 2]
        load_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        print(f"VC data: {len(ds)} views of 6 procedural cars generated in {gen_s:.2f} s "
              f"(host); {load_ms:.1f} ms a batch of 32 to load, simulate and resample")

        tiny = check_tiny_vcn_steps_against_cpu(batches[0], work, dev)
        tr = VCNTrainer(Cfg(VCN_RECIPE), work_dir=work, device=dev)
        state = tr.init_state(total_steps=steps + 1)
        dev_batches = [tr.to_device(b) for b in batches]
        flips = check_fps_against_cpu(dev_batches[0]["complete"])
        print(f"fps (32, 2048) -> 1024, card vs CPU: {len(flips)} rows differ, each at a "
              f"near-tie within 2 ulp")
        metrics_err = check_metrics_against_cpu(
            tr.eval_step(state, dev_batches[0]), dev_batches[0], batches[0]["num_pts"], dev)

        start = {k: v.clone() for k, v in state.model.state_dict().items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [tr.train_step(state, dev_batches[0])]
        times = []
        for b in dev_batches[1:steps + 1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(tr.train_step(state, b))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        b = dev_batches[steps + 1]
        in_dict = {k: b[k] for k in ("input", "complete", "gt_boxes")}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        out = state.model(in_dict)
        ev[1].record()
        terms = state.model.loss(out, in_dict)
        total = sum(w * terms[n] for n, w in zip(tr.loss_names, tr.loss_weights))
        ev[2].record()
        apply_gradients(state, total)
        ev[3].record()
        torch.cuda.synchronize()
        split = {k: ev[i].elapsed_time(ev[i + 1])
                 for i, k in enumerate(("forward", "loss", "backward_update"))}
        fps_ms = time_cuda(lambda: fps(b["complete"], 1024), reps=5, warmup=1)
        fps_host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fps(b["complete"], 1024)
            torch.cuda.synchronize()
            fps_host.append((time.perf_counter() - t0) * 1e3)
        busy, top = profile_frame((state, b), tr.train_step)
        values = [{k: float(v) for k, v in m.items()} for m in losses]
        if not all(math.isfinite(v) for m in values for v in m.values()):
            raise AssertionError("a VCN loss term is not finite")
        sd = state.model.state_dict()
        still = [k for k in sd if not k.endswith("num_batches_tracked")
                 and torch.equal(sd[k], start[k])]
        if still:
            raise AssertionError(f"VCN parameters or statistics did not move: {still[:5]}")
        if not values[-1]["loss"] < values[0]["loss"]:
            raise AssertionError("the VCN loss did not fall below the warm-up step's")
        step_ms = statistics.median(times)

        val_ds = VCDataset(data_dir, n_points=1024, n_complete=2048)
        t0 = time.perf_counter()
        val = tr.validate(state, val_ds, 32)
        val_s = time.perf_counter() - t0
        shown = {k: val[k] for k in ("CDL1", "CDL2", "F1_010", "IOU_3D", "ROT_ERR",
                                     "TRANS_ERR")}
        if not all(math.isfinite(v) for v in shown.values()):
            raise AssertionError(f"a validation metric is not finite: {shown}")
        path = tr.save_checkpoint(state, "ckpt-last", epoch=0)
        vcn = VCNInference("VCN_VC", load_vcn_checkpoint(path, "VCN_VC"), device=dev)
        trained = state.model.state_dict()
        loaded = vcn.model.state_dict()
        if set(loaded) != set(trained) or not all(torch.equal(loaded[k], trained[k])
                                                  for k in trained):
            raise AssertionError("the reloaded VCN differs from the trained one")
        chain = vcn(dev_batches[0]["input"])
        if not torch.equal(chain[1], tr.eval_step(state, dev_batches[0])["coarse"]):
            raise AssertionError("VCNInference's completion differs from the trained net's")

    summary = {
        "views": len(ds), "data_gen_s": gen_s, "batch_load_ms": load_ms,
        "step_ms": step_ms, "samples_per_s": 32e3 / step_ms, "step_ms_all": times,
        "split_ms": split, "fps_ms": fps_ms, "fps_host_ms": statistics.median(fps_host),
        "device_busy_ms": busy, "top_ops": top, "peak_gib": peak,
        "losses": [m["loss"] for m in values], "last_terms": values[-1],
        "val": shown, "val_s": val_s, "tiny_vs_cpu": tiny, "fps_flips": flips,
        "metrics_vs_cpu": dict(zip(("f64_max_diff", "f32_max_diff", "f32_keys_off"),
                                   metrics_err))}
    print(f"VCN_VC train steps (num_coarse 1024, batch 32, 1024 + 2048 points, the "
          f"recipe's losses and Adam): losses "
          + ", ".join(f"{v:.4f}" for v in summary["losses"]) + "; last terms "
          + ", ".join(f"{k} {v:.4f}" for k, v in values[-1].items()))
    print(f"VCN train step {step_ms:.2f} ms (host clock to a synchronize, median of "
          f"{steps}) = {summary['samples_per_s']:.1f} samples/s; CUDA events: forward "
          f"{split['forward']:.2f} ms, loss {split['loss']:.2f} ms (fps alone "
          f"{fps_ms:.2f} ms in CUDA events, {summary['fps_host_ms']:.2f} ms host clock), "
          f"backward + update {split['backward_update']:.2f} ms; peak device memory "
          f"{peak:.2f} GiB; profiled step: device busy {busy:.2f} ms; device time by "
          f"op: " + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + f" on {card}")
    print(f"VCN validation over {len(val_ds)} views in {val_s:.2f} s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in shown.items())
          + "; ckpt-last.pth reloaded into VCNInference bit for bit, its completion "
          "equal to the trained net's")
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    print(smi)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()

    # --- 1. build every kernel, one nvcc per source, all at once ----------
    t0 = time.time()
    logs = K.build(K.KERNELS)
    print(f"build: {time.time() - t0:.1f} s for {list(K.KERNELS)}")
    usage = ptxas_usage("\n".join(logs.values()))
    for fn, (regs, spill) in usage.items():
        print(f"  {fn}: {regs} registers, {spill} bytes spilled")

    # --- 2. K1, K2, K3 against their plain versions at test sizes ---------
    worst = 0.0
    for name, a, b, valid, r in contract_cases(dev):
        err, swept = check_k1(a, b, valid, r)
        worst = max(worst, err)
        print(f"  K1 {name} (N={a.shape[0]}, M={b.shape[0]}, r={r}): ok, "
              f"{swept} of {a.shape[0] * b.shape[0]} pairs swept")
    print(f"K1 at test sizes: contract held, bit-equal to its plain route; "
          f"worst |kernel - plain| inside r = {worst}")
    k3_plain, k3_exact = check_dense_kernels(dev)
    print(f"K2 at test sizes: bit-equal to its plain version; K3: worst |K3 - "
          f"plain| {k3_plain:.3g}, |K3 - exact difference form| {k3_exact:.3g} "
          f"(atol {GRAM_ATOL}, rtol {GRAM_RTOL})")

    # --- 3. the SEE frame at bench shapes, counted --------------------------
    scene = make_scene(0, 150_000, 32)
    s = _to(dev, scene)
    proj = torch.from_numpy(PROJ).to(dev)
    l2c = torch.from_numpy(LIDAR_TO_CAM).to(dev)
    vcn = VCNInference("VCN_VC", seeded_vcn_state_dict(0), device=dev)
    args = (s["points"], s["valid"], s["det_boxes"], s["det_masks"],
            s["det_scores"], vcn, proj, l2c, IMAGE_SIZE)
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    new_pts, new_valid, stats = F.complete_frame(*args)
    torch.cuda.synchronize()
    frame_launches = dict(K.LAUNCHES)
    see_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"SEE frame launches: {frame_launches}")
    if frame_launches["min_sqdist_pruned"] < 1:
        raise AssertionError("kernel K1 was not launched by the frame")

    p, d = scene["points"].shape[0], scene["det_boxes"].shape[0]
    if new_pts.shape != (p + d * 1024, 3) or not torch.isfinite(new_pts).all():
        raise AssertionError(f"bad output cloud {tuple(new_pts.shape)}")
    ok, sane, inst_valid = stats["ok"], stats["sane"], stats["inst_valid"]
    n_inst = int(inst_valid.sum())
    dropped = int((s["valid"] & ~new_valid[:p]).sum())
    print(f"frame: {int(ok.sum())}/{d} isolated, {int(sane.sum())}/{d} sane, "
          f"{n_inst} completions spliced, {dropped} scan points dropped")
    if n_inst < 1 or dropped < 1:
        raise AssertionError("the frame did no real work")

    # replacement held against the plain full-cloud sweep, no compaction
    completed = stats["completed"]
    flat = completed.reshape(-1, 3)
    flat_valid = inst_valid.repeat_interleave(completed.shape[1])
    cand = DP.replacement_candidates(s["points"], s["valid"], completed,
                                     inst_valid, RADIUS, 32768)
    n_cand = int((cand >= 0).sum())
    plain_d = MD.min_sqdist_plain(s["points"], flat, flat_valid)
    expect = s["valid"] & ~(plain_d <= RADIUS * RADIUS)
    tie = (plain_d - RADIUS * RADIUS).abs() <= 1e-5 * RADIUS * RADIUS
    mismatch = (expect != new_valid[:p]) & ~tie
    print(f"replacement vs plain full sweep: {int(mismatch.sum())} mismatches, "
          f"{int(tie.sum())} points within 1e-5 r^2 of r^2, "
          f"{n_cand} candidates of cap 32768")
    if mismatch.any():
        raise AssertionError("replacement disagrees with the plain sweep")

    check_small_frame_against_cpu(dev)

    # --- 4. K1 at the frame's own replacement inputs: check and time ------
    # the frame's candidates, padding rows at 1e9 (device_pipeline.py)
    sub = torch.where((cand >= 0)[:, None], s["points"][cand.clamp_min(0)],
                      MD.FAR).contiguous()
    max_err, swept = check_k1(sub, flat, flat_valid, RADIUS)
    n_q, n_s = sub.shape[0], flat.shape[0]
    tiles = MD.support_tile_boxes(flat, flat_valid)
    live = int((MD.query_keys(sub, tiles, RADIUS) < tiles.shape[0]).sum())
    needed = MD.pairs_near_boxes(sub, flat, flat_valid, RADIUS, BOUND_GROUP)

    def k1_call():
        return MD.min_sqdist(sub, flat, flat_valid, prune_radius=RADIUS)

    k_ms = time_cuda(k1_call)
    dev_us = device_us_by_kernel(k1_call)
    host_us = host_enqueue_us(k1_call)
    k1_steady = sustained(k1_call)[:2]
    plain_ms = time_cuda(lambda: MD.min_sqdist_plain(sub, flat, flat_valid),
                         reps=5)
    b_far = torch.where(flat_valid[:, None], flat, MD.FAR)
    lib_ms = time_cuda(lambda: torch.cdist(sub, b_far).amin(1).square(), reps=5)
    flop_ms = 9 * needed / FP32_FLOPS * 1e3
    byte_ms = (n_q * 12 + n_s * 12 + n_s + n_q * 4) / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = max((flop_ms, "operations"), (byte_ms, "bytes"))
    print(f"K1 at the frame's inputs N={n_q} ({live} rows with a key) M={n_s} "
          f"r={RADIUS}: max |err| inside r {max_err}, bit-equal to its plain "
          f"route; pairs swept {swept} of {n_q * n_s}; pairs needed "
          f"({BOUND_GROUP}-row groups) {needed}; bound {bound_ms:.6f} ms "
          f"({bound_by}); call {k_ms:.4f} ms (CUDA events, median of 11), "
          f"{k1_steady[0]:.4f} ms a call back to back for 1 s (median SM clock "
          f"{k1_steady[1]:.0f} MHz), plain {plain_ms:.3f} ms, cdist+amin "
          f"{lib_ms:.3f} ms on {card}")
    print(f"K1's call: host enqueue {host_us:.1f} µs; device µs by launch "
          f"(torch.profiler): " + ", ".join(f"{k} {v:.2f}" for k, v in dev_us.items()))
    kernels = [kernel_entry("min_sqdist_pruned", 52,
                            frame_launches["min_sqdist_pruned"], max_err, k_ms,
                            plain_ms, bound_ms, bound_by, lib_ms, k1_steady,
                            usage_of(usage, "k1_sweep"))]

    # --- 5. K2 and K3 through min_sqdist at the replacement stage's scan:
    # the whole scan (N = 150,000) against the 32 x 1024 completed points
    scan = s["points"]
    K.reset_launches()
    k2 = MD.min_sqdist(scan, flat, flat_valid, form="diff")
    k3 = MD.min_sqdist(scan, flat, flat_valid, form="gram")
    torch.cuda.synchronize()
    dense_launches = dict(K.LAUNCHES)
    print(f"min_sqdist(form=diff / gram) launches: {dense_launches}")
    for name in ("min_sqdist_diff", "min_sqdist_gram"):
        if dense_launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched")
    k2_plain = MD.min_sqdist_plain(scan, MD.push_invalid(flat, flat_valid))
    k3_plain = MD.min_sqdist_gram_plain(scan, flat, flat_valid)
    k2_err = (k2 - k2_plain).abs().max().item()
    if k2_err:
        raise AssertionError(f"K2 off its plain version by {k2_err}")
    k3_err = gram_err(k3, k3_plain)
    k3_vs_exact = gram_err(k3, k2)          # K2 is the exact difference form
    if not torch.equal(k2 <= RADIUS * RADIUS, plain_d <= RADIUS * RADIUS):
        raise AssertionError("K2's within-radius set differs from the frame's")
    n_q, n_s = scan.shape[0], flat.shape[0]
    byte_ms = (n_q * 12 + n_s * 12 + n_s + n_q * 4) / HBM_BYTES_PER_S * 1e3
    b_far = MD.push_invalid(flat, flat_valid)
    # operations a pair, an FMA counted as two as the peak counts it: K2 3
    # sub, 3 mul, 2 add, 1 min; K3 -2a.b + |b|^2 (3 mul, 3 add, or 3 FMA)
    # and 1 min, with |a|^2 and the clamp once per row after the min
    for name, line, ops, fn, plain_fn, mode, err in (
            ("min_sqdist_diff", 31, 9, lambda: MD.min_sqdist(
                scan, flat, flat_valid, form="diff"),
             lambda: MD.min_sqdist_plain(scan, b_far),
             "donot_use_mm_for_euclid_dist", k2_err),
            ("min_sqdist_gram", 88, 7, lambda: MD.min_sqdist(
                scan, flat, flat_valid, form="gram"),
             lambda: MD.min_sqdist_gram_plain(scan, flat, flat_valid),
             "use_mm_for_euclid_dist", k3_err)):
        k_ms = time_cuda(fn, reps=5)
        plain_ms = time_cuda(plain_fn, reps=3, warmup=1)
        lib_ms = time_cuda(lambda: torch.cdist(scan, b_far, compute_mode=mode)
                           .amin(1).square(), reps=3, warmup=1)
        flop_ms = ops * n_q * n_s / FP32_FLOPS * 1e3
        bound_ms, bound_by = max((flop_ms, "operations"), (byte_ms, "bytes"))
        run_ms, mhz, watts = sustained(fn)
        print(f"{name} at N={n_q} M={n_s}: max |kernel - plain| {err}; kernel "
              f"{k_ms:.4f} ms (CUDA events, median of 5), plain {plain_ms:.3f} ms, "
              f"cdist({mode})+amin {lib_ms:.3f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}, {ops} per pair) on {card}; back to back for 1 s: "
              f"{run_ms:.4f} ms a call at a median SM clock of {mhz:.0f} MHz and "
              f"{watts:.0f} W")
        entry_fn = "k2_sweep" if name == "min_sqdist_diff" else "min_sqdist_gram_kernel"
        kernels.append(kernel_entry(name, line, dense_launches[name], err, k_ms,
                                    plain_ms, bound_ms, bound_by, lib_ms,
                                    (run_ms, mhz), usage_of(usage, entry_fn)))
    print(f"K3 at N={n_q}: max |K3 - plain| {k3_err:.3g}, max |K3 - exact "
          f"difference form| {k3_vs_exact:.3g} (atol {GRAM_ATOL}, rtol {GRAM_RTOL}); "
          f"its bound at the earlier count of 10 operations a pair (each "
          f"separately rounded step of the older form) would read "
          f"{10 * n_q * n_s / FP32_FLOPS * 1e3:.5f} ms")

    # --- 6. the detector at _flagship_detector_cfg on the frame's output --
    check_tiny_detector_against_cpu(dev)
    det_cfg = DC.flagship_detector_cfg()
    det, dcfg = build_detector(det_cfg, device="cpu")
    det, _ = build_detector(det_cfg, seeded_state_dict(0, det), device=dev)
    K.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    pp, out = F.detect_stage(det, det_cfg, new_pts, new_valid)
    torch.cuda.synchronize()
    det_launches = dict(K.LAUNCHES)
    det_peak = torch.cuda.max_memory_allocated() / 2**30
    active = [int(v) for v in out["active_voxels"]]
    n_props, n_kept = int(out["roi_mask"].sum()), int(pp["pred_mask"].sum())
    print(f"detector at the flagship config on the frame's {int(new_valid.sum())} "
          f"valid points: active voxels input / conv1 / conv2 / conv3 / conv4 / "
          f"conv_out {active} (voxel cap {dcfg.max_voxels}); {n_props} proposals, "
          f"{n_kept} boxes kept; kernel launches {det_launches}; peak device "
          f"memory {det_peak:.2f} GiB in the detector's run (the SEE frame's "
          f"{see_peak:.2f} GiB)")
    for k in ("batch_cls_preds", "batch_box_preds", "rcnn_iou"):
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"detector output {k} is not finite")
    if out["batch_box_preds"].shape != (1, 17600, 7) or n_props < 1 or n_kept < 1 \
            or active[0] < 1000:
        raise AssertionError("the detector did no real work")
    n_vox, conv_err, conv_scale = check_conv_input_dense(det, dcfg, new_pts, new_valid)
    print(f"conv_input at the flagship input ({n_vox} active voxels) vs a dense "
          f"masked conv3d: max |diff| {conv_err:.3g} of max |y| {conv_scale:.3g}")
    nms_ms = time_nms(out, dcfg, det_cfg)
    print(f"NMS: proposal pass (K={nms_ms['k']}) {nms_ms['proposal_nms']:.2f} ms, "
          f"of which the greedy scan {nms_ms['proposal_greedy_scan']:.2f} ms; "
          f"final pass {nms_ms['final_nms']:.2f} ms (CUDA events, median of 5)")

    # --- 7. Mask R-CNN at bench.py's config, then the whole fused frame ---
    check_tiny_seg2d_against_cpu(dev)
    seg_cfg = SM.Seg2DConfig(image_size=IMAGE_SIZE, max_detections=32)
    seg = build_seg2d(seg_cfg, seeded_state_dict(0, build_seg2d(seg_cfg, device="cpu")),
                      device=dev)
    # bench.py:146 and :155: the camera image is RandomState(0)'s first draw
    image = torch.from_numpy(np.random.RandomState(0).rand(
        1, *IMAGE_SIZE, 3).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    m_boxes, m_masks, m_scores = F.mask_stage(seg, image)
    torch.cuda.synchronize()
    mask_peak = torch.cuda.max_memory_allocated() / 2**30
    mask_extra = mask_peak - held / 2**30
    if m_boxes.shape != (32, 4) or m_masks.shape != (32, 28, 28) \
            or m_scores.shape != (32,):
        raise AssertionError("the mask stage did not return 32 slots")
    K.reset_launches()
    pp_f, st_f, pts_f, valid_f = F.run_frame(image, s["points"], s["valid"], seg,
                                             vcn, det, det_cfg, proj, l2c)
    torch.cuda.synchronize()
    fused_launches = dict(K.LAUNCHES)
    print(f"fused frame launches: {fused_launches}")
    if fused_launches["min_sqdist_pruned"] < 1:
        raise AssertionError("kernel K1 was not launched inside run_frame")
    if any(st_f[k].shape[0] != 32 for k in ("det_boxes", "det_masks", "det_scores")):
        raise AssertionError("the fused frame's mask stage did not return 32 slots")
    kept_f = pp_f["pred_mask"][0]
    for t in (st_f["det_boxes"], st_f["det_masks"], st_f["det_scores"],
              pp_f["pred_boxes"][0][kept_f], pp_f["pred_scores"][0][kept_f]):
        if not torch.isfinite(t).all():
            raise AssertionError("a detection of the fused frame is not finite")
    fused = {"scored": int((st_f["det_scores"] > 0).sum()),
             "isolated": int(st_f["ok"].sum()), "sane": int(st_f["sane"].sum()),
             "spliced": int(st_f["inst_valid"].sum()), "kept": int(kept_f.sum()),
             "dropped": int((s["valid"] & ~valid_f[:p]).sum()),
             "launches": fused_launches}
    print(f"fused frame (masks -> SEE frame -> detector) on a {IMAGE_SIZE[0]}x"
          f"{IMAGE_SIZE[1]} image: {fused['scored']}/32 mask-stage slots scored "
          f"above 0, {fused['isolated']}/32 isolated, {fused['sane']}/32 sane, "
          f"{fused['spliced']} completions spliced, {fused['dropped']} scan points "
          f"dropped, {fused['kept']} boxes kept by the detector; peak device "
          f"memory {mask_peak:.2f} GiB in the mask stage's run, {mask_extra:.2f} "
          f"GiB above what was held before it")
    if fused["kept"] < 1:
        raise AssertionError("the fused frame's detector returned no box")
    # the kernels line counts K1 on the main path: the fused frame
    kernels[0]["launches"] = fused_launches["min_sqdist_pruned"]
    seg_nms = time_seg2d_nms(seg, image)
    print(f"seg2d NMS: proposal pass (K={seg_nms['k'][0]}) "
          f"{seg_nms['proposal_nms']:.2f} ms, of which the greedy scan "
          f"{seg_nms['proposal_greedy_scan']:.2f} ms; detection pass "
          f"(K={seg_nms['k'][1]}) {seg_nms['detection_nms']:.2f} ms, of which the "
          f"greedy scan {seg_nms['detection_greedy_scan']:.2f} ms (CUDA events, "
          f"median of 5)")

    # --- 8. per-stage and frame times --------------------------------------
    iso, ok_ = F.isolate_stage(s["points"], s["valid"], s["det_boxes"],
                               s["det_masks"], s["det_scores"], proj, l2c,
                               IMAGE_SIZE)
    comp, sane_ = F.vcn_stage(vcn, iso)
    with torch.no_grad():
        stage_ms = {
            "masks": time_cuda(lambda: F.mask_stage(seg, image), reps=5),
            "isolation": time_cuda(lambda: F.isolate_stage(
                s["points"], s["valid"], s["det_boxes"], s["det_masks"],
                s["det_scores"], proj, l2c, IMAGE_SIZE), reps=5),
            "vcn": time_cuda(lambda: F.vcn_stage(vcn, iso), reps=5),
            "replace": time_cuda(lambda: F.replace_stage(
                s["points"], s["valid"], comp, ok_ & sane_), reps=5),
            "detector": time_cuda(lambda: F.detect_stage(
                det, det_cfg, new_pts, new_valid), reps=5),
        }

    def host_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    f_ms = host_ms(lambda: F.complete_frame(*args))
    fd_ms = host_ms(lambda: F.see_and_detect(*args[:6], proj, l2c, det, det_cfg,
                                             IMAGE_SIZE))
    ff_ms = host_ms(lambda: F.run_frame(image, s["points"], s["valid"], seg, vcn,
                                        det, det_cfg, proj, l2c))
    print("stage ms: " + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items())
          + f"; SEE frame {f_ms:.2f} ms = {1e3 / f_ms:.2f} frames/s; SEE + "
          f"detector frame {fd_ms:.2f} ms = {1e3 / fd_ms:.2f} frames/s; fused "
          f"frame (masks + SEE + detector) {ff_ms:.2f} ms = {1e3 / ff_ms:.2f} "
          f"frames/s on {card}")
    busy_ms, top = profile_frame(args)
    print(f"profiled SEE frame: device busy {busy_ms:.2f} ms of {f_ms:.2f} ms "
          f"({busy_ms / f_ms:.3f}); device time by op: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top))
    det_busy, det_top = profile_frame((det, det_cfg, new_pts, new_valid),
                                      F.detect_stage)
    print(f"profiled detector stage: device busy {det_busy:.2f} ms of "
          f"{stage_ms['detector']:.2f} ms; device time by op: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in det_top))
    mask_busy, mask_top = profile_frame((seg, image), F.mask_stage)
    print(f"profiled mask stage: device busy {mask_busy:.2f} ms of "
          f"{stage_ms['masks']:.2f} ms; device time by op: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in mask_top))

    # --- 9. source-domain training: GT completion, then train steps --------
    tiny_train = check_tiny_train_step_against_cpu(dev)
    gt_scenes = [make_scene(seed, 150_000, 32) for seed in range(4)]
    g_pts, g_valid, g_gt, g_stats, gt_launches, gt_ms = check_gt_completion(
        vcn, gt_scenes, dev)
    kernels[0]["gt_completion_launches"] = gt_launches
    train_cap = int(det_cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    conv_bwd = check_conv_backward_bf16(dcfg, g_pts, g_valid, train_cap, dev)
    sampler = check_roi_sampler_against_cpu(det_cfg, g_gt, dev)
    train = train_flagship(det_cfg, g_pts, g_valid, g_gt, dev)
    train.update(tiny_vs_cpu=tiny_train, conv_backward_bf16=conv_bwd,
                 roi_sampler_vs_cpu=sampler, gt_completion={
        "ms_per_frame": gt_ms, "launches": gt_launches,
        "isolated": int(g_stats["ok"].sum()), "sane": int(g_stats["sane"].sum()),
        "spliced": int(g_stats["inst_valid"].sum())})

    # --- 10. VCN training at full width on generated data ----------------
    vcn_train = train_vcn(dev, card)
    print(f"chip_smoke ran {time.time() - t_start:.0f} s after start-up")

    # --- 11. summary lines ---------------------------------------------------
    print(json.dumps({
        "kernels": kernels, "stage_ms": stage_ms, "frame_ms": f_ms,
        "see_detect_frame_ms": fd_ms, "fused_frame_ms": ff_ms,
        "fused_frames_per_s": 1e3 / ff_ms, "device_busy_ms": busy_ms,
        "fused_frame": fused,
        "seg2d": {"nms_ms": seg_nms, "peak_gib": mask_peak,
                  "peak_above_held_gib": mask_extra,
                  "device_busy_ms": mask_busy, "top_ops": mask_top},
        "detector": {"active_voxels": active, "proposals": n_props,
                     "kept": n_kept, "nms_ms": nms_ms,
                     "peak_gib": det_peak},
        "see_frame_peak_gib": see_peak, "train": train, "vcn_train": vcn_train,
        "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
