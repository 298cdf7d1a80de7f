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
timings.
Every failed check raises, so the exit code is not 0. The last line of
standard output is one JSON object naming the device; the line before it
holds the kernel summary.

It needs one CUDA card and nvcc; it imports nothing of JAX or seevcn_tpu.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from seevcn_torch.models.detectors import configs as DC
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.models.seg2d import maskrcnn as SM
from seevcn_torch.models.seg2d.backend import build_seg2d
from seevcn_torch.geom.boxes import boxes_iou_normal
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.models.vcn.nets import build_vcn
from seevcn_torch.ops import cuda as K
from seevcn_torch.ops import nms as NMS
from seevcn_torch.ops import sparse as SP
from seevcn_torch.ops.clustering import largest_cluster_batch
from seevcn_torch.ops.cuda import min_dist as MD
from seevcn_torch.ops.iou3d import boxes_iou_bev
from seevcn_torch.ops.nms import nms_bev
from seevcn_torch.ops.sampling import partial_mesh_batch
from seevcn_torch.ops.voxelize import voxelize_batch
from seevcn_torch.see import device_pipeline as DP
from seevcn_torch.see import frame as F
from seevcn_torch.testing import K2_CARD_EDGES, k2_edge_case, tiny_seg2d_cfg

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
    the car's projection, and a score. Returns numpy arrays."""
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
            "det_scores": rng.uniform(0.6, 1.0, n_cars).astype(np.float32)}


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
    print(f"chip_smoke ran {time.time() - t_start:.0f} s after start-up")

    # --- 9. summary lines ----------------------------------------------------
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
        "see_frame_peak_gib": see_peak,
        "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
