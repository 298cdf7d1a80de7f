"""The benchmark's one traffic generator: spinning-lidar scans ray-cast on the
device, from a pattern file (``patterns/<name>.json``: beams, columns, range,
camera) and a mix file (``<traffic>.json``: pool size, cars a frame,
completion, detections, slots).

A PyTorch rewrite of the port's ``data/synth_da.py`` ray caster that runs on
the card: cars are boxes with sizes drawn around KITTI's mean Car, walls and
poles are boxes too, and the ground is a plane ``sensor_height_m`` below the
sensor. Each ray keeps its nearest hit, so occlusion is exact. The scene
layout (a few numbers a frame) is drawn on the host from the seed; the rays,
the noise, the completed surfaces and the mask patches are drawn on the
device from a generator seeded from the same seed.

A completed frame is what SEE hands the detector: each car that 10 rays or
more hit loses the scan points within 0.1 m of its box surface and gains
1,024 points on that surface (VCN_VC's output count; the replacement radius).
Detections follow chip_smoke.py's ``make_scene``: each visible car's
projected 2D box, a 28x28 mask patch of its projected points with a 3x3
dilation, and a score in [0.6, 1.0].
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# KITTI's mean Car (l, w, h) and the spread drawn around it (assumed)
CAR_MEAN = (3.88, 1.63, 1.53)
CAR_STD = (0.43, 0.10, 0.14)
CAR_CLIP = ((3.2, 5.0), (1.4, 1.9), (1.3, 1.9))
SURFACE_PTS = 1024
REPLACE_M = 0.1
MASK = 28


def load_mix(name: str, root: Path = HERE) -> tuple[dict, dict]:
    mix = json.loads((root / f"{name}.json").read_text())
    pattern = json.loads((root / "patterns" / f"{mix['pattern']}.json").read_text())
    return mix, pattern


def device_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named use of the seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (2 ** 63))


def _place(rng, n, sizes, cfg, placed):
    """Up to n non-overlapping BEV discs; returns [(x, y, yaw, l, w, h)]."""
    out = []
    for i in range(n):
        l, w, h = sizes[i]
        for _ in range(64):
            x = rng.uniform(*cfg["x_m"])
            y = rng.uniform(-cfg["y_abs_m"], cfg["y_abs_m"])
            if math.hypot(x, y) < 4.0:
                continue
            az = cfg.get("max_azimuth_deg")
            if az is not None and abs(math.degrees(math.atan2(y, x))) > az:
                continue
            r = math.hypot(l, w) / 2
            if all(math.hypot(x - px, y - py) > r + pr + 0.3 for px, py, pr in placed):
                placed.append((x, y, r))
                out.append((x, y, rng.uniform(-math.pi, math.pi), l, w, h))
                break
    return out


def poisson_quantiles(mean: float, n: int) -> np.ndarray:
    """The Poisson(mean) counts at the quantiles (i + 0.5) / n, i < n."""
    k = np.arange(int(mean * 4 + 20))
    logp = k * np.log(mean) - mean - np.cumsum(np.log(np.maximum(k, 1)))
    cdf = np.cumsum(np.exp(logp))
    return np.searchsorted(cdf, (np.arange(n) + 0.5) / n)


def draw_layouts(seed: int, mix: dict, pattern: dict) -> list[dict]:
    """The host part: per frame its cars and structures as boxes
    (x, y, z, l, w, h, yaw), cars first. The pool's counts of cars
    (Poisson quantiles around the mix's mean) and of structures are the same
    for every seed; the seed orders them and places everything."""
    rng = np.random.default_rng(int(seed))
    ground = -float(pattern["sensor_height_m"])
    c = mix["cars"]
    pool = int(mix["pool"])
    lo, hi = mix["structures"]["count"]
    # every seed gets the same car and structure counts, in its own order
    cars_n = rng.permutation(np.clip(poisson_quantiles(c["mean"], pool), c["min"], c["max"]))
    struct_n = rng.permutation(lo + (np.arange(pool) * (hi - lo + 1)) // pool)
    frames = []
    for f in range(pool):
        n = int(cars_n[f])
        sizes = np.clip(rng.normal(CAR_MEAN, CAR_STD, (n, 3)),
                        [lo for lo, _ in CAR_CLIP], [hi for _, hi in CAR_CLIP])
        placed = []
        cars = _place(rng, n, sizes, c, placed)
        structs = []
        for _ in range(int(struct_n[f])):
            if rng.random() < 0.5:                    # a wall along the road
                l, w, h = rng.uniform(3.0, 15.0), 0.3, rng.uniform(1.5, 3.5)
            else:                                     # a pole
                l, w, h = 0.3, 0.3, rng.uniform(3.0, 6.0)
            side = {"x_m": c["x_m"], "y_abs_m": c["y_abs_m"],
                    "max_azimuth_deg": c.get("max_azimuth_deg")}
            got = _place(rng, 1, [(l, w, h)], side, placed)
            for x, y, _, l_, w_, h_ in got:
                structs.append((x, y, rng.normal(0, 0.05), l_, w_, h_))
        boxes = [(x, y, ground + h / 2, l, w, h, yaw) for x, y, yaw, l, w, h in cars + structs]
        frames.append({"boxes": np.asarray(boxes, np.float32).reshape(-1, 7),
                       "n_cars": len(cars), "phase": rng.random()})
    return frames


def ray_dirs(pattern: dict, phase: float, device) -> torch.Tensor:
    """(R, 3) unit directions: beams (uniformly spaced) x the columns of the
    cast sector, the sector rotated by ``phase`` of a column."""
    top, bottom = pattern["elevation_deg"]
    step = 360.0 / float(pattern["columns_per_turn"])
    a0, a1 = pattern["cast_azimuth_deg"]
    cols = int(round((a1 - a0) / step))
    el = torch.deg2rad(torch.linspace(top, bottom, int(pattern["beams"]), dtype=torch.float64))
    az = torch.deg2rad(a0 + (torch.arange(cols, dtype=torch.float64) + phase) * step)
    e, a = torch.meshgrid(el, az, indexing="ij")
    d = torch.stack([e.cos() * a.cos(), e.cos() * a.sin(), e.sin()], -1).reshape(-1, 3)
    return d.to(torch.float32).to(device)


def _to_local(p: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) world vectors -> (B, N, 3) in each box's frame (no shift)."""
    cs, sn = boxes[:, 6].cos()[:, None], boxes[:, 6].sin()[:, None]
    x, y = p[..., 0], p[..., 1]
    return torch.stack([x * cs + y * sn, -x * sn + y * cs,
                        p[..., 2].expand(boxes.shape[0], -1)], -1)


def cast(dirs: torch.Tensor, boxes: torch.Tensor, sensor_h: float, rng_m):
    """Nearest hit of each ray among the boxes (B, 7) and the ground plane:
    -> (t (R,), hit object id (R,): box row, or -1 for the ground or none)."""
    t = torch.where(dirs[:, 2] < -1e-6, -sensor_h / dirs[:, 2].clamp_max(-1e-6),
                    torch.full_like(dirs[:, 2], float("inf")))
    obj = torch.full_like(t, -1, dtype=torch.long)
    if boxes.shape[0]:
        half = boxes[:, None, 3:6] / 2
        o = -_to_local(boxes[:, None, :3], boxes)               # (B, 1, 3)
        d = _to_local(dirs[None], boxes)                          # (B, R, 3)
        d = torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        t1, t2 = (-half - o) / d, (half - o) / d
        t_in = torch.minimum(t1, t2).amax(-1)
        t_out = torch.maximum(t1, t2).amin(-1)
        ok = (t_in <= t_out) & (t_in > 0)
        tb = torch.where(ok, t_in, torch.full_like(t_in, float("inf")))
        tmin, arg = tb.min(0)
        near = tmin < t
        t = torch.where(near, tmin, t)
        obj = torch.where(near, arg, obj)
    hit = torch.isfinite(t) & (t > rng_m[0]) & (t < rng_m[1])
    return t, torch.where(hit, obj, torch.full_like(obj, -2))


def box_surface_dist(p: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """(N,) unsigned distance of points (N, 3) to the surface of one box (7,)."""
    q = _to_local(p - box[:3], box[None])[0].abs() - box[3:6] / 2
    outside = q.clamp_min(0).norm(dim=-1)
    inside = q.amax(-1).clamp_max(0).abs()
    return torch.where((q <= 0).all(-1), inside, outside)


def surface_points(box: torch.Tensor, n: int, gen: torch.Generator) -> torch.Tensor:
    """n points uniform by area on a box's sides and top (no bottom)."""
    l, w, h = box[3], box[4], box[5]
    area = torch.stack([w * h, w * h, l * h, l * h, l * w])
    face = torch.multinomial(area, n, replacement=True, generator=gen)
    u = torch.rand((n, 3), generator=gen, device=box.device) - 0.5
    local = u * box[3:6]
    axis = torch.tensor([0, 0, 1, 1, 2], device=box.device)[face]
    sign = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0], device=box.device)[face]
    local = local.scatter(1, axis[:, None], (sign * box[3:6][axis] / 2)[:, None])
    cs, sn = box[6].cos(), box[6].sin()
    x = local[:, 0] * cs - local[:, 1] * sn
    y = local[:, 0] * sn + local[:, 1] * cs
    return torch.stack([x, y, local[:, 2]], -1) + box[:3]


def camera(pattern: dict, device):
    """(proj (3, 4), lidar_to_cam (3, 3), image_size) in the SEE frame's
    form: the camera frame is lidar_to_cam @ p and proj folds the
    translation of Tr_velo_to_cam and R0_rect into its last column."""
    cam = pattern["camera"]
    p2 = torch.tensor(cam["P2"], dtype=torch.float64)
    r0 = torch.tensor(cam["R0_rect"], dtype=torch.float64)
    v2c = torch.tensor(cam["Tr_velo_to_cam"], dtype=torch.float64)
    l2c = r0 @ v2c[:, :3]
    proj = torch.cat([p2[:, :3], (p2[:, :3] @ (r0 @ v2c[:, 3]) + p2[:, 3])[:, None]], 1)
    return (proj.to(torch.float32).to(device), l2c.to(torch.float32).to(device),
            tuple(cam["image_size"]))


def _project(p, proj, l2c):
    uvw = (p @ l2c.T) @ proj[:, :3].T + proj[:, 3]
    depth = uvw[:, 2]
    return uvw[:, 0] / depth.clamp_min(1e-6), uvw[:, 1] / depth.clamp_min(1e-6), depth


def _detection(pts, box, proj, l2c, image_size, gen):
    """make_scene's detection of one car: (2D box xyxy (4,), mask (28, 28))."""
    h, w = image_size
    corners = torch.tensor([[sx, sy, sz] for sx in (-.5, .5) for sy in (-.5, .5)
                            for sz in (-.5, .5)], device=box.device) * box[3:6]
    cs, sn = box[6].cos(), box[6].sin()
    cw = torch.stack([corners[:, 0] * cs - corners[:, 1] * sn,
                      corners[:, 0] * sn + corners[:, 1] * cs, corners[:, 2]], -1) + box[:3]
    u, v, _ = _project(cw, proj, l2c)
    b = torch.stack([u.min().clamp_min(0), v.min().clamp_min(0),
                     u.max().clamp_max(w - 1), v.max().clamp_max(h - 1)])
    su, sv, _ = _project(pts, proj, l2c)
    mi = ((sv - b[1]) / (b[3] - b[1]).clamp_min(1e-3) * MASK).long().clamp(0, MASK - 1)
    mj = ((su - b[0]) / (b[2] - b[0]).clamp_min(1e-3) * MASK).long().clamp(0, MASK - 1)
    occ = torch.zeros((MASK, MASK), device=box.device)
    occ[mi, mj] = 1.0
    grown = torch.nn.functional.max_pool2d(occ[None, None], 3, 1, 1)[0, 0] > 0
    noise = torch.rand((MASK, MASK), generator=gen, device=box.device) * 0.1 - 0.05
    return b, torch.where(grown, 0.9, 0.1) + noise


def make_pool(traffic: str, seed: int, point_cloud_range, device, root: Path = HERE) -> dict:
    """The traffic's pool of frames on ``device``: points (F, P, 3), valid
    (F, P), gt_boxes (F, G, 8) (label 1, zero rows padding), gt_mask (F, G);
    with detections also det_boxes (F, 32, 4), det_masks (F, 32, 28, 28),
    det_scores (F, 32) (padding rows score 0, mask 0) and the camera
    (proj, lidar_to_cam, image_size); and counts (points, cars, completed
    cars, detections, truncated points) a frame."""
    mix, pattern = load_mix(traffic, root)
    if mix["detections"] and (mix["complete"] or not pattern.get("camera")):
        raise ValueError("detections are drawn on raw scans with a camera")
    layouts = draw_layouts(seed, mix, pattern)
    gen = device_generator(seed, 1, device)
    pcr = torch.tensor(point_cloud_range, dtype=torch.float32, device=device)
    sensor_h = float(pattern["sensor_height_m"])
    cap, slots = int(mix["capacity"]), int(mix["gt_slots"])
    cam = camera(pattern, device) if pattern.get("camera") else None
    nf = len(layouts)
    # an annotator's slack around each car: sides and top grown by it, the
    # bottom kept on the ground
    gm = float(mix.get("gt_margin_m", 0.0))
    margin = torch.tensor([0, 0, gm / 2, 2 * gm, 2 * gm, gm, 0], device=device)
    out = {"points": torch.zeros((nf, cap, 3), device=device),
           "valid": torch.zeros((nf, cap), dtype=torch.bool, device=device),
           "gt_boxes": torch.zeros((nf, slots, 8), device=device),
           "gt_mask": torch.zeros((nf, slots), dtype=torch.bool, device=device)}
    if mix["detections"]:
        out.update(det_boxes=torch.zeros((nf, 32, 4), device=device),
                   det_masks=torch.zeros((nf, 32, MASK, MASK), device=device),
                   det_scores=torch.zeros((nf, 32), device=device))
    counts = {k: [] for k in ("points", "cars", "completed", "detections", "truncated")}
    for f, lay in enumerate(layouts):
        boxes = torch.from_numpy(lay["boxes"]).to(device)
        nc = lay["n_cars"]
        dirs = ray_dirs(pattern, lay["phase"], device)
        t, obj = cast(dirs, boxes, sensor_h, pattern["range_m"])
        t = t + torch.randn(t.shape, generator=gen, device=device) * float(pattern["range_noise_m"])
        keep = obj > -2
        pts, obj = dirs[keep] * t[keep, None], obj[keep]
        inr = ((pts >= pcr[:3]) & (pts <= pcr[3:])).all(-1)
        if cam is not None:
            u, v, depth = _project(pts, cam[0], cam[1])
            hh, ww = cam[2]
            inr &= (depth > 0) & (u >= 0) & (u < ww) & (v >= 0) & (v < hh)
        pts, obj = pts[inr], obj[inr]
        hits = torch.bincount(obj[(obj >= 0) & (obj < nc)], minlength=nc)
        seen = hits >= int(mix["min_car_hits"])
        extra = []
        if mix["complete"]:
            drop = torch.zeros(pts.shape[0], dtype=torch.bool, device=device)
            for i in torch.nonzero(seen).flatten().tolist():
                drop |= box_surface_dist(pts, boxes[i]) <= REPLACE_M
                extra.append(surface_points(boxes[i], SURFACE_PTS, gen))
            pts = pts[~drop]
        if extra:
            pts = torch.cat([pts, *extra])
        n = min(pts.shape[0], cap)
        out["points"][f, :n] = pts[:n]
        out["valid"][f, :n] = True
        ng = min(nc, slots)
        out["gt_boxes"][f, :ng, :7] = boxes[:ng] + margin
        out["gt_boxes"][f, :ng, 7] = 1.0
        out["gt_mask"][f, :ng] = True
        nd = 0
        if mix["detections"]:
            for i in torch.nonzero(seen).flatten().tolist()[:32]:
                b, m = _detection(pts[:n][obj[:n] == i], boxes[i], cam[0], cam[1],
                                  cam[2], gen)
                out["det_boxes"][f, nd], out["det_masks"][f, nd] = b, m
                out["det_scores"][f, nd] = 0.6 + 0.4 * torch.rand((), generator=gen, device=device)
                nd += 1
        for k, v in (("points", n), ("cars", nc), ("completed", len(extra)),
                     ("detections", nd), ("truncated", pts.shape[0] - n)):
            counts[k].append(int(v))
    if cam is not None:
        out["camera"] = cam
    out["counts"] = counts
    return out
