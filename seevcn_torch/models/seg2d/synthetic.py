"""Procedural synthetic driving scenes for seg2d training (the port's own
copy of seevcn_tpu/models/seg2d/synthetic.py).

The Mask R-CNN recipe trains from scratch on generated scenes: shaded car
silhouettes (body + cabin + wheels) over textured road and sky
backgrounds, with distractor shapes and occlusion. numpy on the host; the
same ``RandomState`` gives the same arrays as the JAX package's generator.
``synth_scene`` returns (image, boxes, labels, valid, masks) as the train
step takes them, the image normalised as the backend normalises camera
images; ``synth_frame3d`` is a camera image and a lidar cloud that agree
geometrically (cars placed by projecting 3D boxes, points raycast from
procedural car meshes).
"""
from __future__ import annotations

import numpy as np

from ..vcn import vc_shapenet as VS
from .backend import IMAGENET_MEAN, IMAGENET_STD


def _ellipse_mask(h, w, cx, cy, rx, ry):
    ys, xs = np.mgrid[0:h, 0:w]
    return ((xs - cx) / max(rx, 1e-3)) ** 2 + ((ys - cy) / max(ry, 1e-3)) ** 2 <= 1.0


def _rounded_box_mask(h, w, x1, y1, x2, y2, r=0.0):
    ys, xs = np.mgrid[0:h, 0:w]
    inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return inside


def draw_car(h, w, rng, scale=1.0, flip=False, x0=None, y0=None, cw=None):
    """Car silhouette mask (h, w) + base color. Body box + trapezoid cabin +
    two wheel ellipses, optionally mirrored. Placement (x0, y0) and pixel
    width cw are randomized unless given (the 3D-consistent frame
    generator pins them to a projected 3D pose)."""
    if cw is None:
        cw = int(rng.uniform(34, 60) * scale)      # car width (px)
    ch = int(cw * rng.uniform(0.35, 0.5))          # body height
    cabin_h = int(ch * rng.uniform(0.6, 0.9))
    wheel_r = max(int(ch * rng.uniform(0.28, 0.38)), 2)

    total_h = ch + cabin_h + wheel_r
    if x0 is None:
        x0 = rng.randint(0, max(w - cw - 1, 1))
    if y0 is None:
        y0 = rng.randint(int(h * 0.35),
                         max(int(h - total_h - 1), int(h * 0.35) + 1))
    x0 = int(np.clip(x0, 0, max(w - 4, 1)))
    y0 = int(np.clip(y0, 0, max(h - 4, 1)))

    mask = np.zeros((h, w), bool)
    # body
    bx1, by1 = x0, y0 + cabin_h
    bx2, by2 = min(x0 + cw, w), min(y0 + cabin_h + ch, h)
    mask |= _rounded_box_mask(h, w, bx1, by1, bx2, by2)
    # cabin (narrower box, offset toward the rear)
    coff = int(cw * (0.12 if not flip else 0.28))
    cx1 = x0 + coff
    cx2 = min(cx1 + int(cw * 0.55), w)
    mask |= _rounded_box_mask(h, w, cx1, y0, cx2, y0 + cabin_h + 2)
    # wheels
    wy = min(by2, h - 1)
    for fx in (0.22, 0.78):
        wx = x0 + int(cw * fx)
        mask |= _ellipse_mask(h, w, wx, wy, wheel_r, wheel_r)
    color = rng.uniform(0.15, 0.95, 3)
    return mask, color


def draw_distractor(h, w, rng):
    """Non-car shape: pole, sign (triangle/circle), or building block."""
    kind = rng.randint(3)
    mask = np.zeros((h, w), bool)
    if kind == 0:      # pole
        x = rng.randint(2, w - 4)
        pw = rng.randint(2, 5)
        mask[rng.randint(0, h // 3):, x:x + pw] = True
    elif kind == 1:    # circular sign on a pole
        cx, cy = rng.randint(8, w - 8), rng.randint(8, h // 2)
        r = rng.randint(4, 9)
        mask |= _ellipse_mask(h, w, cx, cy, r, r)
        mask[cy:, cx - 1:cx + 1] = True
    else:              # building block
        x1, y1 = rng.randint(0, w - 20), 0
        bw, bh = rng.randint(16, 48), rng.randint(h // 4, int(h * 0.55))
        mask[y1:y1 + bh, x1:x1 + bw] = True
    color = rng.uniform(0.1, 0.9, 3)
    return mask, color


def synth_scene(h, w, rng, max_gt=8, n_cars=None, min_pixels=24,
                hard=False):
    """One scene. Returns (img (h, w, 3) float32 ~N(0,1) scale, boxes
    (max_gt, 4) xyxy, labels (max_gt,), valid (max_gt,), masks
    (max_gt, h, w)).

    ``hard=True`` is the far-instance/occlusion regime HTC's ~1400 px
    inputs exist for (kitti_masks.sh:10-11): log-uniform scales down to
    0.22 (cars ~8-13 px wide — distant KITTI cars at this resolution),
    perspective placement (small cars sit near the horizon), more cars
    drawn far-to-near so near cars occlude far ones, and more
    distractors. min_pixels drops to 12 so far instances stay annotated.
    """
    # background: sky gradient + road + noise texture
    sky = rng.uniform(0.5, 0.9, 3)
    road = rng.uniform(0.2, 0.45)
    horizon = int(h * rng.uniform(0.35, 0.55))
    img = np.empty((h, w, 3), np.float32)
    t = (np.arange(h) / h)[:, None, None]
    img[:] = sky * (1 - 0.4 * t)
    img[horizon:] = road + rng.uniform(-0.03, 0.03)
    img += rng.normal(0, 0.03, (h, w, 3))
    # lane line
    if rng.rand() < 0.7:
        lx = rng.randint(w // 4, 3 * w // 4)
        img[horizon + 2:, lx:lx + 2] = 0.9

    # distractors (background class — drawn but not annotated)
    for _ in range(rng.randint(2, 7) if hard else rng.randint(0, 4)):
        m, c = draw_distractor(h, w, rng)
        shade = rng.uniform(0.85, 1.15)
        img[m] = c * shade

    if hard:
        min_pixels = min(min_pixels, 12)
    n = (rng.randint(2, max_gt + 1) if hard else rng.randint(1, max_gt)) \
        if n_cars is None else n_cars
    boxes = np.zeros((max_gt, 4), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    masks = np.zeros((max_gt, h, w), np.float32)

    if hard:
        # far-to-near: sorted ascending scale so later (nearer, larger)
        # cars occlude earlier (farther) ones, like the 3D generator
        scales = np.sort(np.exp(rng.uniform(np.log(0.22), np.log(1.8), n)))
    drawn = []
    for ci in range(n):
        if hard:
            scale = float(scales[ci])
            # perspective: small (far) cars sit near the horizon, large
            # (near) ones low in the image
            t_near = (np.log(scale) - np.log(0.22)) / (np.log(1.8) -
                                                       np.log(0.22))
            # cars sit on the road: far (t_near=0) hug the horizon, near
            # (t_near=1) sit low in the frame, with a little jitter
            y_c = horizon + t_near * (int(h * 0.85) - horizon)
            jit = max(int(h * 0.03), 1)
            y0 = int(np.clip(y_c + rng.randint(-jit, jit + 1),
                             horizon - 2, h - 8))
            m, c = draw_car(h, w, rng, scale=scale, flip=rng.rand() < 0.5,
                            y0=y0)
        else:
            scale = rng.uniform(0.6, 1.8)
            m, c = draw_car(h, w, rng, scale=scale, flip=rng.rand() < 0.5)
        # shading: vertical gradient + highlight
        shade = 1.0 - 0.3 * (np.arange(h) / h)[:, None]
        for ch_i in range(3):
            img[..., ch_i] = np.where(m, c[ch_i] * shade, img[..., ch_i])
        # windows darker
        drawn.append(m)

    # later cars occlude earlier ones; recompute visible masks
    k = 0
    for i, m in enumerate(drawn):
        vis = m.copy()
        for mj in drawn[i + 1:]:
            vis &= ~mj
        if vis.sum() < min_pixels or k >= max_gt:
            continue
        ys, xs = np.nonzero(vis)
        boxes[k] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        labels[k] = 0                        # single foreground class: car
        valid[k] = True
        masks[k] = vis.astype(np.float32)
        k += 1

    img = np.clip(img, 0, 1)
    # normalised as the backend normalises camera images
    img = (img - IMAGENET_MEAN) / IMAGENET_STD
    return img.astype(np.float32), boxes, labels, valid, masks


def scene_to_bgr(img_norm: np.ndarray) -> np.ndarray:
    """Invert the normalization -> uint8 BGR (what generate_masks feeds the
    backend), for tests that drive the full mask-generation interface."""
    rgb = np.clip(img_norm * IMAGENET_STD + IMAGENET_MEAN, 0, 1)
    return (rgb[..., ::-1] * 255).astype(np.uint8)


def synth_batch(rng, image_size, batch, max_gt=8, hard=False):
    """Batch of scenes, stacked. numpy outputs (caller moves to device)."""
    h, w = image_size
    out = [synth_scene(h, w, rng, max_gt=max_gt, hard=hard)
           for _ in range(batch)]
    return tuple(np.stack(x) for x in zip(*out))


def synth_frame3d(h, w, rng, n_cars=2, n_bg=3000, car_pts=350):
    """3D-consistent synthetic frame: a camera image whose cars sit at the
    PROJECTED location/scale of 3D car boxes, plus a lidar cloud sampled
    from those boxes over a road background.

    Purpose: measure the DET-path (trained seg2d masks) against the
    GT-path (hull masks) through the same SEE pipeline — the reference's
    config-1 vs config-2 comparison (see/SEE_VCN.py GT vs DET isolation)
    needs frames where image and cloud agree geometrically.

    KITTI-ish conventions: lidar x forward / y left / z up; camera
    u = cx - f*y/x, v = cy - f*z/x (rect cam, lidar_to_cam
    [[0,-1,0],[0,0,-1],[1,0,0]]).

    Returns (img_norm (h, w, 3), pts (P, 3), gt_boxes (n_cars, 7),
    calib dict(P2 (3, 4), lidar_to_cam (3, 3)), vis_masks
    (n_cars, h, w) bool).
    """
    f = 0.62 * w
    cx, cy = w / 2.0, 0.42 * h
    P2 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]], np.float32)
    l2c = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float32)

    img = np.empty((h, w, 3), np.float32)
    sky = rng.uniform(0.5, 0.9, 3)
    road = rng.uniform(0.2, 0.45)
    horizon = int(cy)
    t = (np.arange(h) / h)[:, None, None]
    img[:] = sky * (1 - 0.4 * t)
    img[horizon:] = road + rng.uniform(-0.03, 0.03)
    img += rng.normal(0, 0.03, (h, w, 3))

    # 3D cars, far to near so nearer cars occlude in both image and
    # order. Car points come from RAYCASTING procedural car meshes (the
    # same family the VCN recipe trains on) from the sensor origin —
    # one-sided occlusion-aware views like real lidar, not box shells.
    depths = np.sort(rng.uniform(9.0, 30.0, n_cars))[::-1]
    gt_boxes = np.zeros((n_cars, 7), np.float32)
    drawn = []
    placed_meshes = []
    for i, d in enumerate(depths):
        y = rng.uniform(-0.25, 0.25) * d * (w / (2 * f))  # keep in frame
        verts, faces = VS.procedural_car_mesh(rng)
        dims = verts.max(0) - verts.min(0)
        L, W, H = float(dims[0]), float(dims[1]), float(dims[2])
        z = -1.75 + H / 2                 # wheels on the road plane
        yaw = rng.uniform(-0.4, 0.4) + (0.0 if rng.rand() < 0.5 else np.pi)
        gt_boxes[i] = [d, y, z, L, W, H, yaw]
        # projected footprint: center (u, v), pixel width ~ f*L/d
        u = cx - f * y / d
        v = cy - f * z / d
        cw = max(int(f * L / d), 10)
        car_h_px = int(cw * 0.62)            # body+cabin+wheels approx
        m, c = draw_car(h, w, rng, flip=rng.rand() < 0.5,
                        x0=int(u - cw / 2), y0=int(v - car_h_px * 0.78),
                        cw=cw)
        shade = 1.0 - 0.3 * (np.arange(h) / h)[:, None]
        for ch_i in range(3):
            img[..., ch_i] = np.where(m, c[ch_i] * shade, img[..., ch_i])
        drawn.append(m)
        ca, sa = np.cos(yaw), np.sin(yaw)
        rot = np.array([[ca, sa, 0], [-sa, ca, 0], [0, 0, 1.0]])
        centered = verts - (verts.max(0) + verts.min(0)) / 2
        placed_meshes.append((centered @ rot + [d, y, z], faces))

    # cast each car's ray bundle against the merged scene mesh, so that a
    # near car shadows the far car's points as it shadows its pixels
    scene_verts, scene_faces = VS._merge_meshes(placed_meshes)
    pts_car = []
    for i, d in enumerate(depths):
        ray = VS.cast_rays_at_point(scene_verts, scene_faces,
                                    gt_boxes[i, :3].astype(np.float64),
                                    fov_deg=min(60.0, 1200.0 / d),
                                    height_px=90)
        # keep only hits on THIS car (merged-cast hits include other cars)
        if len(ray):
            ray = ray[VS.points_in_box7(ray, gt_boxes[i])]
        if len(ray) > car_pts:
            ray = ray[rng.choice(len(ray), car_pts, replace=False)]
        pts_car.append(ray.reshape(-1, 3).astype(np.float32))

    # visible masks (later/nearer cars occlude earlier/farther)
    vis_masks = np.zeros((n_cars, h, w), bool)
    for i, m in enumerate(drawn):
        vis = m.copy()
        for mj in drawn[i + 1:]:
            vis &= ~mj
        vis_masks[i] = vis

    # background: road plane + a few pole/wall structures at the road
    # EDGES (|y| >= 6) — uniform mid-air clutter would put dense point
    # walls inside every mask frustum and DBSCAN's largest cluster
    # would pick the clutter over the car, which real scenes don't do
    # road as lidar RINGS (beam elevations -1.5..-15 deg, sensor 1.75 m
    # above ground): dense along a ring, metre-scale gaps between rings
    # at range — uniform-density ground would form one connected strip
    # through every mask frustum and win the largest-cluster pick
    ring_pts = []
    for elev in np.linspace(1.5, 15.0, 14):
        r = 1.75 / np.tan(np.deg2rad(elev))
        if r > 48:
            continue
        az = np.arange(-0.6, 0.6, np.deg2rad(0.25) / max(r / 40, 0.2))
        az = az + rng.normal(0, 2e-3, len(az))
        ring_pts.append(np.stack([
            r * np.cos(az), r * np.sin(az),
            np.full(len(az), -1.75) + rng.normal(0, 0.02, len(az))], 1))
    road = np.concatenate(ring_pts).astype(np.float32)
    road = road[(road[:, 0] > 3) & (np.abs(road[:, 1]) < 12)]
    nroad = min(len(road), int(n_bg * 0.85))
    bg = np.empty((nroad + (n_bg - int(n_bg * 0.85)), 3), np.float32)
    bg[:nroad] = road[rng.choice(len(road), nroad, replace=False)] \
        if len(road) > nroad else road
    k = len(bg) - nroad
    n_struct = rng.randint(2, 5)
    centers = np.stack([rng.uniform(5, 40, n_struct),
                        rng.choice([-1, 1], n_struct)
                        * rng.uniform(6, 11, n_struct)], 1)
    which = rng.randint(0, n_struct, k)
    bg[nroad:, 0] = centers[which, 0] + rng.normal(0, 0.15, k)
    bg[nroad:, 1] = centers[which, 1] + rng.normal(0, 0.15, k)
    bg[nroad:, 2] = rng.uniform(-1.7, 1.5, k)
    pts = np.vstack([bg] + pts_car).astype(np.float32)

    img = np.clip(img, 0, 1)
    img = ((img - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
    return img, pts, gt_boxes, {"P2": P2, "lidar_to_cam": l2c}, vis_masks
