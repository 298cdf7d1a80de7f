"""Spinning-lidar synthetic frames with a controllable beam pattern (port of
seevcn_tpu/data/synth_da.py, numpy on the host as there).

The domain-adaptation demonstration needs frames whose whole cloud follows
a real scan pattern (rings dense in azimuth, metre gaps between beams at
range), so that a beam-count shift (a 64-beam source against a 16-beam
target, the KITTI-against-nuScenes axis that the reference's
LidarSimulation emulates, data_transforms.py:142-201) is a true domain
shift and not an artifact of ad-hoc point sampling.

One frame is procedural car meshes (the family the VCN recipe trains on,
``vc_shapenet.procedural_car_mesh``) and pole and wall structures, merged
into one scene mesh and raycast with a simulated spinning lidar
(Moller-Trumbore a ray, ``vc_shapenet.cast_rays_t``, with an analytic
ground plane z-buffered in), so cross-object occlusion is exact: a near
car shadows the far car and the ground behind both. The draws from the
given RandomState are the JAX package's, one for one, so the frames equal
its frames bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..models.vcn import vc_shapenet as VS

# HDL-64-ish vertical span (KITTI): 64 beams over [-24.8, +2] deg.
# The 16-beam target keeps the same span — a pure beam-COUNT shift.
DEFAULT_ELEV_SPAN = (-24.8, 2.0)


def lidar_ray_dirs(n_beams: int, elev_span=DEFAULT_ELEV_SPAN,
                   azim_fov=(-45.0, 45.0), azim_res_deg: float = 0.25,
                   jitter_rng=None):
    """Ray direction grid (R, 3) for a front-sector spinning lidar:
    n_beams elevation rows x (fov / res) azimuth columns."""
    elevs = np.deg2rad(np.linspace(elev_span[0], elev_span[1], n_beams))
    azims = np.deg2rad(np.arange(azim_fov[0], azim_fov[1], azim_res_deg))
    if jitter_rng is not None:
        azims = azims + jitter_rng.normal(0, np.deg2rad(azim_res_deg) * 0.1,
                                          len(azims))
    E, A = np.meshgrid(elevs, azims, indexing="ij")
    ce = np.cos(E)
    dirs = np.stack([ce * np.cos(A), ce * np.sin(A), np.sin(E)], axis=-1)
    return dirs.reshape(-1, 3)


def _place_cars(rng, n_cars, x_range=(6.0, 42.0), y_abs=14.0,
                sensor_h: float = 1.73, max_tries: int = 40):
    """Non-overlapping car placements. Returns list of dicts
    {verts, faces, gtbox (7,)} with meshes already placed in the sensor
    frame (x fwd, y left, z up, sensor at origin, ground z=-sensor_h)."""
    cars = []
    placed_bev = []
    for _ in range(n_cars):
        for _try in range(max_tries):
            x = rng.uniform(*x_range)
            y = rng.uniform(-y_abs, y_abs)
            # keep inside the azimuth fov with margin
            if abs(np.arctan2(y, x)) > np.deg2rad(38):
                continue
            if all((x - px) ** 2 + (y - py) ** 2 > 6.5 ** 2
                   for px, py in placed_bev):
                break
        else:
            continue
        verts, faces = VS.procedural_car_mesh(rng)
        dims = verts.max(0) - verts.min(0)
        L, W, H = float(dims[0]), float(dims[1]), float(dims[2])
        z = -sensor_h + H / 2
        yaw = rng.uniform(-np.pi, np.pi)
        ca, sa = np.cos(yaw), np.sin(yaw)
        rot = np.array([[ca, sa, 0], [-sa, ca, 0], [0, 0, 1.0]])
        centered = verts - (verts.max(0) + verts.min(0)) / 2
        placed = centered @ rot + [x, y, z]
        cars.append({"verts": placed, "faces": faces,
                     "gtbox": np.array([x, y, z, L, W, H, yaw], np.float32)})
        placed_bev.append((x, y))
    return cars


def _structures(rng, n_struct, sensor_h: float = 1.73):
    """Pole / wall-slab meshes at the road edges (|y| >= 6)."""
    meshes = []
    for _ in range(n_struct):
        x = rng.uniform(5.0, 40.0)
        y = rng.choice([-1.0, 1.0]) * rng.uniform(6.5, 13.0)
        if rng.random() < 0.5:
            h = rng.uniform(2.0, 5.0)
            meshes.append(VS.make_cylinder(rng.uniform(0.05, 0.2), h,
                                           (x, y, -sensor_h + h / 2)))
        else:
            # wall slab as a thin stretched "car" box substitute
            w_len = rng.uniform(2.0, 8.0)
            w_h = rng.uniform(1.5, 3.5)
            v = np.array([[dx, dy, dz] for dx in (0, w_len)
                          for dy in (0, 0.3) for dz in (0, w_h)], np.float64)
            f = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7],
                          [0, 5, 1], [0, 4, 5], [2, 3, 7], [2, 7, 6],
                          [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                         np.int64)
            meshes.append((v + [x, y, -sensor_h], f))
    return meshes


def spinning_lidar_frame(rng, n_beams: int = 64, azim_res_deg: float = 0.25,
                         n_cars=None, max_pts: int = 22000,
                         sensor_h: float = 1.73, range_noise: float = 0.012,
                         drop_p: float = 0.04, max_range: float = 70.0,
                         return_car_pts: bool = False):
    """One scan-pattern-consistent frame.

    Returns dict(points (max_pts, 3) float32 zero-padded, valid (max_pts,)
    bool, gt_boxes (n, 7) float32, n_pts int). With return_car_pts also
    per-car dicts {pts, gtbox, verts, faces} (for VC dataset generation
    from this exact distribution, so that VCN trains on what it completes).
    """
    if n_cars is None:
        n_cars = rng.randint(1, 7) if hasattr(rng, "randint") \
            else rng.integers(1, 7)
    cars = _place_cars(rng, n_cars, sensor_h=sensor_h)
    meshes = [(c["verts"], c["faces"]) for c in cars]
    meshes += _structures(rng, int(rng.randint(2, 6)) if hasattr(
        rng, "randint") else int(rng.integers(2, 6)), sensor_h=sensor_h)
    verts, faces = VS._merge_meshes(meshes)

    dirs = lidar_ray_dirs(n_beams, azim_res_deg=azim_res_deg,
                          jitter_rng=rng)
    t_mesh = VS.cast_rays_t(verts, faces, np.zeros(3), dirs,
                            max_range=max_range)
    # analytic ground plane z = -sensor_h
    dz = dirs[:, 2]
    t_ground = np.where(dz < -1e-6, -sensor_h / dz, np.inf)
    t = np.minimum(t_mesh, t_ground)
    hit = np.isfinite(t) & (t < max_range) & (t > 1.0)
    t = t + rng.normal(0, range_noise, len(t))          # range noise
    if drop_p > 0:
        hit &= rng.random(len(t)) > drop_p if hasattr(rng, "random") else \
            rng.rand(len(t)) > drop_p
    pts = (dirs[hit] * t[hit, None]).astype(np.float32)
    if len(pts) > max_pts:
        pts = pts[rng.choice(len(pts), max_pts, replace=False)]

    out_pts = np.zeros((max_pts, 3), np.float32)
    out_pts[:len(pts)] = pts
    valid = np.zeros(max_pts, bool)
    valid[:len(pts)] = True
    gt = np.stack([c["gtbox"] for c in cars]) if cars else \
        np.zeros((0, 7), np.float32)
    frame = {"points": out_pts, "valid": valid, "gt_boxes": gt,
             "n_pts": len(pts)}
    if return_car_pts:
        per_car = []
        for c in cars:
            m = VS.points_in_box7(pts, c["gtbox"])
            per_car.append({"pts": pts[m], "gtbox": c["gtbox"],
                            "verts": c["verts"], "faces": c["faces"]})
        frame["cars"] = per_car
    return frame


def generate_da_set(seed: int, n_frames: int, n_beams: int,
                    azim_res_deg: float = 0.25, max_pts: int = 22000,
                    max_gt: int = 8, progress=None):
    """A set of frames as stacked padded arrays:
    (points (N, P, 3), valid (N, P), gt_boxes (N, max_gt, 8) [cls=1 in
    col 7], gt_mask (N, max_gt))."""
    rng = np.random.RandomState(seed)
    P = max_pts
    pts = np.zeros((n_frames, P, 3), np.float32)
    val = np.zeros((n_frames, P), bool)
    gtb = np.zeros((n_frames, max_gt, 8), np.float32)
    gtm = np.zeros((n_frames, max_gt), bool)
    for i in range(n_frames):
        f = spinning_lidar_frame(rng, n_beams=n_beams,
                                 azim_res_deg=azim_res_deg, max_pts=P)
        pts[i], val[i] = f["points"], f["valid"]
        n = min(len(f["gt_boxes"]), max_gt)
        gtb[i, :n, :7] = f["gt_boxes"][:n]
        gtb[i, :n, 7] = 1.0
        gtm[i, :n] = True
        if progress and (i + 1) % 25 == 0:
            progress(i + 1, n_frames)
    return pts, val, gtb, gtm
