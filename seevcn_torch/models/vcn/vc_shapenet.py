"""VC-ShapeNet dataset generation: ray-cast partial/complete car surfaces
(the port's copy of seevcn_tpu/models/vcn/vc_shapenet.py, numpy only).

Reference: see/.../models/vcn/vc_shapenet/ (dataset_functions.py:326-462,
raycast_surface_from_meshes.py:16-85) — load ShapeNet car meshes, place them
at poses sampled from real driving frames, ray-cast from the sensor origin
to get realistic partial views, and densely sample the full surface for the
completion target.

The reference uses open3d's tensor raycasting; this is a self-contained
numpy Möller–Trumbore caster (vectorized triangles x rays in blocks), plus
an area-weighted surface sampler. Output layout matches
seevcn_torch.models.vcn.dataset.VCDataset:
  out/<model>/complete.npy, out/<model>/partial/<view>.npy,
  out/<model>/labels.pkl ({view: {'gtbox': (7,)}}).
"""
from __future__ import annotations

import os
import pickle

import numpy as np


def procedural_car_mesh(rng):
    """Car-like closed mesh (lidar frame: x forward, z up, ground z=0):
    body box + cabin box + 4 wheel boxes with varied proportions. The
    egress-free stand-in for ShapeNet cars — shared by the VCN training
    recipe (scripts/train_vcn_synthetic.py) and the 3D-consistent frame
    generator so both draw cars from the same shape family.

    Returns (verts (V, 3) float64, faces (F, 3) int)."""
    L = rng.uniform(3.6, 4.8)
    W = rng.uniform(1.6, 2.0)
    bodyH = rng.uniform(0.9, 1.2)
    cabH = rng.uniform(0.5, 0.8)
    cabL = L * rng.uniform(0.45, 0.6)
    cab0 = rng.uniform(0.05, 0.25) * L - L / 2
    wheelR = rng.uniform(0.28, 0.38)

    verts, faces = [], []

    def add_box(x0, y0, z0, x1, y1, z1):
        base = len(verts)
        for dz in (z0, z1):
            for dy in (y0, y1):
                for dx in (x0, x1):
                    verts.append((dx, dy, dz))
        quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 2, 6, 4),
                 (1, 5, 7, 3), (0, 4, 5, 1), (2, 3, 7, 6)]
        for a, b, c, d in quads:
            faces.append((base + a, base + b, base + c))
            faces.append((base + a, base + c, base + d))

    add_box(-L / 2, -W / 2, wheelR, L / 2, W / 2, wheelR + bodyH)
    add_box(cab0, -W * 0.4, wheelR + bodyH,
            cab0 + cabL, W * 0.4, wheelR + bodyH + cabH)
    for sx in (-1, 1):
        for sy in (-1, 1):
            cx = sx * L * 0.32
            cy = sy * (W / 2 - 0.1)
            add_box(cx - wheelR, cy - 0.12, 0.0,
                    cx + wheelR, cy + 0.12, 2 * wheelR)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def load_obj(path: str):
    """Minimal OBJ reader -> (vertices (V,3), faces (F,3) int)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [tok.split("/")[0] for tok in line.split()[1:]]
                idx = [int(i) for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0] - 1, idx[k] - 1, idx[k + 1] - 1])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def normalize_car_mesh(verts: np.ndarray, target_length: float = 4.2):
    """Center and scale a ShapeNet car to a realistic length; ShapeNet cars
    face +x after swapping axes (reference load_shapenet does the analog)."""
    v = verts - (verts.max(0) + verts.min(0)) / 2
    # shapenet: y up, -z forward -> lidar frame: z up, x forward
    v = np.stack([-v[:, 2], -v[:, 0], v[:, 1]], axis=1)
    scale = target_length / (v[:, 0].max() - v[:, 0].min())
    return v * scale


def transform_mesh(verts, pose):
    """pose (7,) [x y z dx dy dz heading] -> verts placed in scene (scaled
    to the box dims in x, uniform)."""
    x, y, z, dx, dy, dz, ry = pose
    s = dx / max(verts[:, 0].max() - verts[:, 0].min(), 1e-6)
    v = verts * s
    c, si = np.cos(ry), np.sin(ry)
    rot = np.array([[c, si, 0], [-si, c, 0], [0, 0, 1.0]])
    return v @ rot + np.array([x, y, z])


def raycast_mesh(verts: np.ndarray, faces: np.ndarray, origin=(0, 0, 0),
                 az_res_deg: float = 0.2, el_res_deg: float = 0.4,
                 max_range: float = 120.0, block: int = 4096):
    """Cast a lidar-like ray grid at the mesh; return hit points (N, 3).

    Ray grid spans the mesh's angular bounding box at the given azimuth /
    elevation resolution (emulating beam spacing); Möller–Trumbore over all
    triangles, nearest hit per ray.
    """
    origin = np.asarray(origin, np.float64)
    rel = verts - origin
    az = np.arctan2(rel[:, 1], rel[:, 0])
    el = np.arcsin(rel[:, 2] / np.maximum(np.linalg.norm(rel, axis=1), 1e-9))
    azs = np.arange(az.min(), az.max(), np.deg2rad(az_res_deg))
    els = np.arange(el.min(), el.max(), np.deg2rad(el_res_deg))
    if len(azs) == 0 or len(els) == 0:
        return np.zeros((0, 3), np.float32)
    A, E = np.meshgrid(azs, els)
    dirs = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A),
                     np.sin(E)], axis=-1).reshape(-1, 3)

    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0

    hits = []
    for s in range(0, len(dirs), block):
        d = dirs[s:s + block]                        # (R, 3)
        # Möller–Trumbore, (R, F) broadcast
        p = np.cross(d[:, None, :], e2[None, :, :])  # (R, F, 3)
        det = np.einsum("fk,rfk->rf", e1, p)
        inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
        t0 = origin - v0                             # (F, 3)
        u = np.einsum("fk,rfk->rf", t0, p) * inv
        q = np.cross(t0[None, :, :], e1[None, :, :])  # (1, F, 3)
        vv = np.einsum("rk,rfk->rf", d, np.broadcast_to(q, (len(d),) + q.shape[1:]))
        vv = vv * inv
        t = np.einsum("fk,rfk->rf", e2, np.broadcast_to(q, (len(d),) + q.shape[1:]))
        t = t * inv
        ok = (np.abs(det) > 1e-12) & (u >= 0) & (vv >= 0) & (u + vv <= 1) & \
            (t > 1e-6) & (t < max_range)
        t = np.where(ok, t, np.inf)
        tmin = t.min(axis=1)
        hit = np.isfinite(tmin)
        hits.append(origin + d[hit] * tmin[hit, None])
    return np.concatenate(hits).astype(np.float32) if hits else \
        np.zeros((0, 3), np.float32)


def sample_surface(verts, faces, n: int, rng=None) -> np.ndarray:
    """Area-weighted uniform surface sampling (complete target)."""
    rng = rng or np.random.default_rng(0)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = area / max(area.sum(), 1e-12)
    fi = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    pts = (1 - r1)[:, None] * v0[fi] + (r1 * (1 - r2))[:, None] * v1[fi] + \
        (r1 * r2)[:, None] * v2[fi]
    return pts.astype(np.float32)


# --------------------------------------------------------------------------- #
# scene population (reference dataset_functions.py:265-462): several cars per
# frame at poses from real driving frames, pole/sign distractors, occlusion-
# aware pinhole raycast per object
# --------------------------------------------------------------------------- #

def make_cylinder(radius: float, height: float, center, n_seg: int = 12):
    """Closed cylinder triangle mesh (verts (V,3), faces (F,3)) — the
    reference uses o3d create_cylinder for poles/signs."""
    center = np.asarray(center, np.float64)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    bot = np.concatenate([ring, np.full((n_seg, 1), -height / 2)], axis=1)
    top = np.concatenate([ring, np.full((n_seg, 1), height / 2)], axis=1)
    verts = np.concatenate([bot, top,
                            [[0, 0, -height / 2]], [[0, 0, height / 2]]])
    faces = []
    cb, ct = 2 * n_seg, 2 * n_seg + 1
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces += [[i, j, n_seg + i], [j, n_seg + j, n_seg + i],  # side quads
                  [cb, j, i], [ct, n_seg + i, n_seg + j]]        # caps
    return verts + center, np.asarray(faces, np.int64)


def _merge_meshes(meshes):
    verts, faces, off = [], [], 0
    for v, f in meshes:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(faces)


def populate_scene(scene_cars, sign_boxes=None, rng=None,
                   random_poles_pct: float = 0.3, lidar_height: float = 2.4):
    """Build the raycasting scene: placed car meshes + pole distractors next
    to a fraction of the cars + annotated signs as cylinders
    (dataset_functions.populate_scene:265-308). scene_cars: list of dicts
    {verts, faces, gtbox (7,)}. Returns merged (verts, faces)."""
    rng = rng or np.random.default_rng(0)
    meshes = [(c["verts"], c["faces"]) for c in scene_cars]
    num_poles = int(len(scene_cars) * random_poles_pct)
    for i, car in enumerate(scene_cars[:num_poles]):
        box = car["gtbox"]
        pole_r = rng.uniform(0.03, 0.2)
        pole_h = rng.uniform(1, 4)
        corners = _box_corners_bev(box)
        box_min, box_max = corners.min(0), corners.max(0)
        choice = rng.integers(1, 4)
        if rng.random() < 0.5:
            if choice == 1:
                xy = np.array([box_max[0], box[1]]) + rng.uniform(0, 0.5)
            elif choice == 2:
                xy = np.array([box[0], box_max[1]]) + rng.uniform(0, 0.5)
            else:
                xy = box_max + rng.uniform(0, 1, 2)
        else:
            xy = box_min - rng.uniform(0, 1, 2)
        centre = np.array([xy[0], xy[1], box[2] + pole_h / 2 - box[5] / 2])
        meshes.append(make_cylinder(pole_r, pole_h, centre))
    for sign in (sign_boxes if sign_boxes is not None else []):
        pole_h = rng.uniform(1, 4)
        centre = np.array([sign[0], sign[1], -lidar_height + pole_h / 2])
        meshes.append(make_cylinder(rng.uniform(0.03, 0.1), pole_h, centre))
    return _merge_meshes(meshes)


def _box_corners_bev(box):
    l, w, ry = box[3], box[4], box[6]
    base = np.array([[l / 2, w / 2], [l / 2, -w / 2],
                     [-l / 2, w / 2], [-l / 2, -w / 2]])
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, s], [-s, c]])
    return base @ rot + box[:2]


def points_in_box7(pts: np.ndarray, box) -> np.ndarray:
    """Rotated-box membership mask (numpy, host-side crop of ray hits)."""
    rel = pts - np.asarray(box[:3])
    c, s = np.cos(box[6]), np.sin(box[6])
    lx = rel[:, 0] * c + rel[:, 1] * s
    ly = -rel[:, 0] * s + rel[:, 1] * c
    return ((np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2) &
            (np.abs(rel[:, 2]) <= box[5] / 2))


def cast_rays_at_point(verts, faces, point, fov_deg: float = 100.0,
                       aspect_ratio: float = 2.0, height_px: int = 160,
                       eye=(0.0, 0.0, 0.0)):
    """Pinhole ray bundle from ``eye`` looking at ``point`` (the o3d
    create_rays_pinhole analog, dataset_functions.py:310-325), cast against
    the merged scene; returns hit points (N, 3)."""
    eye = np.asarray(eye, np.float64)
    point = np.asarray(point, np.float64)
    fwd = point - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    nr = np.linalg.norm(right)
    right = right / nr if nr > 1e-9 else np.array([1.0, 0, 0])
    cam_up = np.cross(right, fwd)

    h = int(height_px)
    w = int(aspect_ratio * height_px)
    focal = h / (2 * np.tan(np.deg2rad(fov_deg) / 2))
    us = (np.arange(w) + 0.5 - w / 2) / focal
    vs = (np.arange(h) + 0.5 - h / 2) / focal
    U, V = np.meshgrid(us, vs)
    dirs = (fwd[None, None] + U[..., None] * right[None, None]
            - V[..., None] * cam_up[None, None]).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return _cast_rays(verts, faces, eye, dirs)


def cast_rays_t(verts, faces, origin, dirs, max_range: float = 120.0,
                block: int = 4096) -> np.ndarray:
    """Möller–Trumbore nearest-hit DISTANCE per ray: -> t (R,) float64,
    np.inf where the ray misses every triangle. The spinning-lidar frame
    generator needs per-ray t to z-buffer mesh hits against the analytic
    ground plane (reference analog: o3d raycasting returns t_hit,
    dataset_functions.py raycast_object)."""
    origin = np.asarray(origin, np.float64)
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    out = np.full(len(dirs), np.inf)
    for s in range(0, len(dirs), block):
        d = dirs[s:s + block]
        p = np.cross(d[:, None, :], e2[None, :, :])
        det = np.einsum("fk,rfk->rf", e1, p)
        inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
        t0 = origin - v0
        u = np.einsum("fk,rfk->rf", t0, p) * inv
        q = np.cross(t0[None, :, :], e1[None, :, :])
        qb = np.broadcast_to(q, (len(d),) + q.shape[1:])
        vv = np.einsum("rk,rfk->rf", d, qb) * inv
        t = np.einsum("fk,rfk->rf", e2, qb) * inv
        ok = (np.abs(det) > 1e-12) & (u >= 0) & (vv >= 0) & (u + vv <= 1) & \
            (t > 1e-6) & (t < max_range)
        out[s:s + block] = np.where(ok, t, np.inf).min(axis=1)
    return out


def _cast_rays(verts, faces, origin, dirs, max_range: float = 120.0,
               block: int = 4096):
    """Möller–Trumbore nearest-hit for arbitrary ray directions."""
    v0 = verts[faces[:, 0]]
    e1 = verts[faces[:, 1]] - v0
    e2 = verts[faces[:, 2]] - v0
    hits = []
    for s in range(0, len(dirs), block):
        d = dirs[s:s + block]
        p = np.cross(d[:, None, :], e2[None, :, :])
        det = np.einsum("fk,rfk->rf", e1, p)
        inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
        t0 = origin - v0
        u = np.einsum("fk,rfk->rf", t0, p) * inv
        q = np.cross(t0[None, :, :], e1[None, :, :])
        qb = np.broadcast_to(q, (len(d),) + q.shape[1:])
        vv = np.einsum("rk,rfk->rf", d, qb) * inv
        t = np.einsum("fk,rfk->rf", e2, qb) * inv
        ok = (np.abs(det) > 1e-12) & (u >= 0) & (vv >= 0) & (u + vv <= 1) & \
            (t > 1e-6) & (t < max_range)
        t = np.where(ok, t, np.inf)
        tmin = t.min(axis=1)
        hit = np.isfinite(tmin)
        hits.append(origin + d[hit] * tmin[hit, None])
    return np.concatenate(hits).astype(np.float32) if hits else \
        np.zeros((0, 3), np.float32)


def frames_from_infos(infos, lidar_height: float = 2.4,
                      min_car_width: float = 1.5):
    """OpenPCDet-style infos -> per-frame car/sign pose lists (reference
    get_frames, dataset_functions.py:345-377): Vehicle boxes (width filter
    drops forklift arms), Sign boxes, z shifted to ground frame."""
    frames = []
    for info in infos:
        annos = info["annos"]
        names = np.asarray(annos["name"])
        boxes = np.asarray(annos["gt_boxes_lidar"], np.float64)
        cars = boxes[(names == "Vehicle") | (names == "Car")]
        if len(cars) == 0:
            continue
        cars = cars[cars[:, 4] > min_car_width]
        if len(cars) == 0:
            continue
        cars = cars.copy()
        cars[:, 2] -= lidar_height
        signs = boxes[names == "Sign"].copy()
        if len(signs):
            signs[:, 2] -= lidar_height
        frames.append({"cars": cars, "signs": signs})
    return frames


def generate_vc_dataset_scenes(mesh_paths, frames, out_dir: str,
                               nviews: int = 20, n_complete: int = 16384,
                               min_pts: int = 30, max_pts: int = 50000,
                               height_px: int = 160, rng=None, logger=print):
    """Scene-level VC-ShapeNet generation (reference generate_dataset,
    dataset_functions.py:378-462): every frame's car poses get meshes
    assigned round-robin (least-exported first), the populated scene is
    raycast once per car with a random FOV, points inside the car's box form
    the partial view; export until every model has ``nviews`` views."""
    rng = rng or np.random.default_rng(0)
    models = []
    for mi, path in enumerate(mesh_paths):
        verts, faces = load_obj(path)
        verts = normalize_car_mesh(verts)
        models.append({"id": f"model{mi:04d}", "verts": verts, "faces": faces,
                       "dims": verts.max(0) - verts.min(0)})
    exported = {m["id"]: 0 for m in models}
    labels = {m["id"]: {} for m in models}

    for frame in frames:
        if all(v >= nviews for v in exported.values()):
            break
        # least-exported models take the frame's poses
        order = sorted(models, key=lambda m: exported[m["id"]])
        scene_cars = []
        for pose, model in zip(frame["cars"], order):
            # transform_mesh scales uniformly so the mesh length fills the
            # box length; the (centered) mesh lands with its center at pose
            # xyz, so the gt box is pose xyz + uniformly scaled mesh dims
            placed = transform_mesh(model["verts"], pose)
            s = pose[3] / model["dims"][0]
            gtbox = np.array([pose[0], pose[1], pose[2], pose[3],
                              model["dims"][1] * s, model["dims"][2] * s,
                              pose[6]], np.float64)
            scene_cars.append({"verts": placed, "faces": model["faces"],
                               "gtbox": gtbox, "model": model})
        sverts, sfaces = populate_scene(
            scene_cars, frame.get("signs"), rng=rng)

        for car in scene_cars:
            model = car["model"]
            mid = model["id"]
            if exported[mid] >= nviews:
                continue
            fov = float(np.clip(rng.normal(60, 30), 20, 120))
            ray_pts = cast_rays_at_point(sverts, sfaces, car["gtbox"][:3],
                                         fov_deg=fov, height_px=height_px)
            obj_pts = ray_pts[points_in_box7(ray_pts, car["gtbox"])] \
                if len(ray_pts) else ray_pts
            if not (min_pts < len(obj_pts) < max_pts):
                continue
            view = exported[mid]
            model_dir = os.path.join(out_dir, mid)
            os.makedirs(os.path.join(model_dir, "partial"), exist_ok=True)
            os.makedirs(os.path.join(model_dir, "surface"), exist_ok=True)
            key = f"{view:03d}"
            np.save(os.path.join(model_dir, "partial", key + ".npy"), obj_pts)
            # view-frame complete surface of the placed car (see
            # generate_vc_dataset: the loss contract needs completes in
            # the view frame, reference surface/%s/%03d.pcd layout)
            np.save(os.path.join(model_dir, "surface", key + ".npy"),
                    sample_surface(car["verts"], model["faces"],
                                   n_complete, rng))
            labels[mid][key] = {
                "gtbox": car["gtbox"].astype(np.float32),
                "bbox_pts": np.concatenate(
                    [_box_corners_bev(car["gtbox"]),
                     np.zeros((4, 1))], axis=1).astype(np.float32),
                "num_pts": len(obj_pts), "raycasting": fov}
            exported[mid] += 1

    for model in models:
        mid = model["id"]
        if not labels[mid]:
            continue
        model_dir = os.path.join(out_dir, mid)
        os.makedirs(model_dir, exist_ok=True)
        complete = sample_surface(model["verts"], model["faces"], n_complete,
                                  np.random.default_rng(1))
        np.save(os.path.join(model_dir, "complete.npy"), complete)
        with open(os.path.join(model_dir, "labels.pkl"), "wb") as f:
            pickle.dump(labels[mid], f)
        logger(f"{mid}: {exported[mid]} views")
    return exported


def generate_vc_dataset(mesh_paths, poses, out_dir: str, views_per_pose: int = 1,
                        n_complete: int = 16384, min_partial_pts: int = 30,
                        rng=None, logger=print):
    """For each mesh: place at each pose, raycast a partial view from the
    origin, save partial/complete pairs + gt boxes (reference
    generate_dataset, dataset_functions.py:378-462)."""
    rng = rng or np.random.default_rng(0)
    for mi, mesh_path in enumerate(mesh_paths):
        verts, faces = load_obj(mesh_path)
        verts = normalize_car_mesh(verts)
        dims = verts.max(0) - verts.min(0)
        model_dir = os.path.join(out_dir, f"model{mi:04d}")
        os.makedirs(os.path.join(model_dir, "partial"), exist_ok=True)

        os.makedirs(os.path.join(model_dir, "surface"), exist_ok=True)
        labels = {}
        view = 0
        for pose in poses:
            pose = np.asarray(pose, np.float64)
            placed = transform_mesh(verts, pose)
            partial = raycast_mesh(placed, faces)
            if len(partial) < min_partial_pts:
                continue
            key = f"{view:03d}"
            np.save(os.path.join(model_dir, "partial", key + ".npy"), partial)
            # per-view complete surface in the VIEW frame — the loss
            # contract (VCN losses chamfer view-frame coarse against
            # 'complete') and the reference layout (surface/%s/%03d.pcd,
            # VCDataset.py:28) both put completes in the view frame; a
            # shared canonical complete trains the net to place shapes
            # at the origin
            np.save(os.path.join(model_dir, "surface", key + ".npy"),
                    sample_surface(placed, faces, n_complete, rng))
            s = pose[3] / dims[0]  # transform_mesh scales uniformly by dx ratio
            labels[key] = {"gtbox": np.array(
                [pose[0], pose[1], pose[2],
                 dims[0] * s, dims[1] * s, dims[2] * s, pose[6]], np.float32)}
            view += 1
        # complete surface in canonical pose (kept for CN-style consumers)
        complete = sample_surface(verts, faces, n_complete, rng)
        np.save(os.path.join(model_dir, "complete.npy"), complete)
        with open(os.path.join(model_dir, "labels.pkl"), "wb") as f:
            pickle.dump(labels, f)
        logger(f"model {mi}: {view} views")
