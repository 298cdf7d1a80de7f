"""Data augmentation on the device (port of seevcn_tpu/data/augmentor.py;
reference datasets/augmentor/augmentor_utils.py and data_augmentor.py).

Every augmentation of a frame is split in two: ``draw_params`` draws its
random values from an explicit ``torch.Generator`` (on the frame's device),
and an ``apply_*`` function applies given values. ``augment_frame`` is
both. The JAX package draws from threefry keys, whose numbers torch cannot
reproduce; its draws, computed with its own key splits, can be handed to
the ``apply_*`` functions instead (tests/test_torch_kitti_data.py).

A frame is fixed-capacity: points (P, 3+C) with a validity mask, ground
truth (M, 7) with a mask. The frustum dropouts and the pyramid's dropout
and sparsify invalidate points and boxes instead of removing them.

The per-box augmentations keep the JAX package's sequential order
(``lax.scan`` over the boxes): box i's move is applied before box j's
membership test, so a point that box i moved into box j moves again. The
port loops over the boxes (at most ``max_boxes``, 64), each step a batch of
tensor ops over the points with the box's mask folded in by ``where``, so
that no step reads a value back to the host.

``GTDatabaseSampler`` (the GT-database paste) stays on the host in numpy
with the JAX package's ``np.random.default_rng(0)`` draws, so that its
frames equal JAX's bit for bit.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from ..geom.boxes import boxes3d_nearest_bev_iou, points_in_boxes
from ..geom.transforms import rotate_points_along_z

#: the frustum dropouts' directions: (axis, +1 for the top of the axis)
_AXIS_SIGN = {"top": (2, 1), "bottom": (2, -1), "left": (1, 1), "right": (1, -1)}


def _uniform(shape, lo, hi, generator, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=device)


def _rotate(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(N, 3) points rotated by one angle about z."""
    return rotate_points_along_z(points[None], angle.reshape(1))[0]


def _in_box_mask(points: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """(P, 3+) points inside one (7,) box -> (P,) bool (get_points_in_box)."""
    local = _rotate(points[:, :3] - box[:3], -box[6])
    return ((local[:, 0].abs() <= box[3] / 2) & (local[:, 1].abs() <= box[4] / 2)
            & (local[:, 2].abs() <= box[5] / 2))


def _set_xyz(points: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    return torch.cat([xyz, points[:, 3:]], dim=1)


# --------------------------------------------------------------------------- #
# world augmentations
# --------------------------------------------------------------------------- #

def apply_world_flip(points, gt_boxes, enable_x=None, enable_y=None):
    """random_flip_along_x: y and the heading negated; random_flip_along_y:
    x negated and the heading -(heading + pi). ``enable_*`` 0-d bools."""
    if enable_x is not None:
        pts = points.clone()
        pts[:, 1] = -pts[:, 1]
        gbs = gt_boxes.clone()
        gbs[:, 1] = -gbs[:, 1]
        gbs[:, 6] = -gbs[:, 6]
        points = torch.where(enable_x, pts, points)
        gt_boxes = torch.where(enable_x, gbs, gt_boxes)
    if enable_y is not None:
        pts = points.clone()
        pts[:, 0] = -pts[:, 0]
        gbs = gt_boxes.clone()
        gbs[:, 0] = -gbs[:, 0]
        gbs[:, 6] = -(gbs[:, 6] + math.pi)
        points = torch.where(enable_y, pts, points)
        gt_boxes = torch.where(enable_y, gbs, gt_boxes)
    return points, gt_boxes


def apply_world_rotation(points, gt_boxes, angle):
    """The scene and the boxes' centres rotated by ``angle`` about z, the
    headings turned by it."""
    pts = _rotate(points[:, :3], angle)
    centres = _rotate(gt_boxes[:, :3], angle)
    return (_set_xyz(points, pts),
            torch.cat([centres, gt_boxes[:, 3:6], gt_boxes[:, 6:7] + angle,
                       gt_boxes[:, 7:]], dim=1))


def apply_world_scaling(points, gt_boxes, scale):
    """Points' xyz and the boxes' centres and sizes times ``scale``."""
    return (_set_xyz(points, points[:, :3] * scale),
            torch.cat([gt_boxes[:, :6] * scale, gt_boxes[:, 6:]], dim=1))


def apply_world_translation(points, gt_boxes, noise, stds, axes):
    """A shift of noise (3,) standard normals times ``stds`` on the listed
    axes (random_translation_along_*)."""
    sel = noise.new_tensor([1.0 if ax in axes else 0.0 for ax in "xyz"])
    offs = noise * noise.new_tensor(stds) * sel
    return (_set_xyz(points, points[:, :3] + offs),
            torch.cat([gt_boxes[:, :3] + offs, gt_boxes[:, 3:]], dim=1))


def apply_object_scaling(points, gt_boxes, gt_mask, scales):
    """Each valid box and its points scaled by its factor in (M,) about its
    frame, the box lifted to stay on the ground (SEE-VCN's
    random_object_scaling, shrink-only ranges). A point in several boxes
    follows the first."""
    inside = points_in_boxes(points[:, :3], gt_boxes[:, :7]) & gt_mask[:, None]   # (M, P)
    box_of_point = torch.argmax(inside.to(torch.uint8), dim=0)
    in_any = inside.any(0)
    c = gt_boxes[box_of_point, :3]
    ry = gt_boxes[box_of_point, 6]
    s = scales[box_of_point]
    local = rotate_points_along_z((points[:, :3] - c)[:, None, :], -ry)[:, 0] * s[:, None]
    back = rotate_points_along_z(local[:, None, :], ry)[:, 0]
    dz_shift = (gt_boxes[box_of_point, 5] * (s - 1)) / 2
    new_xyz = back + c + torch.stack([torch.zeros_like(dz_shift),
                                      torch.zeros_like(dz_shift), dz_shift], dim=1)
    pts = _set_xyz(points, torch.where(in_any[:, None], new_xyz, points[:, :3]))
    f = torch.where(gt_mask, scales, 1.0)[:, None]
    z = gt_boxes[:, 2] + torch.where(gt_mask, gt_boxes[:, 5] * (scales - 1) / 2, 0.0)
    gbs = torch.cat([gt_boxes[:, :2], z[:, None], gt_boxes[:, 3:6] * f, gt_boxes[:, 6:]],
                    dim=1)
    return pts, gbs


# --------------------------------------------------------------------------- #
# per-box augmentations, box after box
# --------------------------------------------------------------------------- #

def _scan_boxes(points, gt_boxes, gt_mask, per_box, values):
    """per_box(points, box, value) -> (points, box) over the boxes in order,
    each step kept only where its box is valid (the JAX package's lax.scan)."""
    boxes = []
    for i in range(gt_boxes.shape[0]):
        new_pts, new_box = per_box(points, gt_boxes[i], values[i])
        points = torch.where(gt_mask[i], new_pts, points)
        boxes.append(torch.where(gt_mask[i], new_box, gt_boxes[i]))
    return points, torch.stack(boxes) if boxes else gt_boxes


def apply_local_translation(points, gt_boxes, gt_mask, offsets, axes):
    """Each box and its points shifted by its (3,) row of ``offsets`` on the
    listed axes (random_local_translation_along_*)."""
    sel = offsets.new_tensor([1.0 if ax in axes else 0.0 for ax in "xyz"])

    def per_box(pts, box, off):
        off = off * sel
        inb = _in_box_mask(pts, box)
        pts = _set_xyz(pts, pts[:, :3] + torch.where(inb[:, None], off, 0.0))
        return pts, torch.cat([box[:3] + off, box[3:]])

    return _scan_boxes(points, gt_boxes, gt_mask, per_box, offsets)


def apply_local_rotation(points, gt_boxes, gt_mask, angles):
    """Each box's points rotated by its angle about its centre, its heading
    turned by it (local_rotation)."""
    def per_box(pts, box, ang):
        inb = _in_box_mask(pts, box)
        rot = _rotate(pts[:, :3] - box[:3], ang) + box[:3]
        pts = _set_xyz(pts, torch.where(inb[:, None], rot, pts[:, :3]))
        return pts, torch.cat([box[:6], box[6:7] + ang, box[7:]])

    return _scan_boxes(points, gt_boxes, gt_mask, per_box, angles)


def apply_local_scaling(points, gt_boxes, gt_mask, scales):
    """Each box's points scaled by its factor about its centre, its size too
    (local_scaling)."""
    def per_box(pts, box, s):
        inb = _in_box_mask(pts, box)
        scaled = (pts[:, :3] - box[:3]) * s + box[:3]
        pts = _set_xyz(pts, torch.where(inb[:, None], scaled, pts[:, :3]))
        return pts, torch.cat([box[:3], box[3:6] * s, box[6:]])

    return _scan_boxes(points, gt_boxes, gt_mask, per_box, scales)


# --------------------------------------------------------------------------- #
# frustum dropouts
# --------------------------------------------------------------------------- #

def apply_world_frustum_dropout(points, valid, gt_boxes, gt_mask, intensities, directions):
    """global_frustum_dropout_*: per direction, the slab of the valid
    points' extent along z (top / bottom) or y (left / right) that the
    direction's intensity in (n_dir,) names is invalidated, with the boxes
    whose centre lies in it."""
    for d, inten in zip(directions, intensities):
        ax, sign = _AXIS_SIGN[d]
        coord = points[:, ax]
        big = torch.where(valid, coord, -torch.inf).max()
        small = torch.where(valid, coord, torch.inf).min()
        span = big - small
        if sign > 0:
            thr = big - inten * span
            keep_p, keep_b = coord < thr, gt_boxes[:, ax] < thr
        else:
            thr = small + inten * span
            keep_p, keep_b = coord > thr, gt_boxes[:, ax] > thr
        valid = valid & keep_p
        gt_mask = gt_mask & keep_b
    return points, valid, gt_boxes, gt_mask


def apply_local_frustum_dropout(points, valid, gt_boxes, gt_mask, intensities, directions):
    """local_frustum_dropout_*: per valid box and direction, its points in
    the slab of the box's extent that intensities (M, n_dir) names are
    invalidated (the box kept). The points do not move, so the boxes'
    order does not matter: all boxes at once."""
    if gt_boxes.shape[0] == 0:
        return points, valid, gt_boxes, gt_mask
    inb = points_in_boxes(points[:, :3], gt_boxes[:, :7])                   # (M, P)
    for di, d in enumerate(directions):
        ax, sign = _AXIS_SIGN[d]
        half = (gt_boxes[:, 5] if ax == 2 else gt_boxes[:, 4]) / 2
        top, bot = gt_boxes[:, ax] + half, gt_boxes[:, ax] - half
        inten = intensities[:, di]
        if sign > 0:
            drop = inb & (points[None, :, ax] > (top - inten * (top - bot))[:, None])
        else:
            drop = inb & (points[None, :, ax] < (bot + inten * (top - bot))[:, None])
        valid = valid & ~(drop & gt_mask[:, None]).any(0)
    return points, valid, gt_boxes, gt_mask


# --------------------------------------------------------------------------- #
# the local pyramid augmentation
# --------------------------------------------------------------------------- #

def _pyramid_membership(points, box):
    """(P,) face index in [0, 6) (+x, -x, +y, -y, +z, -z: the face its
    largest normalised local coordinate points at) and the (P,) inside-box
    mask: the apex-at-centre face pyramids of augmentor_utils.get_pyramids,
    in closed form."""
    local = _rotate(points[:, :3] - box[:3], -box[6])
    u = local / (box[3:6] / 2).clamp_min(1e-6)
    au = u.abs()
    inside = (au <= 1.0).all(1)
    axis = torch.argmax(au, dim=1)
    pos = torch.gather(u, 1, axis[:, None])[:, 0] > 0
    return axis * 2 + torch.where(pos, 0, 1), inside


def apply_local_pyramid_aug(points, valid, gt_boxes, gt_mask, params, draws):
    """local_pyramid_dropout, _sparsify and _swap (augmentor_utils.py:614-760)
    with the draws of ``draw_params``: per valid box, with DROP_PROB one
    face pyramid's points are invalidated; else with SPARSIFY_PROB one
    pyramid keeps SPARSIFY_MAX_NUM of its points (the lowest ranks); else
    with SWAP_PROB one pyramid's points move into a partner box's same
    normalised local coordinates. Boxes in order, as the JAX package's two
    scans."""
    drop_prob, sp_prob, sp_num, swap_prob = (float(params[0]), float(params[1]),
                                             int(params[2]), float(params[3]))
    m, p = gt_boxes.shape[0], points.shape[0]
    do_drop = (draws["u_drop"] <= drop_prob) & gt_mask
    do_sp = (draws["u_sparsify"] <= sp_prob) & gt_mask & ~do_drop
    do_swap = (draws["u_swap"] <= swap_prob) & gt_mask & ~do_drop & ~do_sp
    faces, insides = [], []
    kth_at = min(sp_num, p - 1)
    for i in range(m):
        box, ok = gt_boxes[i], gt_mask[i]
        face, inside = _pyramid_membership(points, box)
        faces.append(face)
        insides.append(inside)
        valid = valid & ~(inside & (face == draws["drop_face"][i]) & do_drop[i] & ok)
        msp = inside & (face == draws["sparsify_face"][i]) & do_sp[i] & ok & valid
        order = torch.where(msp, draws["rank"][i], 2.0)
        kth = torch.kthvalue(order, kth_at + 1).values
        valid = valid & ~(msp & (order >= kth) & (msp.sum() > sp_num))
    partner = draws["partner"]
    for i in range(m):
        box, pbox = gt_boxes[i], gt_boxes[partner[i]]
        ok = do_swap[i] & gt_mask[partner[i]] & (partner[i] != i)
        msk = insides[i] & (faces[i] == draws["swap_face"][i]) & ok & valid
        u = _rotate(points[:, :3] - box[:3], -box[6]) / (box[3:6] / 2).clamp_min(1e-6)
        new_world = _rotate(u * pbox[3:6] / 2, pbox[6]) + pbox[:3]
        points = _set_xyz(points, torch.where(msk[:, None], new_world, points[:, :3]))
    return points, valid, gt_boxes, gt_mask


# --------------------------------------------------------------------------- #
# draws, and the chain
# --------------------------------------------------------------------------- #

def draw_params(aug_list: tuple, num_points: int, num_boxes: int,
                generator: torch.Generator | None, device) -> list:
    """The random values of each augmentation of ``aug_list`` for one frame
    of ``num_points`` points and ``num_boxes`` box rows, drawn in order from
    ``generator`` on ``device``: a list, one entry an augmentation, as the
    ``apply_*`` functions take them."""
    g, dev, m = generator, device, num_boxes
    out = []
    for name, params in aug_list:
        if name == "random_object_scaling":
            out.append(_uniform((m,), params[0], params[1], g, dev))
        elif name == "random_world_flip":
            out.append([torch.rand((), generator=g, device=dev) < 0.5 for _ in params])
        elif name == "random_world_rotation" or name == "random_world_scaling":
            out.append(_uniform((), params[0], params[1], g, dev))
        elif name == "random_world_translation":
            out.append(torch.randn((3,), generator=g, device=dev))
        elif name == "random_local_translation":
            out.append(_uniform((m, 3), params[0][0], params[0][1], g, dev))
        elif name in ("random_local_rotation", "random_local_scaling"):
            out.append(_uniform((m,), params[0], params[1], g, dev))
        elif name == "random_world_frustum_dropout":
            out.append(_uniform((len(params[1]),), params[0][0], params[0][1], g, dev))
        elif name == "random_local_frustum_dropout":
            out.append(_uniform((m, len(params[1])), params[0][0], params[0][1], g, dev))
        elif name == "random_local_pyramid_aug":
            out.append({
                "u_drop": torch.rand((m,), generator=g, device=dev),
                "drop_face": torch.randint(0, 6, (m,), generator=g, device=dev),
                "u_sparsify": torch.rand((m,), generator=g, device=dev),
                "sparsify_face": torch.randint(0, 6, (m,), generator=g, device=dev),
                "rank": torch.rand((m, num_points), generator=g, device=dev),
                "u_swap": torch.rand((m,), generator=g, device=dev),
                "partner": torch.randperm(m, generator=g, device=dev),
                "swap_face": torch.randint(0, 6, (m,), generator=g, device=dev)})
        else:
            raise NotImplementedError(name)
    return out


def apply_augmentations(points, valid, gt_boxes, gt_mask, aug_list: tuple, draws: list):
    """The chain of ``aug_list`` with ``draws`` (``draw_params``' list) on one
    frame: points (P, 3+C), valid (P,), gt_boxes (M, 7), gt_mask (M,) ->
    the four, updated."""
    for (name, params), d in zip(aug_list, draws):
        if name == "random_object_scaling":
            points, gt_boxes = apply_object_scaling(points, gt_boxes, gt_mask, d)
        elif name == "random_world_flip":
            for ax, enable in zip(params, d):
                points, gt_boxes = apply_world_flip(
                    points, gt_boxes, **{f"enable_{'x' if ax == 'x' else 'y'}": enable})
        elif name == "random_world_rotation":
            points, gt_boxes = apply_world_rotation(points, gt_boxes, d)
        elif name == "random_world_scaling":
            points, gt_boxes = apply_world_scaling(points, gt_boxes, d)
        elif name == "random_world_translation":
            points, gt_boxes = apply_world_translation(points, gt_boxes, d, params[0],
                                                       params[1])
        elif name == "random_local_translation":
            points, gt_boxes = apply_local_translation(points, gt_boxes, gt_mask, d,
                                                       params[1])
        elif name == "random_local_rotation":
            points, gt_boxes = apply_local_rotation(points, gt_boxes, gt_mask, d)
        elif name == "random_local_scaling":
            points, gt_boxes = apply_local_scaling(points, gt_boxes, gt_mask, d)
        elif name == "random_world_frustum_dropout":
            points, valid, gt_boxes, gt_mask = apply_world_frustum_dropout(
                points, valid, gt_boxes, gt_mask, d, params[1])
        elif name == "random_local_frustum_dropout":
            points, valid, gt_boxes, gt_mask = apply_local_frustum_dropout(
                points, valid, gt_boxes, gt_mask, d, params[1])
        elif name == "random_local_pyramid_aug":
            points, valid, gt_boxes, gt_mask = apply_local_pyramid_aug(
                points, valid, gt_boxes, gt_mask, params, d)
        else:
            raise NotImplementedError(name)
    return points, valid, gt_boxes, gt_mask


def augment_frame(points, valid, gt_boxes, gt_mask, aug_list: tuple,
                  generator: torch.Generator | None = None):
    """``draw_params`` from ``generator`` (on the points' device), then
    ``apply_augmentations``. aug_list: (name, params) pairs, as
    ``aug_list_from_cfg`` gives them."""
    draws = draw_params(aug_list, points.shape[0], gt_boxes.shape[0], generator,
                        points.device)
    return apply_augmentations(points, valid, gt_boxes, gt_mask, aug_list, draws)


def aug_list_from_cfg(aug_cfg) -> tuple:
    """A DATA_AUGMENTOR block -> the (name, params) pairs of its device
    augmentations (gt_sampling is ``GTDatabaseSampler``'s, on the host)."""
    out = []
    disable = set(aug_cfg.get("DISABLE_AUG_LIST", []))
    for a in aug_cfg.get("AUG_CONFIG_LIST", []):
        name = a["NAME"]
        if name in disable or name == "gt_sampling":
            continue
        if name == "random_object_scaling":
            out.append((name, tuple(a["SCALE_UNIFORM_NOISE"])))
        elif name == "random_world_flip":
            out.append((name, tuple(a["ALONG_AXIS_LIST"])))
        elif name == "random_world_rotation":
            r = a["WORLD_ROT_ANGLE"]
            r = r if isinstance(r, (list, tuple)) else [-r, r]
            out.append((name, tuple(r)))
        elif name == "random_world_scaling":
            out.append((name, tuple(a["WORLD_SCALE_RANGE"])))
        elif name == "random_world_translation":
            std = a["NOISE_TRANSLATE_STD"]
            std = std if isinstance(std, (list, tuple)) else [std] * 3
            out.append((name, (tuple(float(v) for v in std),
                               tuple(a.get("ALONG_AXIS_LIST", ["x", "y", "z"])))))
        elif name == "random_local_translation":
            out.append((name, (tuple(a["LOCAL_TRANSLATION_RANGE"]),
                               tuple(a.get("ALONG_AXIS_LIST", ["x", "y", "z"])))))
        elif name == "random_local_rotation":
            rr = a["LOCAL_ROT_ANGLE"]
            rr = rr if isinstance(rr, (list, tuple)) else [-rr, rr]
            out.append((name, tuple(rr)))
        elif name == "random_local_scaling":
            out.append((name, tuple(a["LOCAL_SCALE_RANGE"])))
        elif name in ("random_world_frustum_dropout", "random_local_frustum_dropout"):
            out.append((name, (tuple(a["INTENSITY_RANGE"]),
                               tuple(a.get("DIRECTION", ["top", "bottom", "left", "right"])))))
        elif name == "random_local_pyramid_aug":
            out.append((name, (float(a.get("DROP_PROB", 0.25)),
                               float(a.get("SPARSIFY_PROB", 0.05)),
                               int(a.get("SPARSIFY_MAX_NUM", 50)),
                               float(a.get("SWAP_PROB", 0.1)))))
    return tuple(out)


class GTDatabaseSampler:
    """The GT-database paste on the host (reference DataBaseSampler,
    database_sampler.py:15-422): per class, stored objects are drawn and
    their points and boxes pasted into the frame, a sample whose box
    overlaps an existing one (aligned-BEV IoU above 0) rejected. Draws from
    ``np.random.default_rng(0)``, as the JAX package's."""

    def __init__(self, root_path, sampler_cfg, class_names):
        self.root_path = root_path
        self.class_names = list(class_names)
        self.sample_groups = {}
        for grp in sampler_cfg["SAMPLE_GROUPS"]:
            name, num = grp.split(":")
            if name in self.class_names:
                self.sample_groups[name] = int(num)
        self.infos = {c: [] for c in self.class_names}
        for db_path in sampler_cfg["DB_INFO_PATH"]:
            with open(f"{root_path}/{db_path}", "rb") as f:
                infos = pickle.load(f)
            for c in self.class_names:
                self.infos[c].extend(infos.get(c, []))
        for rule in sampler_cfg.get("PREPARE", {}).get("filter_by_min_points", []):
            name, num = rule.split(":")
            if name in self.infos:
                self.infos[name] = [i for i in self.infos[name]
                                    if i["num_points_in_gt"] >= int(num)]
        self.num_point_features = int(sampler_cfg.get("NUM_POINT_FEATURES", 4))
        self.rng = np.random.default_rng(0)

    @staticmethod
    def _bev_overlap(boxes_a, boxes_b) -> np.ndarray:
        """The aligned-BEV IoU (``boxes3d_nearest_bev_iou``) in f32 on the CPU."""
        return boxes3d_nearest_bev_iou(torch.as_tensor(boxes_a, dtype=torch.float32),
                                       torch.as_tensor(boxes_b, dtype=torch.float32)).numpy()

    def __call__(self, points, gt_boxes, gt_names):
        new_boxes, new_names, new_points = [gt_boxes], list(gt_names), [points]
        existing = gt_boxes
        for cls, num in self.sample_groups.items():
            pool = self.infos.get(cls, [])
            if not pool:
                continue
            take = max(0, num - int((np.asarray(gt_names) == cls).sum()))
            picks = self.rng.choice(len(pool), size=min(take, len(pool)), replace=False)
            cand = [pool[i] for i in picks]
            boxes = np.stack([c["box3d_lidar"] for c in cand]) if cand else np.zeros((0, 7))
            if len(boxes) and len(existing):
                ok = self._bev_overlap(boxes[:, :7], existing[:, :7]).max(axis=1) == 0
                cand = [c for c, o in zip(cand, ok) if o]
                boxes = boxes[ok]
            for c, b in zip(cand, boxes):
                obj = np.fromfile(f"{self.root_path}/{c['path']}", dtype=np.float32).reshape(
                    -1, self.num_point_features)
                obj[:, :3] += b[:3]
                new_points.append(obj[:, :points.shape[1]])
                new_boxes.append(b[None, :gt_boxes.shape[1]])
                new_names.append(cls)
            if len(boxes):
                existing = np.concatenate([existing, boxes[:, :existing.shape[1]]])
        return (np.concatenate(new_points), np.concatenate(new_boxes), np.array(new_names))
