"""The SEE host pipeline (port of seevcn_tpu/see/pipeline.py; reference
see/surface_completion/SEE_VCN.py).

Per frame: isolate each car's points (GT-box crop on the source domain;
image-mask projection and density clustering on the target domain),
complete them with VCN's list form, and splice the completed surfaces back
into the frame's cloud. The frame and its instances live on the host as
numpy, as in the reference; the batched steps run on ``device``: the box
crop, DBSCAN over every instance at once with an eps each (the adaptive
eps_scaling * range * tan(vres), SEE_VCN.py:167-171), VCN, and the
within-radius tests of the multi-camera merge and the replacement, which
on the card launch the pruned min-distance kernel K1
(``ops/sampling.within_radius_mask``).

``last_stats`` holds the last frame's counts: instances isolated and
completed, scan points dropped by the replacement, and with more than one
camera the pairs of instances the merge tested and joined.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geom.boxes import points_in_boxes
from ..models.vcn.inference import VCNInference
from ..ops.clustering import dbscan, largest_cluster_mask
from ..ops.sampling import pairwise_sqdist, within_radius_mask
from .masks import get_pts_in_mask


class SEEVCN:
    """cfg mirrors the reference SEE YAML (PC_ISOLATION and
    SURFACE_COMPLETION blocks); its VCN block's checkpoint loads onto
    ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, cfg, data_obj=None, device="cuda"):
        self.cfg = cfg
        self.data_obj = data_obj
        self.device = resolve_device(device)
        iso = cfg.get("PC_ISOLATION", {})
        self.min_lidar_pts = int(iso.get("MIN_LIDAR_PTS", 30))
        self.eps_scaling = float(iso.get("EPS_SCALING", 4.0))
        self.min_eps = float(iso.get("MIN_EPS", 0.3))
        self.max_eps = float(iso.get("MAX_EPS", 1.0))
        sc = cfg.get("SURFACE_COMPLETION", {})
        self.vres = float(sc.get("VRES", 0.4))
        self.use_seev1 = bool(sc.get("USE_SEEV1", False))  # SEE_VCN.py:40
        self.vcn = VCNInference.from_cfg(sc.VCN, device=self.device) \
            if sc.get("VCN") else None
        self.last_stats: dict = {}

    def _on_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    # ------------------------------------------------------------------ #
    # GT path (source domain, SEE_VCN.py:46-115)
    # ------------------------------------------------------------------ #

    def isolate_gt_pts(self, points: np.ndarray, gt_boxes: np.ndarray,
                       ground_lift: float = 0.1):
        """points (N, 3+), gt_boxes (M, 7+) -> (the point arrays of the
        objects with >= min_lidar_pts points inside their box lifted by
        ``ground_lift``, their boxes)."""
        if len(gt_boxes) == 0:
            return [], []
        boxes = np.array(gt_boxes[:, :7], np.float32, copy=True)
        boxes[:, 2] += ground_lift                 # lift the crop box off the ground
        inside = points_in_boxes(self._on_device(points[:, :3]),
                                 self._on_device(boxes)).cpu().numpy()
        pcds, labels = [], []
        for i in range(len(boxes)):
            obj = points[inside[i], :3]
            if len(obj) >= self.min_lidar_pts:
                pcds.append(obj)
                labels.append(gt_boxes[i, :7])
        return pcds, labels

    def complete_gt_pts(self, isolated_pts, gt_labels):
        self.last_stats["completed"] = len(isolated_pts)
        if not isolated_pts:
            return {"all_instances": None}
        if self.use_seev1:
            # legacy SEE-v1 densification (SEE_VCN.py:95-103)
            clustered = [seev1_sampling(p, len(p), gt_box=np.asarray(g), vres=self.vres, seed=i)
                         for i, (p, g) in enumerate(zip(isolated_pts, gt_labels))]
            return {"clustered": clustered,
                    "all_instances": np.unique(np.vstack(clustered).astype(np.float32), axis=0)}
        ret = self.vcn.complete_list(isolated_pts, gt_labels)
        ret["all_instances"] = np.unique(np.vstack(ret["clustered"]).astype(np.float32), axis=0)
        return ret

    # ------------------------------------------------------------------ #
    # DET path (target domain, SEE_VCN.py:117-245)
    # ------------------------------------------------------------------ #

    def get_det_instances(self, idx, camera_channels=None, shrink_percentage=None,
                          use_bbox=False):
        do = self.data_obj
        camera_channels = camera_channels or do.camera_channels
        if shrink_percentage is None:
            shrink_percentage = getattr(do, "shrink_mask_percentage", 0)
        proj = []
        for cam in camera_channels:
            imgfov = do.map_pointcloud_to_image(idx, camera_channel=cam)
            instances = do.get_camera_instances(idx, channel=cam)
            proj.append(get_pts_in_mask(do.masks[cam], instances, imgfov,
                                        shrink_percentage=shrink_percentage,
                                        use_bbox=use_bbox))
        return proj

    def isolate_det_pts(self, proj_dicts, min_cluster: int = 10,
                        max_instance_pts: int = 2048):
        """Mask-selected point sets -> the largest density cluster of each
        (an instance of over ``max_instance_pts`` points first subsampled
        by ``RandomState(0).choice``), every instance in one batched DBSCAN
        (min 3 points) with its own eps; clusters of over ``min_cluster``
        points are kept."""
        merged = {}
        for pd in proj_dicts:
            for k, v in pd.items():
                merged.setdefault(k, []).extend(v)

        raw = [x for x in merged.get("lidar_xyz", []) if x.shape[0] > min_cluster]
        self.last_stats["isolated"] = 0
        if not raw:
            return []

        b = len(raw)
        pts = np.zeros((b, max_instance_pts, 3), np.float32)
        valid = np.zeros((b, max_instance_pts), bool)
        eps = np.zeros((b,), np.float32)
        for i, xyz in enumerate(raw):
            xyz = np.asarray(xyz, np.float32)[:, :3]
            if len(xyz) > max_instance_pts:
                sel = np.random.RandomState(0).choice(len(xyz), max_instance_pts,
                                                      replace=False)
                xyz = xyz[sel]
            pts[i, :len(xyz)] = xyz
            valid[i, :len(xyz)] = True
            dist = np.linalg.norm(xyz.mean(axis=0))
            ring_h = dist * np.tan(self.vres * np.pi / 180)
            eps[i] = np.clip(self.eps_scaling * ring_h, self.min_eps, self.max_eps)

        with torch.no_grad():
            labels = dbscan(self._on_device(pts), self._on_device(eps), min_points=3,
                            valid=torch.from_numpy(valid).to(self.device))
            masks = largest_cluster_mask(labels).cpu().numpy()

        instances = []
        for i in range(b):
            clustered = pts[i][masks[i]]
            if clustered.shape[0] > min_cluster:
                instances.append(clustered)
        self.last_stats["isolated"] = len(instances)
        return instances

    def merge_multi_camera_detections(self, instances, min_overlap: int = 3,
                                      min_dist_to_check: float = 3.0,
                                      radius: float = 0.1):
        """Merge the per-camera clusters of one physical object
        (SEE_VCN.py:183-209). ``last_stats`` counts the pairs tested
        (``merge_checks``: one within-radius test each, K1 on the card) and
        the pairs joined (``merged``)."""
        inst = list(instances)
        dists = [np.linalg.norm(x.mean(axis=0)) for x in inst]
        joined = set()
        n0 = len(inst)
        checks = merged = 0
        for i in range(n0):
            for j in range(n0):
                if i == j or j in joined:
                    continue
                if abs(dists[i] - dists[j]) >= min_dist_to_check:
                    continue
                near = within_radius_mask(self._on_device(inst[j]), self._on_device(inst[i]),
                                          radius).cpu().numpy()
                checks += 1
                if near.sum() > min_overlap:
                    inst.append(np.vstack([inst[i], inst[j]]))
                    joined.update((i, j))
                    merged += 1
        self.last_stats.update(merge_checks=checks, merged=merged)
        return [inst[i] for i in range(len(inst)) if i not in joined]

    def complete_det_pts(self, instances):
        if self.data_obj is not None and len(self.data_obj.camera_channels) > 1:
            instances = self.merge_multi_camera_detections(instances)
        filtered = [x for x in instances if x.shape[0] > self.min_lidar_pts]
        self.last_stats["completed"] = len(filtered)
        if not filtered:
            return {"all_instances": None}
        if self.use_seev1:
            # legacy SEE-v1 densification, no gt boxes (SEE_VCN.py:227-233)
            clustered = [seev1_sampling(p, len(p), vres=self.vres, seed=i)
                         for i, p in enumerate(filtered)]
            return {"clustered": clustered,
                    "all_instances": np.unique(np.vstack(clustered).astype(np.float32), axis=0)}
        ret = self.vcn.complete_list(filtered)
        ret["all_instances"] = np.unique(np.vstack(ret["clustered"]).astype(np.float32), axis=0)
        return ret

    # ------------------------------------------------------------------ #
    # splice (SEE_VCN.py:247-265)
    # ------------------------------------------------------------------ #

    def replace_with_completed_pts(self, points: np.ndarray, sc_instances,
                                   point_dist_thresh: float = 0.1) -> np.ndarray:
        """The completed points, then the scan points farther than
        ``point_dist_thresh`` from every one of them."""
        if sc_instances is None:
            self.last_stats["dropped"] = 0
            return points[:, :3]
        near = within_radius_mask(self._on_device(points[:, :3]), self._on_device(sc_instances),
                                  point_dist_thresh).cpu().numpy()
        self.last_stats["dropped"] = int(near.sum())
        return np.vstack([sc_instances, points[~near, :3]]).astype(np.float32)

    # ------------------------------------------------------------------ #
    # frame drivers (sc_multiproc.py:17-63)
    # ------------------------------------------------------------------ #

    def process_gt_frame(self, points, gt_boxes):
        pcds, labels = self.isolate_gt_pts(points, gt_boxes)
        self.last_stats = {"isolated": len(pcds)}
        ret = self.complete_gt_pts(pcds, labels)
        return self.replace_with_completed_pts(points, ret["all_instances"])

    def process_det_frame(self, idx):
        self.last_stats = {}
        proj = self.get_det_instances(idx)
        instances = self.isolate_det_pts(proj)
        ret = self.complete_det_pts(instances)
        points = self.data_obj.get_pointcloud(idx)
        return self.replace_with_completed_pts(points, ret["all_instances"])


# ---------------------------------------------------------------------------
# Legacy SEE-v1 surface densification (reference SEE_VCN.seev1_ball_pivoting
# :282-290 + seev1_sampling:292-303), mesh-free as in the JAX package: each
# point spawns interpolants toward its k nearest neighbours (random
# barycentric mixes), which fills the inter-ring gaps the ball-pivot
# surface's poisson sampling filled. No triangle mesh is produced.
# ---------------------------------------------------------------------------
def seev1_upsample(points: np.ndarray, num_out: int, k: int = 4,
                   seed: int = 0) -> np.ndarray:
    """Densify (N, 3) -> (num_out, 3) by interpolating k-NN pairs, the
    neighbours ranked by ``np.argsort`` over the Gram-form f32 distances
    (``ops/sampling.pairwise_sqdist`` on the CPU), as the reference ranks
    them."""
    n = len(points)
    if n < 3 or num_out <= n:
        return points[:num_out] if num_out < n else points
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(np.asarray(points, np.float32))
    d = pairwise_sqdist(p, p).numpy().copy()
    np.fill_diagonal(d, np.inf)
    nbrs = np.argsort(d, axis=1)[:, :k]                    # (N, k)
    n_new = num_out - n
    src = rng.integers(0, n, n_new)
    dst = nbrs[src, rng.integers(0, k, n_new)]
    t = rng.uniform(0.2, 0.8, (n_new, 1)).astype(np.float32)
    interp = points[src] * (1 - t) + points[dst] * t
    return np.concatenate([points, interp.astype(points.dtype)], axis=0)


def seev1_sampling(points: np.ndarray, num_pcd_pts: int | None = None,
                   gt_box: np.ndarray | None = None, vres: float = 0.4,
                   optimal_ring_height: float = 0.05,
                   seed: int = 0) -> np.ndarray:
    """SEE-v1 sampling rate (SEE_VCN.py:292-303): upsample by ring_height /
    optimal_ring_height, ring_height the lidar's vertical resolution at the
    object's range."""
    num_pcd_pts = num_pcd_pts or len(points)
    center = gt_box[:3] if gt_box is not None else points.mean(axis=0)
    centroid_distance = float(np.linalg.norm(center))
    ring_height = centroid_distance * np.tan(vres * np.pi / 180)
    upsampling_rate = max(ring_height / optimal_ring_height, 1.0)
    return seev1_upsample(points, int(upsampling_rate * num_pcd_pts), seed=seed)
