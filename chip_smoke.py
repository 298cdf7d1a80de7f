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
reloaded into VCNInference; then Mask R-CNN training (phase 11) at the
seg2d CLI's defaults (base widths, 384x512, batch 8, synthetic scenes):
a tiny step against the CPU, 11 steps through ``make_seg2d_train_step``
timed, split and profiled, ``evaluate`` on held-out scenes, its
checkpoint reloaded bit for bit, and the CLI's ``main`` cut to 3 steps.
Then HTC, the reference's mask network: serving (phase 12: the tiny full
HTC against the CPU, full HTC at bench.py's config through ``mask_stage``,
``run_frame`` with it, ``MaskRCNNBackend`` on a KITTI-sized BGR image, and
each deformable conv timed beside its bound) and training (phase 13: the
tiny full-HTC step against the CPU, the seg2d CLI's HTC flags at the base
config, the CLI's ``main`` with them, one HTC + DCN step through the API).
Then PV-RCNN (phase 14): the tiny model's eval and train step against the
CPU, PV-RCNN at OpenPCDet's pv_rcnn.yaml widths on the SEE frame's
completed cloud (``see_and_detect``, K1 counted) and through ``run_frame``,
its stages timed, and 1 + 1 train steps at batch 2. Then PV-RCNN++
(phase 15): the tiny model (SPC + VectorPool) against the CPU, PV-RCNN++ at
pv_rcnn_plusplus.yaml's PFE on the same cloud and through ``run_frame`` (K1
counted in each), its stages timed (the proposal filter and the sector FPS
among them), and 1 + 1 train steps at batch 2. Then the single-stage
detectors (phase 16): the tiny PointPillar, multi-head residual SECONDNet and
focal SECONDNet against the CPU in eval and in a train step, the ATSS
assigner against the CPU, PointPillar at pointpillar.yaml's widths and the
multi-head SECONDNet on the SEE frame's completed cloud and through
``run_frame`` (K1 counted), their stages and NMS timed, 1 + 1 + 5 train steps
at batch 4 each, and the focal SECONDNet's eval forward. Then CenterPoint
and Voxel R-CNN (phase 17): the tiny models against the CPU in eval and in
a train step, each at full width (centerpoint.yaml's model on the flagship's
grid, voxel_rcnn_car.yaml) on the SEE frame's completed cloud and through
``run_frame`` (K1 counted), their stages, first BEV conv and Voxel R-CNN's
pools timed, and 1 + 1 + 1 train steps (batch 4 and 2). Then PointRCNN and
Part-A2 (phase 18): the tiny models against the CPU in eval and in a train
step (their f32 selections pinned to the CPU's), the inverse sparse conv
against the CPU forward and backward, each at full width (pointrcnn.yaml,
PartA2.yaml) on the SEE frame's completed cloud and through ``run_frame``
(K1 counted), their stages and ops alone timed (ball queries, three-NN,
FPS, inverse convs, roiaware pools, the first BEV conv), PointRCNN also on
16,384 resampled points, and 1 + 1 + 1 train steps (batch 2 and 4).
Then CaDDN and the KITTI data path (phase 19): the tiny CaDDN in both
forms against the CPU in eval and in a train step (the frustum cells
pinned to the CPU's), a synthetic KITTI split of 8 frames written to a
temporary directory, its GT completion (K1 counted) into the .pcds that
SCKittiDataset reads, that dataset with kitti_dataset.yaml's augmentor
through BackgroundLoader and ``augment_on_device`` into 3 SECOND-IoU train
steps, ``eval_one_epoch`` with KITTI's AP, then CaDDN at CaDDN.yaml's
widths on one of the split's frames (stages, the frustum sample and the
collapse conv alone) and 1 + 1 + 3 train steps at batch 2 on its camera
items. Then the KITTI SEE-VCN workflow through the port's CLIs (phase 20):
a raw KITTI tree of 4 frames of 120,000 points, create_infos on it,
generate_masks with the seeded Mask R-CNN at 384x1280, run_see's DET path
at KIT-DET_VCN-VC's settings on masks from the cars' boxes (K1 counted, the
native IO route asserted), a resumed run and the GT path, one frame of
each path card vs CPU, train_detector at SECOND-IoU's flagship widths on
the completed split (an epoch, then a resume) and test_detector on
DATA_CONFIG_TAR. Then the paper's other domains (phase 21: Waymo as the
source, nuScenes, Lyft and Baraja as targets, through the same CLIs). Then
the demo and the JPEG inputs (phase 22): the committed JPEG fixtures, one
of each mode the decoder reads, decoded on this host against cv2's hashes
(a baseline, a progressive and an arithmetic 900x1600 decode timed),
generate_masks on JPEGs and on PNGs of the same pixels, ``cli/demo.py`` end
to end inside ``profiling.trace()`` (K1 counted) and its SEE on the CPU,
once more on a progressive front image with an EXIF thumbnail (the same
output), the flagship
with a bf16 BEV backbone beside its f32 run, two spinning-lidar DA frames
and the paired BEV IoU against the CPU. Then data parallelism on the one
card (phase 23): NCCL at world size 1 (collectives on CUDA tensors, and
train_detector and test_detector with --launcher jax against --launcher
none, their predictions held frame by frame), then two ranks spawned over
gloo on the same card: the flagship's ``shard_train_step`` against
``train_step`` on the global batch, a tiny step of each other detector
against its world-1 step, the frames-over-ranks GT completion (K1 counted
on each rank) with a witness of its batch independence, and
``eval_one_epoch`` at world 2 against world 1, predictions and recall;
NCCL at world size 2 or more needs a card a rank. Then model parallelism on
the one card (phase 24): gloo ranks on the same card at (dp 1, mp 2) and
(dp 2, mp 2), the flagship's BEV map split over W between the mp ranks
(halo exchanges, the gather before the heads): its BEV backbone on the
slabs and its eval forward against the whole map, its steps against the
world-1 step, the tiny sharded detectors and PointPillar (replicated over
mp) against theirs, every rank bit-equal, the exchanges timed. Then the
repo's own SEE experiments through ``seevcn_torch.experiments`` (phase 25):
the DA sets and VC data generated, VCN_VC and VCN_CN trained an epoch, the
sets completed on the GT path (K1 once a frame) with one frame card vs CPU,
the raw and completed-source SECOND-IoU trained 10 steps each, the
runbook's five evals and the AP table, and the DET-vs-GT mask paths on two
frames (K1 twice a frame). Every failed check raises, so the exit code is
not 0. The last line of standard output is one JSON object naming the
device; the line before it holds the kernel summary.

    python3 chip_smoke.py --phase 23
    python3 chip_smoke.py --phase 24
    python3 chip_smoke.py --phase 25

runs phase 23, 24 or 25 alone, after the set-up it needs, and prints no
result line.

It needs one CUDA card and nvcc; it imports nothing of JAX or seevcn_tpu.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from seevcn_torch.models.detectors import caddn as CADDN
from seevcn_torch.models.detectors import configs as DC
from seevcn_torch.models.detectors import pointrcnn as PRC
from seevcn_torch.models.detectors import pvrcnn as PV
from seevcn_torch.models.detectors import second as SECOND_MODULE
from seevcn_torch.models.detectors.second import (PointPillar, build_detector,
                                                  post_processing)
from seevcn_torch.models.modules.dense_heads import AnchorHeadLogic
from seevcn_torch.models.modules.backbone3d import VoxelBackBone8x
from seevcn_torch.models.modules.map_to_bev import height_compression
from seevcn_torch.models.modules import pfe as PFE
from seevcn_torch.models.modules import pvrcnn_head as PVH
from seevcn_torch.models.modules import roi_heads as RH
from seevcn_torch.cli import train_seg2d as SEG_CLI
from seevcn_torch.models.seg2d import maskrcnn as SM
from seevcn_torch.models.seg2d import synthetic as SEG_SYN
from seevcn_torch.models.modules.common import DeformConv2d
from seevcn_torch.models.seg2d.backend import (MaskRCNNBackend, build_seg2d, decode_wire,
                                               init_seg2d, load_seg2d_checkpoint,
                                               make_seg2d_train_step,
                                               save_seg2d_checkpoint, seg2d_train_forward,
                                               step_generator)
from seevcn_torch.geom.boxes import boxes_iou_normal
from seevcn_torch.models.vcn import vc_shapenet as VS
from seevcn_torch.models.vcn.dataset import VCDataset
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.models.vcn.metrics import MetricAccumulator
from seevcn_torch.models.vcn.nets import build_vcn
from seevcn_torch.models.vcn.runner import VCNTrainer
from seevcn_torch.ops import cuda as K
from seevcn_torch.ops import nms as NMS
from seevcn_torch.ops import pointnet2 as PN2
from seevcn_torch.ops import roiaware as RA
from seevcn_torch.ops import sampling as SMP
from seevcn_torch.ops import sparse as SP
from seevcn_torch.ops.clustering import largest_cluster_batch
from seevcn_torch.ops.cuda import min_dist as MD
from seevcn_torch.ops.iou3d import boxes_iou_bev
from seevcn_torch.ops.nms import nms_bev
from seevcn_torch.ops.sampling import (cell_hash, farthest_point_sample, fps,
                                      grid_subsample, partial_mesh_batch,
                                      sector_fps_sample, sector_ids, sector_quotas)
from seevcn_torch.ops.voxelize import voxelize_batch
from seevcn_torch.see import device_pipeline as DP
from seevcn_torch.see import frame as F
from seevcn_torch.see.gt_completion import complete_gt_frames
from seevcn_torch.train.optim import build_lr_schedule, build_seg2d_optimizer
from seevcn_torch.train.train import (TrainState, apply_gradients, create_train_state,
                                      train_forward, train_step)
from seevcn_torch.testing import (K2_CARD_EDGES, VCN_BIASES_BEFORE_BN,
                                  assert_vcn_grads_close, completed_rows_apart,
                                  k2_edge_case, one_cpu_thread,
                                  plain_sparse_backward, seeded_seg2d_weights,
                                  seg2d_relu_signs, tiny_htc_cfg, tiny_seg2d_cfg,
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
BF16_FLOPS = 989e12                 # dense, on the tensor cores
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
               pts_per_car: int = 600, occlude: bool = False):
    """A lidar scan in bench.py's layout (x 1..69, y -39..39, z -2.9..0.9 m)
    holding ``n_cars`` box-surface cars in the camera's view, and one
    detection per car: its projected 2D box, a 28x28 mask patch that covers
    the car's projection, and a score; and each car's ground-truth box
    (n_cars, 8): centre, CAR_DIMS, heading, label 1. With ``occlude``, the
    background holds no point that the cars hide from the sensor (at the
    origin), as in a real scan. Returns numpy arrays."""
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

    def seen(p):
        """False where the sight line from the origin to a point crosses a
        car's box (the slab test in the box's frame)."""
        keep = np.ones(len(p), bool)
        half = np.asarray(CAR_DIMS) / 2
        for centre, heading, _ in cars:
            cs, sn = np.cos(heading), np.sin(heading)
            rot = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]])
            o, d = -centre @ rot, p @ rot
            with np.errstate(divide="ignore", invalid="ignore"):
                t1, t2 = (-half - o) / d, (half - o) / d
            t_in = np.minimum(t1, t2).max(1)
            t_out = np.maximum(t1, t2).min(1)
            keep &= ~((t_in <= t_out) & (t_out >= 0) & (t_in <= 1))
        return keep

    car_pts = np.concatenate([c[2] for c in cars])[: n_points // 2]
    n_bg = n_points - len(car_pts)
    bg = np.stack([rng.uniform(1, 69, 2 * n_bg), rng.uniform(-39, 39, 2 * n_bg),
                   rng.uniform(-2.9, 0.9, 2 * n_bg)], 1)
    keep = outside_cars(bg)
    if occlude:
        keep &= seen(bg)
    bg = bg[keep][:n_bg]
    pts = np.concatenate([car_pts, bg])[rng.permutation(n_points)]
    return {"points": pts.astype(np.float32),
            "valid": np.ones(n_points, bool),
            "det_boxes": np.stack(det_boxes).astype(np.float32),
            "det_masks": np.stack(det_masks).astype(np.float32),
            "det_scores": rng.uniform(0.6, 1.0, n_cars).astype(np.float32),
            "gt_boxes": np.array([[*c, *CAR_DIMS, h, 1.0] for c, h, _ in cars],
                                 np.float32).reshape(-1, 8)}


# KITTI's calibration of a 375 x 1242 frame (training/calib/000000.txt's P2,
# R0_rect and Tr_velo_to_cam, rounded), for the synthetic split
KITTI_P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728], [0.0, 721.5377, 172.854, 0.2163791],
                     [0.0, 0.0, 1.0, 0.002745884]])
KITTI_R0 = np.array([[0.9999239, 0.00983776, -0.007445048],
                     [-0.009869795, 0.9999421, -0.004278459],
                     [0.007402527, 0.004351614, 0.9999631]])
KITTI_V2C = np.array([[7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03],
                      [1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02],
                      [9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01]])
KITTI_IMAGE_SHAPE = (375, 1242)


def _kitti_frame_image(rng, depth_px):
    """A camera image (uint8 RGB) with smooth gradients, noise and the
    projected points brightened, and the points' depth map (uint16, metres
    x 256, 0 where no point projects)."""
    h, w = KITTI_IMAGE_SHAPE
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 0.2) % 256, (y * 0.6) % 256, (x + y) * 0.1 % 256], -1)
    img = img + rng.randint(0, 24, img.shape)
    depth = np.zeros((h, w), np.uint16)
    u, v, d = depth_px
    img[v, u] = 255
    depth[v, u] = np.clip(np.round(d * 256), 1, 65535).astype(np.uint16)
    return img.clip(0, 255).astype(np.uint8), depth


def write_kitti_split(root: str, n_frames: int, seed: int = 0, n_points: int = 20_000,
                      n_cars: int = 8, labels: bool = False, occlude: bool = False) -> list:
    """A synthetic KITTI split under ``root`` in OpenPCDet's layout, for the
    data path: ``training/velodyne/%06d.bin`` (``make_scene``'s cloud, x y z
    and an intensity), ``training/calib/%06d.txt`` (KITTI's P2, R0_rect,
    Tr_velo_to_cam), ``training/image_2`` and ``training/depth_2`` PNGs
    (375 x 1242, written by ``data/png.py``: the first 50 rows cycling
    through the five filters, the rest Up), ``kitti_infos_{train,val}.pkl``
    (the same frames; annos of the cars: camera boxes, image boxes,
    gt_boxes_lidar, num_points_in_gt),
    and a GT database of the frames' cars (``gt_database/*.bin``, points
    about the box centre, and ``kitti_dbinfos_train.pkl``). With ``labels``
    it also writes the raw tree's labels, ``training/label_2/%06d.txt`` from
    the annos (KITTI's 15 fields, the numbers at 9 significant digits), and
    ``ImageSets/{train,val}.txt`` (every frame in each), which
    ``create_infos`` reads. ``occlude`` is ``make_scene``'s. -> the infos."""
    from seevcn_torch.data.png import write_png
    from seevcn_torch.geom import boxes as GB
    from seevcn_torch.geom.calibration import KittiCalibration

    calib = KittiCalibration({"P2": KITTI_P2, "R0": KITTI_R0, "Tr_velo2cam": KITTI_V2C})
    h, w = KITTI_IMAGE_SHAPE
    for sub in ("velodyne", "calib", "image_2", "depth_2"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    os.makedirs(os.path.join(root, "gt_database"), exist_ok=True)
    infos, db = [], {"Car": []}
    filters = [r % 5 if r < 50 else 2 for r in range(h)]
    pad4 = lambda m: np.vstack([m, [0, 0, 0, 1]]) if m.shape[0] == 3 else m   # noqa: E731
    for i in range(n_frames):
        idx = f"{i:06d}"
        rng = np.random.RandomState(seed * 1000 + i)
        scene = make_scene(seed * 1000 + i, n_points, n_cars, occlude=occlude)
        pts = np.concatenate([scene["points"], rng.rand(n_points, 1).astype(np.float32)], 1)
        pts.tofile(os.path.join(root, "training", "velodyne", f"{idx}.bin"))
        with open(os.path.join(root, "training", "calib", f"{idx}.txt"), "w") as f:
            for key, m in (("P0", KITTI_P2), ("P1", KITTI_P2), ("P2", KITTI_P2),
                           ("P3", KITTI_P2), ("R0_rect", KITTI_R0),
                           ("Tr_velo_to_cam", KITTI_V2C), ("Tr_imu_to_velo", KITTI_V2C)):
                f.write(f"{key}: " + " ".join(f"{v:.12e}" for v in m.ravel()) + "\n")
        uv, d = calib.lidar_to_img(pts[:, :3])
        fov = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h) & (d > 0)
        img, depth = _kitti_frame_image(rng, (uv[fov, 0].astype(int), uv[fov, 1].astype(int),
                                              d[fov]))
        write_png(os.path.join(root, "training", "image_2", f"{idx}.png"), img,
                  filters)
        write_png(os.path.join(root, "training", "depth_2", f"{idx}.png"), depth,
                  filters)
        boxes = scene["gt_boxes"][:, :7].astype(np.float64)
        cam = GB.boxes3d_lidar_to_kitti_camera(boxes, calib)
        inside = GB.points_in_boxes(torch.from_numpy(pts[:, :3]),
                                    torch.from_numpy(boxes).float()).numpy()
        n = len(boxes)
        annos = {"name": np.array(["Car"] * n), "truncated": np.zeros(n),
                 "occluded": np.zeros(n, np.int64),
                 "alpha": -np.arctan2(-boxes[:, 1], boxes[:, 0]) + cam[:, 6],
                 "bbox": GB.boxes3d_kitti_camera_to_imageboxes(cam, calib, (h, w)),
                 "dimensions": cam[:, 3:6], "location": cam[:, :3], "rotation_y": cam[:, 6],
                 "score": -np.ones(n), "difficulty": np.zeros(n, np.int64),
                 "index": np.arange(n), "gt_boxes_lidar": boxes,
                 "num_points_in_gt": inside.sum(1)}
        infos.append({"point_cloud": {"num_features": 4, "lidar_idx": idx},
                      "image": {"image_idx": idx, "image_shape": np.array([h, w])},
                      "calib": {"P2": pad4(KITTI_P2), "R0_rect": np.pad(KITTI_R0, (0, 1))
                                + np.diag([0, 0, 0, 1.0]), "Tr_velo_to_cam": pad4(KITTI_V2C)},
                      "annos": annos})
        if labels:
            os.makedirs(os.path.join(root, "training", "label_2"), exist_ok=True)
            with open(os.path.join(root, "training", "label_2", f"{idx}.txt"), "w") as f:
                for j in range(n):
                    h_, w_, l_ = annos["dimensions"][j, [1, 2, 0]]
                    f.write(" ".join(["Car"] + [f"{v:.9g}" for v in (
                        annos["truncated"][j], annos["occluded"][j], annos["alpha"][j],
                        *annos["bbox"][j], h_, w_, l_, *annos["location"][j],
                        annos["rotation_y"][j])]) + "\n")
        for j in range(n):
            path = f"gt_database/{idx}_Car_{j}.bin"
            obj = pts[inside[j]].copy()
            obj[:, :3] -= boxes[j, :3]
            obj.tofile(os.path.join(root, path))
            db["Car"].append({"name": "Car", "path": path, "image_idx": idx, "gt_idx": j,
                              "box3d_lidar": boxes[j], "num_points_in_gt": int(inside[j].sum()),
                              "difficulty": 0, "bbox": annos["bbox"][j], "score": -1.0})
    if labels:
        os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
        for split in ("train", "val"):
            with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
                f.write("".join(f"{i:06d}\n" for i in range(n_frames)))
    for name, obj in (("kitti_infos_train.pkl", infos), ("kitti_infos_val.pkl", infos),
                      ("kitti_dbinfos_train.pkl", db)):
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(obj, f)
    return infos


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


#: phases 14-18's timing depth: the detector's ``detect_stage`` (CUDA events,
#: median of DETECT_REPS), the SEE + detector and fused frames (host clock, one
#: run after the counted runs, which warm them up) and the timed train steps
#: (after a warm-up step); cut from 5 / 3-5 / 3 to pay for phase 25's time
DETECT_REPS, FRAME_REPS, TIMED_STEPS = 3, 1, 1


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn()``, each run between synchronizes."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


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
def check_tiny_seg2d_against_cpu(dev, cfg=None):
    """The tiny Mask R-CNN (``cfg``, by default tiny_seg2d_cfg; weights from
    a seed with random biases and batch-norm statistics, and, where the
    config has deformable convs, offset convs drawn like every other conv)
    with TF32 off, on the card against the port's CPU path (which the tests
    hold against JAX). The RPN outputs, the semantic head's outputs where
    there is one, and the (first) box head's logits and deltas and the mask
    head's logits, each on the card from the CPU's maps and boxes (RoIAlign
    included), so that a difference cannot cascade: within 1e-4 of (their
    scale + |value|), f32 sums in another order. Then the whole forward
    (every cascade stage and mask head): the same number of kept
    detections, their scores within 1e-5, and in every slot whose score
    lies more than 1e-5 from every other slot's the same class, its box
    within 1e-3 px and its mask within 1e-4 (zero-score slots tie, and fill
    in index order). Returns the readings."""
    cfg = cfg or tiny_seg2d_cfg()
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
    if cfg.semantic_branch:
        for k, (c, d) in enumerate(zip(m_c.semantic_head(feats),
                                       m_d.semantic_head([f.to(dev) for f in feats]))):
            _check_close(("semantic_logits", "semantic_feature")[k], d, c, worst)
    rois, valid, _ = SM.proposals(cfg, m_c.anchors, obj[0], box[0])
    strides = cfg.strides[:4]
    maps = m_c.roi_maps(feats, 0)
    maps_d = [m.to(dev) for m in maps]
    cls, deltas = m_c.box_head(SM.roi_align(maps, strides, rois, 7))
    cls_d, deltas_d = m_d.box_head(SM.roi_align(maps_d, strides, rois.to(dev), 7))
    _check_close("cls_logits", cls_d, cls, worst)
    _check_close("box_deltas", deltas_d, deltas, worst)
    boxes, _, _ = SM.decode_detections(cfg, rois, valid, cls, deltas)
    logits = m_c.mask_head(SM.roi_align(maps, strides, boxes, 14))[0]
    logits_d = m_d.mask_head(SM.roi_align(maps_d, strides, boxes.to(dev), 14))[0]
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
    print(f"tiny seg2d ({describe_seg2d(cfg)}), card vs CPU (TF32 off): max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; {n_kept} kept detections, {int(apart.sum())} slots apart compared")
    if n_kept < 1:
        raise AssertionError("tiny seg2d kept no detection")
    return {**worst, "kept": n_kept}


def describe_seg2d(cfg) -> str:
    """The HTC parts a Seg2DConfig turns on, in words."""
    parts = [f"cascade {cfg.cascade_stages}"] if cfg.cascade_stages > 1 else []
    parts += ["semantic branch"] * bool(cfg.semantic_branch)
    parts += ["mask info flow"] * bool(cfg.mask_info_flow and cfg.cascade_stages > 1)
    parts += ["DCN in stages " + ",".join(str(i) for i, d in enumerate(cfg.dcn_stages)
                                          if d)] * any(cfg.dcn_stages)
    return ", ".join(parts) or "plain Mask R-CNN"


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
    busy, per_op = profile_ops(args, fn)
    return busy, sorted(per_op.items(), key=lambda kv: -kv[1])[:6]


def profile_ops(args, fn):
    """One call of ``fn(*args)`` under torch.profiler: (device ms summed over
    its kernels, {PyTorch op or kernel: device ms of its own launches})."""
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
    return busy, per_op


def profile_kernels(args, fn):
    """One call of ``fn(*args)`` under torch.profiler recording the device
    only, read from its raw kernel records: (device ms summed over them,
    the six kernel names, cut to 60 characters, that took most device
    time, as (name, ms)). ``profile_frame``'s aggregation of CPU ops is
    too slow for the many small launches of the detectors of phases 14-18
    (their FPS, NMS and gather loops); this reads the records directly."""
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    busy, per = 0.0, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.duration_ns() / 1e6
        busy += ms
        per[e.name()[:60]] = per.get(e.name()[:60], 0.0) + ms
    return busy, sorted(per.items(), key=lambda kv: -kv[1])[:6]


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


def train_flagship(det_cfg, pts, valid, gt, dev, steps: int = 5):
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


def worst_rel(got, ref, skip=()):
    """(max |got - ref| / max |ref| in f64 (rel_diff), name) over the
    tensors of two gradient dicts, but those named in ``skip``."""
    return max((rel_diff(got[k].double(), ref[k].double()), k)
               for k in ref if k not in skip)


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
        unpinned = worst_rel(g_d, g_c, VCN_BIASES_BEFORE_BN)
        g_pin = tiny_vcn_step(name, tiny, work, dev, pinned=(ch_c, relu_c))[1]
        pinned = worst_rel(g_pin, g_c, VCN_BIASES_BEFORE_BN)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = worst_rel(tiny_vcn_step(name, tiny, work, dev, pinned=(ch_c, relu_c))[1],
                             g_c, VCN_BIASES_BEFORE_BN)
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


def rel_diff(got, ref) -> float:
    """max |got - ref| / max |ref|. A reference of zeros gives 0 where
    ``got`` equals it and inf elsewhere, and a ``got`` that is not finite
    gives inf, so no nan can pass a bound."""
    if not torch.isfinite(got).all():
        return math.inf
    d, s = float((got - ref).abs().max()), float(ref.abs().max())
    if s == 0:
        return 0.0 if d == 0 else math.inf
    return d / s


def tiny_seg2d_step(cfg, sd, batch, roi_u, rpn_u, device, dtype=torch.float32,
                    pinned=None) -> dict:
    """The training forward, loss and backward of the Mask R-CNN at ``cfg``
    from the state dict ``sd`` on ``device`` in ``dtype``, with the draws
    ``roi_u`` / ``rpn_u`` and the ReLUs' signs recorded or, given
    ``pinned``, taken from another run (seg2d_relu_signs). On the CPU a
    config with 8-channel layers (tiny_htc_cfg) runs on one thread
    (``one_cpu_thread``: there oneDNN's multi-threaded convolution backward
    corrupts the heap now and then; ROADMAP §3). -> {terms, sample (each
    cascade stage's too), grads, stats, targets, feats (the first mask
    head's RoI features), signs}, on the CPU."""
    narrow = min(*cfg.stage_channels, cfg.fpn_channels, cfg.mask_channels) <= 8
    with one_cpu_thread() if narrow and torch.device(device).type == "cpu" \
            else contextlib.nullcontext():
        return _tiny_seg2d_step(cfg, sd, batch, roi_u, rpn_u, device, dtype, pinned)


def _tiny_seg2d_step(cfg, sd, batch, roi_u, rpn_u, device, dtype, pinned) -> dict:
    state = TrainState(build_seg2d(cfg, sd, device=device).train().to(dtype), None)
    images, boxes, labels, valid, masks = (torch.from_numpy(x).to(device)
                                           for x in SEG_CLI.pack(batch))
    images, masks = decode_wire(images, masks, packed_masks=True)
    feats = []
    hook = state.model.mask_head.register_forward_pre_hook(
        lambda mod, inputs: feats.append(inputs[0].detach().cpu()))
    try:
        with seg2d_relu_signs(pinned) as signs:
            loss, tb, out = seg2d_train_forward(
                state, images.to(dtype), boxes.to(dtype), labels, valid, masks.to(dtype),
                roi_u=roi_u.to(device, dtype), rpn_u=rpn_u.to(device, dtype))
            loss.backward()
    finally:
        hook.remove()
    n = images.shape[0]
    targets = torch.stack([SM.mask_targets(masks[i].to(dtype), out["rois"][i],
                                           out["roi_matched"][i]) for i in range(n)])
    sample = {k: out[k].detach().cpu() for k in ("rois", "roi_cls_tgt", "roi_fg",
                                                  "roi_matched")}
    for s in range(1, cfg.cascade_stages):
        for k, name in (("rois", "rois"), ("cls_tgt", "roi_cls_tgt"), ("fg", "roi_fg"),
                        ("matched", "roi_matched")):
            sample[f"{name}_s{s}"] = out[f"cascade_s{s}"][k].detach().cpu()
    return {"terms": {"loss": loss.detach().cpu(),
                      **{k: v.detach().cpu() for k, v in tb.items()}},
            "sample": sample,
            "grads": {k: p.grad.cpu() for k, p in state.model.named_parameters()},
            "stats": {k: b.cpu() for k, b in state.model.named_buffers() if "running" in k},
            "targets": targets.cpu(), "feats": feats[0], "signs": signs}


def check_tiny_seg2d_step_against_cpu(dev, cfg=None, roi_px=(1e-4,)):
    """One Mask R-CNN train step at ``cfg`` (tiny_seg2d_cfg by default;
    batch 2 of synthetic scenes, f32, TF32 off) on the card against the
    CPU's step in f64, with the same draws (made on the CPU). Weights: a
    plain model's from init_seg2d seed 0; a cascade's from
    ``seeded_seg2d_weights`` (seed HTC_TINY_SEED: random biases and
    statistics, offset convs drawn), under which every stage's relabelled
    boxes hold foreground, so that each stage's regression and the chain of
    mask heads have a gradient to compare; the CPU's sample must show it.
    The reference is f64 because a cascade carries the CPU's own f32
    rounding of the RPN into every stage's boxes (its f32 loss terms stray
    from its f64 ones by 2.8e-5 where the card's stay within 2.4e-6 of
    them, on an H100 and its host). The RoI sample must be the same, and
    each cascade stage's relabelled boxes (classes, fg, matched equal; the RoIs, proposals
    decoded from the RPN's f32 outputs, and each stage's refinement of the
    last, within ``roi_px[s]`` px at stage s); loss terms within 1e-5
    (relative); batch-norm running statistics within 1e-6 (absolute and
    relative). Both runs record the step's discrete choices that the RoI
    sample does not fix: the ReLUs' signs and the mask targets' pixels (a
    bilinear sample thresholded at 0.5). One within rounding of its switch
    can go the other way on the card and move the gradients by design, as
    in phase 10. So the card's step runs again with its ReLUs' signs pinned
    to the CPU's, and those gradients are held within 5e-4 of each tensor's
    largest; where no choice differs, the unpinned gradients are held to
    the same bound. Printed beside: the unpinned gradients, the CPU's own
    f32 gradients against its f64 ones, the mask head's RoI features, and
    the pinned step with TF32 on, the size of error that the bound is there
    to catch. Returns the readings."""
    cfg = cfg or tiny_seg2d_cfg()
    if cfg.cascade_stages > 1:
        sd = seeded_seg2d_weights(cfg, seed=HTC_TINY_SEED)
    else:
        sd = init_seg2d(SM.MaskRCNN(cfg), torch.Generator().manual_seed(0)).state_dict()
    batch = SEG_SYN.synth_batch(np.random.RandomState(0), cfg.image_size, 2,
                                max_gt=cfg.max_gt)
    gen = torch.Generator().manual_seed(1)
    n_anchor = SM.MaskRCNN(cfg).anchors.shape[0]
    roi_u = torch.rand((2, 2, cfg.num_proposals + cfg.max_gt), generator=gen)
    rpn_u = torch.rand((2, 2, n_anchor), generator=gen)
    cpu = torch.device("cpu")
    c = tiny_seg2d_step(cfg, sd, batch, roi_u, rpn_u, cpu, dtype=torch.float64)
    d = tiny_seg2d_step(cfg, sd, batch, roi_u, rpn_u, dev)
    for k in c["sample"]:
        if not k.startswith("rois") and not torch.equal(d["sample"][k], c["sample"][k]):
            raise AssertionError(f"tiny seg2d step: the RoI sample's {k} differs from the CPU")
    worst = {k: float((d["sample"][k] - c["sample"][k]).abs().max())
             for k in c["sample"] if k.startswith("rois")}
    for k, v in worst.items():
        if not v <= roi_px[0 if k == "rois" else int(k[-1])]:
            raise AssertionError(f"tiny seg2d step: {k} off the CPU by {v}")
    worst["loss terms"] = max(rel_diff(d["terms"][k], c["terms"][k]) for k in c["terms"])
    if not worst["loss terms"] <= 1e-5:
        raise AssertionError(f"tiny seg2d step: loss terms off by {worst['loss terms']}")
    worst["running statistics"] = max(float((d["stats"][k] - c["stats"][k]).abs().max())
                                      for k in c["stats"])
    for k in c["stats"]:
        if not ((d["stats"][k] - c["stats"][k]).abs() <= 1e-6 + 1e-6 * c["stats"][k].abs()).all():
            raise AssertionError(f"tiny seg2d step: running statistic {k} off the CPU")
    n_fg = [int(c["sample"]["roi_fg"].sum())] + [
        int(c["sample"][f"roi_fg_s{s}"].sum()) for s in range(1, cfg.cascade_stages)]
    if min(n_fg) < 1:
        raise AssertionError(f"tiny seg2d step: a stage's RoIs hold no foreground: {n_fg}")
    # the ReLUs in call order: stem, two a residual block, the RPN's conv on
    # each level, the box head's two, the mask head's convs and its ``up``
    flips = {i: int((a != b).sum()) for i, (a, b) in enumerate(zip(d["signs"], c["signs"]))
             if not torch.equal(a, b)}
    worst["relu_sign_flips"] = flips
    worst["relu_sites"] = len(c["signs"])
    worst["mask_target_flips"] = int((d["targets"] != c["targets"]).sum())
    worst["mask_head_features"] = rel_diff(d["feats"], c["feats"])
    worst["gradients_unpinned"] = worst_rel(d["grads"], c["grads"])
    pinned = tiny_seg2d_step(cfg, sd, batch, roi_u, rpn_u, dev, pinned=c["signs"])
    worst["gradients_pinned"] = worst_rel(pinned["grads"], c["grads"])
    c32 = tiny_seg2d_step(cfg, sd, batch, roi_u, rpn_u, cpu)
    worst["cpu_f32_vs_cpu_f64"] = worst_rel(c32["grads"], c["grads"])
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = tiny_seg2d_step(cfg, sd, batch, roi_u, rpn_u, dev, pinned=c["signs"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    worst["gradients_pinned_tf32"] = worst_rel(tf32["grads"], c["grads"])
    print(f"tiny seg2d train step ({describe_seg2d(cfg)}), card (f32, TF32 off) vs CPU "
          f"(f64), the same draws: the same RoI sample and stage labels ("
          + ", ".join(map(str, n_fg)) + f" foreground of {c['sample']['roi_fg'].numel()}"
          + (f" at stages 0-{len(n_fg) - 1}" if len(n_fg) > 1 else "") + "), max |diff| rois "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items() if k.startswith("rois"))
          + f" px, loss terms {worst['loss terms']:.3g} (relative), "
          f"running statistics {worst['running statistics']:.3g}, the mask head's RoI "
          f"features {worst['mask_head_features']:.3g} of their largest; choices that "
          f"differ: ReLU signs {flips} (site: count, of {len(c['signs'])} sites), "
          f"{worst['mask_target_flips']} of {c['targets'].numel()} mask-target pixels; "
          f"gradients {worst['gradients_unpinned'][0]:.3g} of a tensor's largest "
          f"({worst['gradients_unpinned'][1]}); with the ReLUs' signs pinned to the "
          f"CPU's {worst['gradients_pinned'][0]:.3g} ({worst['gradients_pinned'][1]}; "
          f"bound 5e-4), and with TF32 on as well {worst['gradients_pinned_tf32'][0]:.3g} "
          f"({worst['gradients_pinned_tf32'][1]}); the CPU's own f32 gradients, unpinned, "
          f"{worst['cpu_f32_vs_cpu_f64'][0]:.3g} ({worst['cpu_f32_vs_cpu_f64'][1]}); "
          f"loss {float(c['terms']['loss']):.5f}")
    if not worst["gradients_pinned"][0] <= 5e-4:
        raise AssertionError(f"tiny seg2d step: with the ReLUs pinned, gradient "
                             f"{worst['gradients_pinned'][1]} off by "
                             f"{worst['gradients_pinned'][0]} of its largest")
    if not flips and not worst["mask_target_flips"] \
            and not worst["gradients_unpinned"][0] <= 5e-4:
        raise AssertionError(f"tiny seg2d step: no choice differs and gradient "
                             f"{worst['gradients_unpinned'][1]} is off by "
                             f"{worst['gradients_unpinned'][0]} of its largest")
    return {**worst, "foreground": n_fg}


def seg2d_step_flops(cfg, batch: int) -> dict:
    """Forward FLOPs of one Mask R-CNN train step at ``cfg`` and ``batch``,
    by part (backbone + FPN, RPN head on every level, the box heads and the
    mask heads on the sampled RoIs: every cascade stage's box head, and
    under info flow stage s's chain of s + 1 mask heads; the semantic head),
    counted by torch.utils.flop_counter on the meta device: shapes only,
    nothing computed. A multiply-add is 2."""
    from torch.utils.flop_counter import FlopCounterMode

    h, w = cfg.image_size
    with torch.device("meta"):
        model = SM.MaskRCNN(cfg)
        parts = {}
        with FlopCounterMode(display=False) as fc:
            feats = model.backbone(torch.zeros(batch, 3, h, w))
        parts["backbone_fpn"] = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            for f in feats:
                model.rpn(f)
        parts["rpn_head"] = fc.get_total_flops()
        r = batch * cfg.roi_batch
        with FlopCounterMode(display=False) as fc:
            for head in model.box_heads:
                head(torch.zeros(r, 7, 7, cfg.fpn_channels))
        parts["box_head"] = fc.get_total_flops()
        with FlopCounterMode(display=False) as fc:
            for s in range(model.n_mask):
                model._mask_chain(torch.zeros(r, 14, 14, cfg.fpn_channels), s)
        parts["mask_head"] = fc.get_total_flops()
        if cfg.semantic_branch:
            with FlopCounterMode(display=False) as fc:
                model.semantic_head(feats)
            parts["semantic_head"] = fc.get_total_flops()
    return parts


def time_train_scan(state, images, dev):
    """The train step's proposal pass on image 0 of ``images`` (its RPN
    outputs at the trained weights): host clock to a synchronize of the whole
    pass and of its greedy scan alone (median of 5), and CUDA events of the
    scan."""
    cfg, model = state.model.cfg, state.model
    with torch.no_grad():
        _, obj, box = model.features(images[:1])
    obj, box = obj[0], box[0]
    top, order = torch.sort(obj, descending=True, stable=True)
    k = cfg.pre_nms_topk
    props = SM.decode_deltas(box[order[:k]], model.anchors[order[:k]], cfg.image_size)
    iou = boxes_iou_normal(props, props)
    ok = torch.isfinite(top[:k])

    def host(fn):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    scan = lambda: NMS._greedy_suppress(iou, ok, cfg.proposal_nms_thresh)  # noqa: E731
    return {"k": k, "pass_host_ms": host(lambda: SM.proposals(cfg, model.anchors, obj, box)),
            "scan_host_ms": host(scan), "scan_cuda_ms": time_cuda(scan, reps=5)}


def heads_without_foreground(cfg, terms: dict) -> tuple:
    """The parameter-name prefixes that a train step with the loss terms
    ``terms`` leaves without a gradient by design: for each cascade stage s
    >= 1 whose regression and mask losses read exactly 0 (no RoI reached
    its IoU, 0.7 at stage 2, from random weights), its regression layer
    and its mask head. Empty for a model without a cascade."""
    out = ()
    for s in range(1, cfg.cascade_stages):
        if float(terms[f"box_reg_s{s}"]) == 0 and float(terms.get(f"mask_s{s}", 0)) == 0:
            out += (f"box_head_s{s}.box.", f"mask_head_s{s}.")
    return out


def check_moved(model, start: dict, excused: tuple, what: str) -> list:
    """Raise unless every parameter of ``model`` differs from ``start``, but
    those named under an ``excused`` prefix whose gradient is all zero.
    -> the names of those."""
    still = [n for n, p in model.named_parameters() if torch.equal(p, start[n])]
    idle = [n for n in still
            if n.startswith(excused) and not model.get_parameter(n).grad.any()]
    if set(still) - set(idle):
        raise AssertionError(f"{what}: parameters did not move: "
                             f"{sorted(set(still) - set(idle))[:5]}")
    return idle


def train_seg2d(dev, card, steps: int = 5, flags=(), tiny_cfg=None, cli_steps: int = 2,
                roi_px=(1e-4,), eval_scenes: int = 4):
    """Mask R-CNN training at the CLI's defaults (``--size base``, 384x512,
    batch 8, AdamW lr 1e-3 with the warm-up of 200 over 2,000 steps,
    synthetic scenes from seed 0, the packed wire format) and the CLI
    ``flags`` (HTC's, for phase 13): the tiny step at ``tiny_cfg`` against
    the CPU's f64 step (its RoIs within ``roi_px``); a warm-up
    step (lr 0: no weight moves) and ``steps`` timed ones through
    ``make_seg2d_train_step`` (host clock to a synchronize), then one split
    by CUDA events into forward, loss and backward + update, one under
    torch.profiler, the proposal pass's greedy scan timed alone; then
    ``evaluate`` on ``eval_scenes`` held-out scenes, the checkpoint saved
    and reloaded, its eval forward equal bit for bit, and the CLI's
    ``main`` with the flags cut to ``cli_steps`` steps. Raises unless every
    loss is finite and every parameter has moved after the second step, but
    the heads of a cascade stage that had no foreground in it
    (``heads_without_foreground``). Returns the summary dict."""
    tiny = check_tiny_seg2d_step_against_cpu(dev, tiny_cfg, roi_px)
    args = SEG_CLI.parse_args(list(flags))
    cfg = SEG_CLI.build_cfg(args)
    stream = SEG_CLI.synthetic_stream(cfg, args.batch_size, args.seed)
    t0 = time.perf_counter()
    host_batches = [next(stream) for _ in range(steps + 3)]
    gen_ms = (time.perf_counter() - t0) * 1e3 / len(host_batches)
    t0 = time.perf_counter()
    wires = [SEG_CLI.pack(b) for b in host_batches]
    pack_ms = (time.perf_counter() - t0) * 1e3 / len(wires)
    model = init_seg2d(SM.MaskRCNN(cfg), torch.Generator().manual_seed(0)).to(dev).train()
    state = TrainState(model, build_seg2d_optimizer(
        model.parameters(), args.lr, args.weight_decay, args.warmup_steps,
        max(args.steps, args.warmup_steps + 1)))
    step = make_seg2d_train_step(packed_masks=True)
    n_gt = int(sum(b[3].sum() for b in host_batches[:steps + 1]))
    flops = seg2d_step_flops(cfg, args.batch_size)
    # forward and backward: the backward of a conv or a product is two
    # products of the forward's size (the input's and the weight's gradient)
    fwd = sum(flops.values())
    flop_ms = 3 * fwd / FP32_FLOPS * 1e3

    def upload(w):
        return [torch.from_numpy(x).to(dev) for x in w]

    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(state, *upload(wires[0]), args.seed)]
    torch.cuda.synchronize()
    moved0 = [n for n, p in model.named_parameters() if not torch.equal(p, start[n])]
    if moved0:
        raise AssertionError(f"step 0 (lr 0) moved {moved0[:3]}")
    times = []
    for k in range(1, steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(state, *upload(wires[k]), args.seed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if k == 1:
            idle = check_moved(model, start, heads_without_foreground(cfg, losses[k]),
                               "seg2d train step 1")
    peak = torch.cuda.max_memory_allocated() / 2**30
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"a seg2d loss term is not finite: {values}")
    step_ms = statistics.median(times)

    # one step split by CUDA events
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    images, boxes, labels, valid, masks = upload(wires[steps + 1])
    torch.cuda.synchronize()
    ev[0].record()
    images, masks = decode_wire(images, masks, packed_masks=True)
    gen = step_generator(args.seed, state.step, dev)
    out = model(images, boxes, labels, valid, masks, train=True, generator=gen)
    ev[1].record()
    loss, _ = model.loss(out, boxes, labels, valid, masks, gen)
    ev[2].record()
    apply_gradients(state, loss)
    ev[3].record()
    torch.cuda.synchronize()
    split = {k: ev[i].elapsed_time(ev[i + 1])
             for i, k in enumerate(("forward", "loss", "backward_update"))}
    scan = time_train_scan(state, images, dev)

    # the wire format against the batch as the generator makes it (f32
    # images and masks): pack on the host, upload and unpack on the card,
    # against the plain upload, alternating over the same batches
    def timed(fn, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def wire(b):
        w = upload(SEG_CLI.pack(b))
        return decode_wire(w[0], w[4], packed_masks=True)

    wire_ms = {"plain_upload": [], "pack_upload_decode": []}
    for b in host_batches[:steps]:
        wire_ms["plain_upload"].append(timed(upload, b))
        wire_ms["pack_upload_decode"].append(timed(wire, b))
    wire_ms = {k: statistics.median(v) for k, v in wire_ms.items()}
    plain_mib = sum(x.nbytes for x in host_batches[0]) / 2**20
    wire_mib = sum(x.nbytes for x in wires[0]) / 2**20
    busy, top = profile_frame((state, *upload(wires[steps + 2]), args.seed), step)
    n_fg = int(out["roi_fg"].sum())

    # held-out evaluation, then the checkpoint saved, reloaded and run
    t0 = time.perf_counter()
    ev_keys = SEG_CLI.evaluate(model, cfg, eval_scenes, args.seed)
    eval_s = time.perf_counter() - t0
    if set(ev_keys) != {"mask_AP50", "mask_AP", "box_AP50", "box_AP", "mask_AP50_far",
                        "mask_AP50_near"} or not all(math.isfinite(v) for v in ev_keys.values()):
        raise AssertionError(f"bad seg2d evaluation: {ev_keys}")
    image = torch.from_numpy(SEG_SYN.synth_scene(*cfg.image_size, np.random.RandomState(1),
                                                 max_gt=cfg.max_gt)[0][None]).to(dev)
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "seg2d.ckpt")
        save_seg2d_checkpoint(path, model, cfg)
        ckpt_mb = os.path.getsize(path) / 2**20
        loaded_cfg, sd = load_seg2d_checkpoint(path)
    reloaded = build_seg2d(loaded_cfg, sd, device=dev)
    trained = model.state_dict()
    if any(not torch.equal(sd[k].to(dev), v) for k, v in trained.items()
           if not k.endswith("num_batches_tracked")):
        raise AssertionError("the reloaded Mask R-CNN's weights differ from the trained ones")
    model.eval()
    with torch.no_grad():
        a, b = model(image), reloaded(image)
    model.train()
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("the reloaded Mask R-CNN's eval forward differs")

    # the CLI itself at its defaults, cut to ``cli_steps`` steps and 1 eval
    # scene: an eval point and its checkpoint after step 2, the last
    # checkpoint, and main's JSON line
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "cli.ckpt")
        t0 = time.perf_counter()
        cli_args = ["--steps", str(cli_steps), "--eval_every", "2", "--eval_scenes", "1",
                    "--out", path, "--log_every", "1", *flags]
        cli_eval = SEG_CLI.main(cli_args)
        cli_s = time.perf_counter() - t0
        cli_cfg, cli_sd = load_seg2d_checkpoint(path)
    if cli_cfg != cfg or set(cli_sd) != set(trained) or set(cli_eval) != set(ev_keys):
        raise AssertionError("the seg2d CLI's checkpoint or evaluation is not the recipe's")
    print(f"python -m seevcn_torch.cli.train_seg2d {' '.join(cli_args).replace(path, '<ckpt>')} "
          f"(the other flags at their defaults) ran in {cli_s:.1f} s on {card}")
    summary = {
        "step_ms": step_ms, "images_per_s": args.batch_size * 1e3 / step_ms,
        "step_ms_all": times, "split_ms": split, "scan": scan,
        "scan_share": args.batch_size * scan["scan_host_ms"] / step_ms,
        "device_busy_ms": busy, "top_ops": top, "peak_gib": peak,
        "losses": [m["loss"] for m in values], "last_terms": values[-1],
        "eval": ev_keys, "eval_s": eval_s, "batch_gen_ms": gen_ms, "pack_ms": pack_ms,
        "wire_ms": wire_ms, "plain_batch_mib": plain_mib, "wire_batch_mib": wire_mib,
        "gt_per_image": n_gt / ((steps + 1) * args.batch_size), "split_step_fg": n_fg,
        "ckpt_mib": ckpt_mb, "forward_gflop": {k: v / 1e9 for k, v in flops.items()},
        "step_flop_bound_ms": flop_ms, "cli_s": cli_s, "tiny_vs_cpu": tiny,
        "config": describe_seg2d(cfg), "no_gradient_after_step_1": idle}
    h, w = cfg.image_size
    print(f"seg2d train steps ({args.size}, {describe_seg2d(cfg)}, {h}x{w}, batch "
          f"{args.batch_size}, synthetic "
          f"scenes, AdamW warm-up {args.warmup_steps} of {args.steps}): losses "
          + ", ".join(f"{v['loss']:.4f}" for v in values)
          + "; last terms " + ", ".join(f"{k} {v:.4f}" for k, v in values[-1].items())
          + f"; every parameter moved after step 1 but {len(idle)} of heads whose stage "
          f"had no foreground yet {idle}")
    print(f"seg2d train step {step_ms:.2f} ms (host clock to a synchronize, median of "
          f"{steps}) = {summary['images_per_s']:.2f} images/s; CUDA events: forward "
          f"{split['forward']:.2f} ms, loss {split['loss']:.2f} ms, backward + update "
          f"{split['backward_update']:.2f} ms; proposal pass (K={scan['k']}) "
          f"{scan['pass_host_ms']:.2f} ms host clock, its greedy scan "
          f"{scan['scan_host_ms']:.2f} ms host clock ({scan['scan_cuda_ms']:.2f} ms CUDA "
          f"events), {args.batch_size} a step = {summary['scan_share']:.3f} of the step; "
          f"peak device "
          f"memory {peak:.2f} GiB; profiled step: device busy {busy:.2f} ms; device time "
          f"by op: " + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + f" on {card}")
    print(f"seg2d step FLOPs (flop_counter, meta device): forward "
          + ", ".join(f"{k} {v / 1e9:.1f}" for k, v in flops.items())
          + f" GFLOP = {fwd / 1e9:.1f}; forward + backward {3 * fwd / 1e12:.2f} TFLOP, "
          f"{flop_ms:.1f} ms at the f32 peak of {FP32_FLOPS / 1e12:.0f} TFLOP/s")
    print(f"seg2d data: {gen_ms:.1f} ms a batch of {args.batch_size} scenes to generate "
          f"(host), {pack_ms:.1f} ms to pack; {summary['gt_per_image']:.2f} cars an image; "
          f"{n_fg} foreground RoIs of {out['roi_fg'].numel()} in the split step")
    print(f"seg2d wire format (median of {steps} batches, host clock to a synchronize): "
          f"the plain f32 batch ({plain_mib:.1f} MiB) uploads in "
          f"{wire_ms['plain_upload']:.2f} ms; packed ({wire_mib:.1f} MiB), pack + upload "
          f"+ unpack take {wire_ms['pack_upload_decode']:.2f} ms on {card}")
    print(f"seg2d evaluation over {eval_scenes} held-out scenes in {eval_s:.2f} s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ev_keys.items())
          + f"; checkpoint ({ckpt_mb:.1f} MiB) reloaded bit for bit, its eval forward "
          "equal to the trained net's")
    return summary


# ---------------------------------------------------------------------------
# HTC: serving (phase 12) and training (phase 13)
# ---------------------------------------------------------------------------
HTC_FLAGS = ("--cascade", "3", "--semantic", "--mask_info_flow")
# the tiny HTC step's RoIs, card vs the CPU's f64 step, px at stages 0-2:
# the RPN's f32 deltas at 8 channels put the proposals 2.1e-4 px off and
# each refinement widens the gap (2.9e-4, 4.3e-4 px on an H100)
HTC_ROI_PX = (1e-3, 3e-3, 1e-2)
# seeded_seg2d_weights' seed for the tiny HTC step: foreground at every stage
HTC_TINY_SEED = 2
DCN_STAGES = (False, True, True, True)          # the reference HTC's dconv_c3-c5


def htc_bench_cfg():
    """Full HTC at bench.py's mask config (Seg2DConfig(image_size=(384,
    1280), max_detections=32) at the base widths): the 3-stage cascade, the
    semantic branch, mask info flow and deformable stages 1-3."""
    return SM.Seg2DConfig(image_size=IMAGE_SIZE, max_detections=32, cascade_stages=3,
                          semantic_branch=True, mask_info_flow=True, dcn_stages=DCN_STAGES)


def gather_scatter_ops(per_op: dict) -> dict:
    """The gathers and scatters of a profile: the ops whose name holds
    ``index``, ``gather`` or ``scatter``. On the card DCN's corner reads
    (``index_select``) show as ``aten::gather`` and their backward as
    ``aten::index_add_``, as one DCN layer profiled alone shows
    (``time_dcn_layers``); RoIAlign's gathers are ``aten::index`` and
    their backward ``aten::_index_put_impl_``."""
    return {k: v for k, v in per_op.items()
            if any(w in k for w in ("index", "gather", "scatter"))}


def time_dcn_layers(model, batch: int, image_size, dev) -> list:
    """Each deformable conv of ``model`` (its weights and offset convs) on a
    random input of the shape the model gives it at ``image_size`` and
    ``batch``: CUDA-event ms (median of 5) of the layer's forward and of
    its forward + backward (the input's and every parameter's gradient),
    beside two floors: the bytes of its im2col tensor (B Ho Wo K Cin f32)
    written and read once plus the four corner gathers that fill it, over
    3.35 TB/s; and its GEMM (2 B Ho Wo K Cin Cout) at the f32 peak. The
    first layer's forward + backward is profiled alone as well: its device
    time by op, which names the ops of DCN's gathers and scatter."""
    h, w = image_size
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, m in model.named_modules():
        if not isinstance(m, DeformConv2d):
            continue
        stride = 4 * 2 ** int(name.split("stage")[1].split("_")[0])
        cout, cin, kh, kw = m.weight.shape
        ho, wo = -(-h // stride), -(-w // stride)
        x = torch.randn(batch, cin, ho, wo, device=dev, generator=gen)
        g = torch.randn(batch, cout, ho, wo, device=dev, generator=gen)
        with torch.no_grad():
            fwd = time_cuda(lambda: m(x), reps=5)
        x.requires_grad_()
        params = [x, *m.parameters()]
        both = time_cuda(lambda: torch.autograd.grad(m(x), params, g), reps=5)
        im2col = batch * ho * wo * kh * kw * cin * 4
        rows.append({"layer": name.split(".", 1)[-1], "shape": [batch, cin, ho, wo],
                     "forward_ms": fwd, "forward_backward_ms": both,
                     "bytes_bound_ms": 6 * im2col / HBM_BYTES_PER_S * 1e3,
                     "gemm_ms_at_peak": 2 * im2col / 4 * cout / FP32_FLOPS * 1e3})
        if len(rows) == 1:
            _, ops = profile_ops((), lambda: torch.autograd.grad(m(x), params, g))
            rows[0]["ops_forward_backward_ms"] = dict(sorted(ops.items(),
                                                             key=lambda kv: -kv[1]))
    return rows


def print_dcn_rows(label, rows, card):
    print(f"DCN layers at {label} (CUDA events, median of 5; bound: the im2col tensor "
          f"written and read plus its four corner reads at 3.35 TB/s; the GEMM at 67 "
          f"TFLOP/s) on {card}: " + "; ".join(
              f"{r['layer']} {tuple(r['shape'])}: forward {r['forward_ms']:.3f} ms, forward "
              f"+ backward {r['forward_backward_ms']:.3f} ms, bound {r['bytes_bound_ms']:.3f} "
              f"ms, GEMM {r['gemm_ms_at_peak']:.3f} ms" for r in rows))
    print(f"DCN layer {rows[0]['layer']} {tuple(rows[0]['shape'])} alone, forward + "
          f"backward profiled, device time by op: " + "; ".join(
              f"{n} {t:.3f} ms" for n, t in rows[0]["ops_forward_backward_ms"].items()))


def serve_htc(dev, card, s, vcn, det, det_cfg, proj, l2c, image) -> dict:
    """Phase 12: the tiny full HTC (deformable stages, offset convs drawn
    from the seed) on the card against the CPU; full HTC at bench.py's
    config (384x1280, 32 detections, weights from seed 0, offset convs
    drawn like every other conv) through ``mask_stage``: its outputs
    checked, CUDA-event ms (median of 5), peak memory, one profiled stage
    (device busy, top ops, DCN's gathers); ``run_frame`` with it on the
    SEE scene (K1 counted in its replace stage; host clock, median of 5);
    ``MaskRCNNBackend`` on its checkpoint and a 375x1242 BGR image (KITTI's
    size); each DCN layer timed at 384x1280 and at 384x512 batch 8."""
    tiny = check_tiny_seg2d_against_cpu(dev, tiny_htc_cfg(dcn=True))
    cfg = htc_bench_cfg()
    htc = build_seg2d(cfg, seeded_state_dict(0, build_seg2d(cfg, device="cpu")), device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    boxes, masks, scores = F.mask_stage(htc, image)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if boxes.shape != (32, 4) or masks.shape != (32, 28, 28) or scores.shape != (32,):
        raise AssertionError("the HTC mask stage did not return 32 slots")
    if not all(torch.isfinite(t).all() for t in (boxes, masks, scores)) or \
            masks.min() < 0 or masks.max() > 1 or not (scores > 0).any():
        raise AssertionError("the HTC mask stage's outputs are not finite probabilities")
    stage_ms = time_cuda(lambda: F.mask_stage(htc, image), reps=5)
    busy, per_op = profile_ops((htc, image), F.mask_stage)
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:6]

    K.reset_launches()
    pp, st, pts, valid = F.run_frame(image, s["points"], s["valid"], htc, vcn, det, det_cfg,
                                     proj, l2c)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if launches["min_sqdist_pruned"] < 1:
        raise AssertionError("kernel K1 was not launched inside run_frame with HTC masks")
    kept = pp["pred_mask"][0]
    for t in (st["det_boxes"], st["det_masks"], st["det_scores"], pts,
              pp["pred_boxes"][0][kept], pp["pred_scores"][0][kept]):
        if not torch.isfinite(t).all():
            raise AssertionError("the fused frame with HTC masks gave a value not finite")
    frame = {"ms": host_ms(lambda: F.run_frame(image, s["points"], s["valid"], htc, vcn, det,
                                                det_cfg, proj, l2c)),
             "launches": launches, "scored": int((st["det_scores"] > 0).sum()),
             "isolated": int(st["ok"].sum()), "spliced": int(st["inst_valid"].sum()),
             "kept": int(kept.sum())}

    bgr = (np.random.RandomState(2).rand(375, 1242, 3) * 255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "htc.ckpt")
        save_seg2d_checkpoint(path, htc, cfg)
        backend = MaskRCNNBackend(path, score_thresh=0.05, device=dev)
    dets = backend(bgr)
    if not dets or any(d["mask"].shape != (375, 1242) or d["mask"].dtype != bool
                       or not np.isfinite(d["bbox"]).all() for d in dets):
        raise AssertionError("MaskRCNNBackend gave no detection or a malformed one")
    backend_ms = host_ms(lambda: backend(bgr))

    dcn_serve = time_dcn_layers(htc, 1, IMAGE_SIZE, dev)
    dcn_train = time_dcn_layers(htc, 8, (384, 512), dev)
    print(f"HTC mask stage ({describe_seg2d(cfg)}, {IMAGE_SIZE[0]}x{IMAGE_SIZE[1]}, 32 "
          f"detections): {stage_ms:.2f} ms (CUDA events, median of 5), peak device memory "
          f"{peak:.2f} GiB ({peak - held / 2**30:.2f} GiB above what was held); profiled: "
          f"device busy {busy:.2f} ms; device time by op: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + "; gathers and scatters: "
          + ", ".join(f"{n} {t:.2f} ms" for n, t in gather_scatter_ops(per_op).items())
          + f" on {card}")
    print(f"fused frame with HTC masks: {frame['ms']:.2f} ms (host clock, median of 5), "
          f"launches {launches}, {frame['scored']}/32 slots scored, {frame['isolated']} "
          f"isolated, {frame['spliced']} spliced, {frame['kept']} boxes kept")
    print(f"MaskRCNNBackend (HTC checkpoint, score >= 0.05) on a 375x1242 BGR image: "
          f"{backend_ms:.2f} ms (host clock, median of 5), {len(dets)} detections")
    print_dcn_rows("384x1280, batch 1", dcn_serve, card)
    print_dcn_rows("384x512, batch 8", dcn_train, card)
    return {"config": describe_seg2d(cfg), "tiny_vs_cpu": tiny, "mask_stage_ms": stage_ms,
            "peak_gib": peak, "device_busy_ms": busy, "top_ops": top,
            "gather_scatter_ms": gather_scatter_ops(per_op), "fused_frame": frame,
            "backend_ms": backend_ms,
            "backend_detections": len(dets), "dcn_layers_serve": dcn_serve,
            "dcn_layers_train": dcn_train}


def train_dcn_step(dev, card) -> dict:
    """Phase 13's DCN step: full HTC with deformable stages 1-3 at the CLI's
    base widths (384x512, batch 8, init_seg2d seed 0: the offset convs at
    zero) through ``make_seg2d_train_step``, as the CLI has no DCN flag:
    step 0 (lr 0: nothing moves), step 1 timed (host clock) after which
    every parameter, the offset convs included, must have moved, but the
    heads of a cascade stage with no foreground yet
    (``heads_without_foreground``), step 2 profiled (device busy, DCN's
    gathers and their scatter-add); losses finite; the checkpoint saved,
    reloaded bit for bit, its eval forward equal."""
    args = SEG_CLI.parse_args(list(HTC_FLAGS))
    cfg = dataclasses.replace(SEG_CLI.build_cfg(args), dcn_stages=DCN_STAGES)
    model = init_seg2d(SM.MaskRCNN(cfg), torch.Generator().manual_seed(0)).to(dev).train()
    state = TrainState(model, build_seg2d_optimizer(
        model.parameters(), args.lr, args.weight_decay, args.warmup_steps,
        max(args.steps, args.warmup_steps + 1)))
    step = make_seg2d_train_step(packed_masks=True)
    stream = SEG_CLI.synthetic_stream(cfg, args.batch_size, args.seed + 1)
    wires = [SEG_CLI.pack(next(stream)) for _ in range(3)]

    def upload(w):
        return [torch.from_numpy(x).to(dev) for x in w]

    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = [step(state, *upload(wires[0]), args.seed)]
    batch1 = upload(wires[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics.append(step(state, *batch1, args.seed))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    idle = check_moved(model, start, heads_without_foreground(cfg, metrics[1]),
                       "DCN step 1")
    offsets = [n for n in start if "offset_conv" in n]
    busy, per_op = profile_ops((state, *upload(wires[2]), args.seed), step)
    peak = torch.cuda.max_memory_allocated() / 2**30
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"a DCN step's loss term is not finite: {values}")
    image = torch.from_numpy(SEG_SYN.synth_scene(*cfg.image_size, np.random.RandomState(1),
                                                 max_gt=cfg.max_gt)[0][None]).to(dev)
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "dcn.ckpt")
        save_seg2d_checkpoint(path, model, cfg)
        loaded_cfg, sd = load_seg2d_checkpoint(path)
    if loaded_cfg != cfg or any(not torch.equal(sd[k].to(dev), v) for k, v in
                                model.state_dict().items()
                                if not k.endswith("num_batches_tracked")):
        raise AssertionError("the reloaded HTC + DCN checkpoint differs from the trained net")
    reloaded = build_seg2d(loaded_cfg, sd, device=dev)
    model.eval()
    with torch.no_grad():
        a, b = model(image), reloaded(image)
    model.train()
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("the reloaded HTC + DCN net's eval forward differs")
    h, w = cfg.image_size
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:6]
    print(f"HTC + DCN train step ({describe_seg2d(cfg)}, {args.size}, {h}x{w}, batch "
          f"{args.batch_size}, through make_seg2d_train_step): step 1 {step_ms:.2f} ms "
          f"(host clock); every parameter moved, the {len(offsets)} offset-conv tensors "
          f"among them, but {len(idle)} of heads whose stage had no foreground yet; "
          f"losses "
          + ", ".join(f"{m['loss']:.4f}" for m in values)
          + f"; peak device memory {peak:.2f} GiB; profiled step: device busy {busy:.2f} "
          f"ms; device time by op: " + "; ".join(f"{n} {t:.2f} ms" for n, t in top)
          + "; gathers and scatters: "
          + ", ".join(f"{n} {t:.2f} ms" for n, t in gather_scatter_ops(per_op).items())
          + f"; checkpoint reloaded bit for bit, its eval forward equal, on {card}")
    return {"step_ms": step_ms, "device_busy_ms": busy,
            "gather_scatter_ms": gather_scatter_ops(per_op),
            "top_ops": top, "peak_gib": peak, "losses": [m["loss"] for m in values],
            "last_terms": values[-1], "no_gradient_after_step_1": idle}


# --------------------------------------------------------------------------
# PV-RCNN: serving and training (phase 14)

def pvrcnn_train_inputs(cfg, sd, relative: bool = False):
    """tiny_train_inputs' two blob frames and ground truth, plus in each
    frame a car near two of the training proposals of the PV-RCNN at
    ``cfg`` with state dict ``sd`` (shifted 0.25 m and 0.15 m, turned 0.08
    rad: an IoU well above REG_FG_THRESH, clear of the rotated IoU's
    degenerate case of coincident edges; with ``relative``, shifted 6% of
    the proposal's length and width and of the proposal's class, so that a
    pedestrian-sized proposal keeps that IoU too), so that its RoI sample
    has foreground. -> numpy (points, valid, gt_boxes)."""
    pts, valid, gt, _ = (t.numpy() for t in tiny_train_inputs("cpu"))
    model, _ = build_detector(cfg, sd, device="cpu")
    model.train()
    with torch.no_grad():
        props = model.rpn(torch.from_numpy(pts), torch.from_numpy(valid))["props"]
    rois = props["rois"][:, :2, :7].numpy()
    shift = np.zeros_like(rois) + np.float32([0.25, 0.15, 0, 0, 0, 0, 0.08])
    gt[:, 2:4, 7] = 1.0
    if relative:
        shift[..., :2] = 0.06 * rois[..., 3:5]
        gt[:, 2:4, 7] = props["roi_labels"][:, :2].numpy()
    gt[:, 2:4, :7] = rois + shift
    return pts, valid, gt


def _worst(got: dict, ref: dict, scale) -> tuple:
    """(max over tensors of |got - ref| / scale(ref), its name)."""
    return max(((got[k].double() - ref[k].double()).abs().max().item()
                / scale(ref[k].double()), k) for k in ref)


@torch.no_grad()
def check_tiny_pvrcnn_against_cpu(dev, cfg=None, label: str = "PV-RCNN") -> dict:
    """``cfg`` (tiny_pvrcnn_cfg by default; DP_RATIO 0) with TF32 off,
    weights from seed 7 with random statistics: the eval forward on the card
    against the port's CPU path (which the tests hold against JAX):
    keypoints bit for bit, logits, heads and boxes within atol 1e-4, rtol
    1e-4 (f32 sums in another order), proposals and kept boxes equal.
    Returns the worst differences."""
    cfg = DC.tiny_pvrcnn_cfg() if cfg is None else cfg
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    cpu = torch.device("cpu")
    sd = seeded_state_dict(7, build_detector(cfg, device=cpu)[0], random_stats=True)
    pts, valid = blob_points(4)
    res = {}
    for w in (dev, cpu):
        m, _ = build_detector(cfg, sd, device=w)
        res[w] = F.detect_stage(m, cfg, torch.from_numpy(pts), torch.from_numpy(valid),
                                device=w)
    (pp_d, out_d), (pp_c, out_c) = res[dev], res[cpu]
    if not torch.equal(out_d["keypoints"].cpu(), out_c["keypoints"]):
        raise AssertionError(f"tiny {label}: keypoints differ from the CPU's")
    worst = {}
    for k in ("batch_cls_preds", "point_logits", "rcnn_cls", "rcnn_reg", "rois"):
        got, ref = out_d[k].cpu(), out_c[k]
        worst[k] = (got - ref).abs().max().item()
        if not ((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all():
            raise AssertionError(f"tiny {label}: {k} off the CPU by {worst[k]}")
    for k in ("roi_mask", "roi_labels"):
        if not torch.equal(out_d[k].cpu(), out_c[k]):
            raise AssertionError(f"tiny {label}: proposal NMS differs ({k})")
    if not torch.equal(pp_d["pred_mask"].cpu().sum(-1), pp_c["pred_mask"].sum(-1)):
        raise AssertionError(f"tiny {label}: final NMS differs")
    kept = int(pp_c["pred_mask"].sum())
    print(f"tiny {label} eval, card vs CPU (TF32 off): keypoints bit-equal; max |diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; proposals {int(out_c['roi_mask'].sum())} and kept boxes {kept} equal")
    if kept < 1:
        raise AssertionError(f"tiny {label} kept no box")
    return worst


def tiny_pvrcnn_step(cfg, sd, inputs, device, dtype, pinned=None):
    """One train step of the tiny PV-RCNN (or another tiny detector) on
    ``device`` in ``dtype`` with fixed RoI priorities, its ReLUs' signs
    recorded or, given ``pinned``, taken from another run (relu_signs):
    -> (loss terms, gradients, updated parameters, running statistics, the
    ReLUs' signs), f64 on the CPU. ``inputs``: points, validity, ground
    truth and RoI priorities (None for a detector without an RoI head),
    and for CaDDN images and P2 in place of the points and validity and a
    fifth item, the loss's inputs (depth_maps, gt_boxes2d) by name."""
    model, _ = build_detector(cfg, sd, device=device)
    model.to(dtype)
    state = create_train_state(model, cfg.OPTIMIZATION, 100)
    to = lambda a: None if a is None else torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    pts, valid, gt, u = (to(a) for a in inputs[:4])
    extra = {k: to(v) for k, v in (inputs[4] if len(inputs) > 4 else {}).items()}
    cast = lambda t: t if t is None or not t.is_floating_point() else t.to(dtype)  # noqa: E731
    with torch.enable_grad(), relu_signs(model, pinned) as signs:
        loss, tb, _ = train_forward(state, cast(pts), cast(valid), cast(gt), roi_u=cast(u),
                                    **{k: cast(v) for k, v in extra.items()})
        apply_gradients(state, loss)
    grab = lambda d: {k: v.detach().double().cpu() for k, v in d}   # noqa: E731
    return (grab([("loss", loss), *tb.items()]),
            grab((n, p.grad) for n, p in model.named_parameters()),
            grab(model.named_parameters()),
            grab((n, b) for n, b in model.named_buffers()
                 if not n.endswith("num_batches_tracked")), signs)


#: CenterPoint's shared conv bias: the training batch norm after the conv
#: cancels it, so its gradient is rounding noise around 0 (held against the
#: conv's weight gradient, and excused from moving)
BIAS_BEFORE_BN = "dense_head.shared_conv.bias"


def _to_device(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    return type(x)(_to_device(v, dev) for v in x)


@contextlib.contextmanager
def pinned_calls(targets, pinned=None):
    """Within the block, each call of a function of ``targets`` ((module,
    name) pairs, or (module, name, repin) triples) has its result recorded
    on the CPU, in call order, into the dict yielded (by "module.name");
    given ``pinned``, such a dict from another run, each call returns that
    run's result, on the device of its first tensor argument, instead of
    its own, or, for a triple, ``repin(args, kwargs, that result)``."""
    got = {f"{t[0].__name__}.{t[1]}": [] for t in targets}
    queues = None if pinned is None else {k: list(v) for k, v in pinned.items()}
    plain = {f"{t[0].__name__}.{t[1]}": getattr(t[0], t[1]) for t in targets}

    def pinned_fn(key, repin):
        def call(*a, **kw):
            res = plain[key](*a, **kw)
            got[key].append(_to_device(res, "cpu"))
            if queues is None:
                return res
            dev = next(t for t in a if isinstance(t, torch.Tensor)).device
            res = _to_device(queues[key].pop(0), dev)
            return res if repin is None else repin(a, kw, res)
        return call

    for m, n, *repin in targets:
        setattr(m, n, pinned_fn(f"{m.__name__}.{n}", repin[0] if repin else None))
    try:
        yield got
    finally:
        for m, n, *_ in targets:
            setattr(m, n, plain[f"{m.__name__}.{n}"])


def three_nn_own_distances(args, kwargs, pinned) -> tuple:
    """``three_nn``'s pinned picks with this run's own Gram-form distances
    of those pairs (``gram_sqdist_fma`` on the run's device and dtype,
    invalid supports at +inf): only the picks are a choice."""
    query, support, *rest = args
    valid = rest[0] if rest else kwargs.get("support_valid")
    idx = pinned[0]
    d = SMP.gram_sqdist_fma(query[:, :3], support[:, :3])
    if valid is not None:
        d = torch.where(valid[None, :], d, torch.inf)
    return idx, torch.gather(d, 1, idx)


#: the selections that the card-vs-CPU checks pin to the CPU's, each an f32
#: choice that can fall the other way on the card: the ball query's members
#: (a support at a sphere's edge), the three-NN picks (a Gram-form distance
#: near a tie; the distances stay the run's own), the RoI point pool's
#: indices and the roiaware cells (a point on a box face or a cell face),
#: and CaDDN's frustum cells (a projection at a pixel edge, a depth at a bin
#: edge)
SELECTIONS = ((PFE, "ball_query_multi"), (SMP, "three_nn", three_nn_own_distances),
              (PRC, "roi_point_indices"), (RA, "roi_cells"), (CADDN, "frustum_indices"))


def selection_choices(pinned=None):
    """``pinned_calls`` over ``SELECTIONS``."""
    return pinned_calls(SELECTIONS, pinned)


def selection_flips(got: dict, ref: dict) -> dict:
    """The rows (dim 0) whose recorded choice differs between two records
    of ``selection_choices``, by function (indices, masks and cells; of
    three-NN's record the picks, not the distances)."""
    def rows(a, b):
        if isinstance(a, torch.Tensor):
            if a.is_floating_point():          # three-NN's distances: the picks count
                return torch.zeros(a.shape[0], dtype=torch.bool)
            diff = a != b
            return diff.reshape(diff.shape[0], -1).any(1) if diff.dim() else diff[None]
        per = [rows(x, y) for x, y in zip(a, b)]
        return functools.reduce(torch.logical_or, per)

    return {k.rsplit(".", 1)[1]: sum(int(rows(a, b).sum()) for a, b in zip(got[k], ref[k]))
            for k in ref}


def hold_tiny_step(dev, label: str, cfg, sd, inputs, *, loss_tol: float = 1e-5,
                   grad_tol: float = 5e-4, pin_queries: bool = False, note: str = "",
                   loss_tols: dict | None = None) -> tuple:
    """One train step of the tiny ``cfg`` (state dict ``sd``; ``inputs`` the
    points, validity, ground truth and RoI priorities) on the card in f32
    against the CPU's step in f64 (TF32 off), the ReLUs' signs pinned to the
    CPU's and, with ``pin_queries``, the selections (``selection_choices``):
    loss terms within ``loss_tol`` (relative; ``loss_tols`` names the terms
    held otherwise), gradients within ``grad_tol`` of their tensor's largest
    (``BIAS_BEFORE_BN``'s of its conv weight's), updated parameters within
    1e-5 where the gradient is sure (5% of its tensor's largest and 1e-6), 2
    lr elsewhere, running statistics 1e-5. The unpinned card step and the
    CPU's own f32 step are printed beside. -> (the worst differences, the
    CPU's loss terms)."""
    cpu = torch.device("cpu")
    with selection_choices() as chosen:
        ref = tiny_pvrcnn_step(cfg, sd, inputs, cpu, torch.float64)
    with selection_choices(chosen if pin_queries else None):
        card = tiny_pvrcnn_step(cfg, sd, inputs, dev, torch.float32, pinned=ref[4])
    with selection_choices() as free_chosen:
        free = tiny_pvrcnn_step(cfg, sd, inputs, dev, torch.float32)
    cpu32 = tiny_pvrcnn_step(cfg, sd, inputs, cpu, torch.float32)
    lr = build_lr_schedule(cfg.OPTIMIZATION, 100)(0)
    scale = {n: g.abs().max().item() + 1e-30 for n, g in ref[1].items()}
    if BIAS_BEFORE_BN in scale:
        scale[BIAS_BEFORE_BN] = scale[BIAS_BEFORE_BN.replace("bias", "weight")]

    def grads_off(run):
        return max(((run[1][n] - ref[1][n]).abs().max().item() / scale[n], n)
                   for n in ref[1])

    worst = {"loss_terms": _worst(card[0], ref[0], lambda r: abs(r.item()) + 1e-30),
             "loss_terms_cpu_f32": _worst(cpu32[0], ref[0], lambda r: abs(r.item()) + 1e-30),
             "gradients": grads_off(card), "gradients_unpinned": grads_off(free),
             "gradients_cpu_f32": grads_off(cpu32),
             "running_stats": _worst(card[3], ref[3], lambda r: 1.0 + r.abs().max().item())}
    for n, p in card[2].items():
        g = ref[1][n].abs()
        sure = (g >= 0.05 * g.max()) & (g >= 1e-6)
        err = (p - ref[2][n]).abs()
        if not (err <= torch.where(sure, 1e-5, 2 * lr)).all():
            raise AssertionError(f"tiny {label} step: updated {n} off the CPU by "
                                 f"{err.max().item()}")
    relu_flips = sum(int((a != b).sum()) for a, b in zip(free[4], ref[4]))
    print(f"tiny {label} train step, card f32 vs CPU f64 (ReLU signs"
          f"{' and the selections' if pin_queries else ''} pinned, TF32 off{note}"
          f"{f'; loss-term bounds {loss_tols}' if loss_tols else ''}): worst "
          + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in worst.items())
          + f"; loss {ref[0]['loss'].item():.5f}; {relu_flips} ReLU inputs of the unpinned "
          f"card step on the other side of 0, rows with other choices "
          f"{selection_flips(free_chosen, chosen)}")
    tols = {k: (loss_tols or {}).get(k, loss_tol) for k in ref[0]}
    terms_over = [k for k in ref[0] if (card[0][k] - ref[0][k]).abs().item()
                  > tols[k] * (abs(ref[0][k].item()) + 1e-30)]
    if terms_over or worst["gradients"][0] > grad_tol or worst["running_stats"][0] > 1e-5:
        raise AssertionError(f"tiny {label} step on the card off the CPU's f64 step"
                             + (f" (loss terms {terms_over})" if terms_over else ""))
    return {k: v[0] for k, v in worst.items()}, ref[0]


def check_tiny_pvrcnn_step_against_cpu(dev, cfg=None, label: str = "PV-RCNN",
                                      grad_tol: float = 1e-3) -> dict:
    """One train step of ``cfg`` (tiny_pvrcnn_cfg by default; DP_RATIO 0,
    fixed RoI priorities, weights from seed 8 with random statistics) held
    by ``hold_tiny_step``: loss terms within 5e-5 (relative) and gradients
    within ``grad_tol`` of their tensor's largest, the f32 error of the
    model's training forward (PV-RCNN's 1e-3,
    tests/test_torch_pvrcnn_train.py)."""
    cfg = DC.tiny_pvrcnn_cfg() if cfg is None else cfg
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    sd = seeded_state_dict(8, build_detector(cfg, device="cpu")[0], random_stats=True)
    pts, valid, gt = pvrcnn_train_inputs(cfg, sd)
    u = np.random.RandomState(9).rand(2, int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN
                                             .NMS_POST_MAXSIZE)).astype(np.float32)
    worst, terms = hold_tiny_step(dev, label, cfg, sd, (pts, valid, gt, u), loss_tol=5e-5,
                                  grad_tol=grad_tol,
                                  note=", DP_RATIO 0, fixed RoI priorities")
    if terms["rcnn_loss_reg"].item() <= 0 or terms["point_loss_cls"].item() <= 0:
        raise AssertionError(f"tiny {label} step: no foreground RoI or keypoint")
    return worst


def jax_grid_buckets(sup, cell: float, n_rows: int, cap: int) -> tuple:
    """The largest bucket of the hash-grid table that JAX's SALayer would
    build over ``sup`` (one frame's valid supports, cell the layer's largest
    radius, ``n_rows`` its support rows) and the buckets above ``cap``, JAX's
    capacity; (0, 0) where JAX would run its dense query (fewer than
    GRID_BQ_MIN_SUPPORT rows)."""
    if n_rows < PN2.GRID_BQ_MIN_SUPPORT:
        return 0, 0
    c = torch.floor((sup - sup.amin(0)) / sup.new_tensor(max(cell, 1e-3)))
    t = PN2.table_size_for(n_rows, cap)
    counts = torch.bincount(cell_hash(c.to(torch.int32), t).long(), minlength=t)
    return int(counts.max()), int((counts > cap).sum())


def timed_stage(times: dict, name: str, fn):
    """``fn()`` between synchronizes, its (CUDA-event ms, host ms) into
    ``times[name]``: -> its result."""
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    res = fn()
    ev[1].record()
    torch.cuda.synchronize()
    times[name] = (ev[0].elapsed_time(ev[1]), (time.perf_counter() - t0) * 1e3)
    return res


def pvrcnn_stages(model, cfg, points, valid) -> dict:
    """PVRCNN.forward's (or PVRCNNPlusPlus.forward's) stages in eval, one
    after another, each between synchronizes: {stage: (CUDA-event ms, host
    ms)}, and the output's parts the callers read. PV-RCNN++ takes its
    proposals first; under SPC its keypoints come from the proposal filter,
    the grid dedupe and the sector FPS, each a stage."""
    rcfg = cfg.MODEL.ROI_HEAD
    times, state = {}, {}

    stage = functools.partial(timed_stage, times)

    pfe = model.pfe
    width = PV.jax_stage_width(model.cfg, points.shape[0])
    with torch.no_grad():
        st, bb = stage("voxelize_backbone", lambda: model.voxel_backbone(points, valid))
        bev2d, _, cls_p, box_p = stage(
            "bev_rpn", lambda: model.bev_rpn(bb["encoded_spconv_tensor"]))
        props = stage("proposals", lambda: RH.proposal_layer(cls_p, box_p,
                                                             rcfg.NMS_CONFIG.TEST))
        rois = props["rois"][..., :7]
        if pfe.sample_method == "SPC":
            near = stage("spc_filter", lambda: pfe.spc_candidates(
                points, valid, rois, props["roi_mask"]))
            xyz, ok = stage("grid_dedupe", lambda: pfe.dedupe(points[..., :3], near))
            idx, _ = stage("sector_fps", lambda: sector_fps_sample(
                xyz, ok, pfe.num_keypoints, pfe.num_sectors))
            kp = torch.gather(xyz, 1, idx[..., None].expand(*idx.shape, 3))
            state.update(near=near, reps=xyz, reps_ok=ok)
        else:
            if isinstance(model, PV.PVRCNNPlusPlus):
                valid = stage("roi_neighbourhood", lambda: model.roi_neighbourhood(
                    points, valid, rois))
            kp = stage("keypoints", lambda: pfe.sample_keypoints(points, valid))
        feats = [stage("vsa_bev", lambda: pfe.bev_features(kp, bev2d, PV.BEV_STRIDE)),
                 stage("vsa_raw_points", lambda: pfe.raw_point_features(kp, points, valid))]
        ms3d = bb["multi_scale_3d_features"]
        for name in pfe.layer_names:
            feats.append(stage(f"vsa_{name}", lambda n=name: pfe.stage_features(
                n, kp, ms3d[n], width)))
        before = torch.cat(feats, -1)
        b, k, c = before.shape
        fused = stage("vsa_fusion", lambda: pfe.vsa_point_feature_fusion(
            before.reshape(b * k, c)).reshape(b, k, -1))
        logits = stage("point_head", lambda: model.point_head(before))
        pooled = stage("roi_grid_pool", lambda: model.roi_head.pool(
            rois, kp, fused, torch.sigmoid(logits)))
        rcnn_cls, rcnn_reg = stage("rcnn_head", lambda: model.roi_head.head(pooled))

        def post():
            out = {**props, "rois": PVH.decode_rcnn_boxes(rois, rcnn_reg),
                   "rcnn_iou": rcnn_cls}
            return post_processing(out, cfg.MODEL.POST_PROCESSING, 1, True)

        stage("post_processing", post)
    state.update(ms3d=ms3d, kp=kp, width=width)
    return times, state


def time_stages(stages, model, cfg, points, valid, reps: int = 3) -> tuple:
    """Median over ``reps`` runs (after one warm-up) of each stage's
    (CUDA-event ms, host ms) of ``stages`` (``pvrcnn_stages``,
    ``single_stage_stages`` or ``center_rcnn_stages``), and the last run's
    state."""
    stages(model, cfg, points, valid)
    runs = [stages(model, cfg, points, valid) for _ in range(reps)]
    med = {k: (statistics.median(r[0][k][0] for r in runs),
               statistics.median(r[0][k][1] for r in runs)) for k in runs[0][0]}
    return med, runs[-1][1]


def ball_query_call(model, cfg, state, points, valid) -> dict:
    """The largest ball-query call of the frame (the raw-point SA: 2,048
    keypoints against the frame's valid points, both radii over one
    distance pass), timed alone (CUDA events, median of 5), beside its bound:
    the (queries x supports) f32 distance pass written once at 3.35 TB/s;
    and the keypoint FPS alone (2,048 steps over the grid dedupe's <= 32,768
    representatives) beside its bound, the 9 operations a point a step at
    67 TFLOP/s."""
    sa = cfg.MODEL.PFE.SA_LAYER.raw_points
    kp = state["kp"][0]
    sup = points[0][valid[0], :3].contiguous()
    q, n = kp.shape[0], sup.shape[0]
    bq_ms = time_cuda(lambda: PN2.ball_query_multi(kp, sup, sa.POOL_RADIUS, sa.NSAMPLE,
                                                   width=points.shape[1]),
                      reps=5, warmup=1)
    bq_bound = q * n * 4 / HBM_BYTES_PER_S * 1e3
    idx, ok = grid_subsample(points[0], valid[0], 0.35, 1 << 15)
    sub = points[0][idx, :3].contiguous()
    k = model.pfe.num_keypoints
    fps_ms = time_cuda(lambda: farthest_point_sample(sub, k, ok), reps=3, warmup=1)
    m = int(ok.sum())
    fps_bound = 9 * k * m / FP32_FLOPS * 1e3
    return {"ball_query_ms": bq_ms, "ball_query_bound_ms": bq_bound,
            "ball_query_shape": [q, n], "fps_ms": fps_ms, "fps_bound_ms": fps_bound,
            "fps_points": m, "fps_steps": k}


def detector_frames(det, cfg, label, s, vcn, seg, proj, l2c, image,
                    finite=("batch_cls_preds", "point_logits", "rcnn_cls", "rcnn_reg",
                            "rois")) -> dict:
    """``det`` (a detector at ``cfg``: PV-RCNN's keys of its output are
    checked finite by default) on the SEE frame's completed cloud through
    ``see_and_detect`` (K1 counted, peak memory) and through ``run_frame``
    with the Mask R-CNN masks (K1 counted again), each timed once by the
    host clock; its eval output's ``finite`` keys checked finite: -> the
    counts, the times, the output and the cloud."""
    args = (s["points"], s["valid"], s["det_boxes"], s["det_masks"], s["det_scores"],
            vcn, proj, l2c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    pp, stats, new_pts, new_valid = F.see_and_detect(*args, det, cfg, IMAGE_SIZE)
    torch.cuda.synchronize()
    see_detect_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches["min_sqdist_pruned"] < 1:
        raise AssertionError(f"K1 was not launched in the SEE frame before {label}")
    _, out = F.detect_stage(det, cfg, new_pts, new_valid)
    for k in finite:
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{label} output {k} is not finite")
    K.reset_launches()
    t0 = time.perf_counter()
    pp_f, st_f, _, _ = F.run_frame(image, s["points"], s["valid"], seg, vcn, det, cfg,
                                   proj, l2c)
    torch.cuda.synchronize()
    run_frame_ms = (time.perf_counter() - t0) * 1e3
    fused_launches = dict(K.LAUNCHES)
    if fused_launches["min_sqdist_pruned"] < 1:
        raise AssertionError(f"K1 was not launched inside run_frame with {label}")
    kept_f = int(pp_f["pred_mask"].sum())
    if kept_f < 1 or not torch.isfinite(pp_f["pred_boxes"]).all():
        raise AssertionError(f"run_frame with {label} returned no finite box")
    return {"args": args, "pp": pp, "out": out, "new_pts": new_pts,
            "new_valid": new_valid, "launches": launches, "peak": peak,
            "fused_launches": fused_launches, "kept_f": kept_f,
            "spliced_f": int(st_f["inst_valid"].sum()), "see_detect_ms": see_detect_ms,
            "run_frame_ms": run_frame_ms}


def serve_pvrcnn(dev, card, s, vcn, seg, proj, l2c, image) -> dict:
    """Phase 14 serving: the tiny PV-RCNN's eval on the card against the
    CPU; PV-RCNN at pvrcnn_detector_cfg (weights from seed 0) on the SEE
    frame's completed cloud through ``see_and_detect`` (K1 counted in its
    replace stage) and through ``run_frame`` with the Mask R-CNN masks (K1
    counted again); its stages timed, profiled, the active voxels, the
    largest hash bucket JAX's grid ball query would build, and the largest
    ball query and the keypoint FPS alone beside their bounds."""
    tiny = check_tiny_pvrcnn_against_cpu(dev)
    cfg = DC.pvrcnn_detector_cfg()
    det, dcfg = build_detector(cfg, device="cpu")
    det, _ = build_detector(cfg, seeded_state_dict(0, det), device=dev)
    fr = detector_frames(det, cfg, "PV-RCNN", s, vcn, seg, proj, l2c, image)
    args, pp, out, new_pts, new_valid, launches, peak, fused_launches = (
        fr[k] for k in ("args", "pp", "out", "new_pts", "new_valid", "launches", "peak",
                        "fused_launches"))
    n_props, n_kept = int(out["roi_mask"].sum()), int(pp["pred_mask"].sum())
    active = [int(v) for v in out["active_voxels"]]
    kp = out["keypoints"][0]
    distinct = int(torch.unique(kp, dim=0).shape[0])
    if out["keypoints"].shape != (1, 2048, 3) or out["rcnn_reg"].shape != (1, 100, 7) \
            or n_props < 1 or n_kept < 1 or active[0] < 1000 or distinct != 2048:
        raise AssertionError(f"PV-RCNN did no real work: {distinct} distinct keypoints, "
                             f"{n_props} proposals, {n_kept} kept, active {active}")
    print(f"PV-RCNN at pv_rcnn.yaml's widths on the SEE frame's {int(new_valid.sum())} "
          f"valid points (see_and_detect): kernel launches {launches}; active voxels "
          f"input / conv1 / conv2 / conv3 / conv4 / conv_out {active} (cap "
          f"{dcfg.max_voxels}); {n_props} proposals, {n_kept} boxes kept; peak device "
          f"memory {peak:.2f} GiB")
    print(f"fused frame with PV-RCNN (run_frame): kernel launches {fused_launches}; "
          f"{fr['spliced_f']} completions spliced, {fr['kept_f']} boxes kept")

    stages, state = time_stages(pvrcnn_stages, det, cfg, new_pts[None], new_valid[None])
    det_ms = time_cuda(lambda: F.detect_stage(det, cfg, new_pts, new_valid),
                       reps=DETECT_REPS)
    det_host = host_ms(lambda: F.detect_stage(det, cfg, new_pts, new_valid), reps=DETECT_REPS)
    fd_ms = host_ms(lambda: F.see_and_detect(*args, det, cfg, IMAGE_SIZE), reps=FRAME_REPS)
    ff_ms = host_ms(lambda: F.run_frame(image, s["points"], s["valid"], seg, vcn, det,
                                        cfg, proj, l2c), reps=FRAME_REPS)
    busy, top = profile_kernels((det, cfg, new_pts, new_valid), F.detect_stage)
    print("PV-RCNN stages, CUDA-event / host ms (median of 3, each between "
          "synchronizes): " + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b)
                                        in stages.items()))
    print(f"PV-RCNN detect_stage {det_ms:.2f} ms (CUDA events, median of {DETECT_REPS}), "
          f"{det_host:.2f} ms host; SEE + PV-RCNN frame {fd_ms:.2f} ms, fused frame "
          f"with PV-RCNN {ff_ms:.2f} ms (host clock, one run) on {card}; profiled "
          f"detect_stage: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top))
    buckets = {}
    pfe_cfg = cfg.MODEL.PFE
    p_rows = new_pts.shape[0]
    sources = [("raw_points", new_pts[new_valid], p_rows)]
    vox_rows = state["width"]
    for name in det.pfe.layer_names:
        st = state["ms3d"][name]
        sources.append((name, det.pfe.stage_centres(name, st)[st.mask], vox_rows))
    for name, sup, rows in sources:
        sa = pfe_cfg.SA_LAYER[name]
        cap = PN2.shared_table_capacity(sa.POOL_RADIUS, sa.NSAMPLE)
        big, over = jax_grid_buckets(sup, float(max(sa.POOL_RADIUS)), rows, cap)
        buckets[name] = {"largest": big, "capacity": cap, "over": over,
                         "supports": int(sup.shape[0])}
    print("largest bucket of JAX's grid ball query table (cell = the largest radius) "
          "beside its capacity, by source: " + ", ".join(
              f"{k} {v['largest']} / {v['capacity']} ({v['over']} buckets over, "
              f"{v['supports']} supports)" for k, v in buckets.items()))
    alone = ball_query_call(det, cfg, state, new_pts[None], new_valid[None])
    print(f"largest ball query alone ({alone['ball_query_shape'][0]} keypoints x "
          f"{alone['ball_query_shape'][1]} raw points, radii 0.4 and 0.8): "
          f"{alone['ball_query_ms']:.3f} ms (CUDA events, median of 5), bound "
          f"{alone['ball_query_bound_ms']:.4f} ms (the f32 distance pass at 3.35 TB/s); "
          f"keypoint FPS alone ({alone['fps_steps']} steps over {alone['fps_points']} "
          f"points): {alone['fps_ms']:.2f} ms, bound {alone['fps_bound_ms']:.4f} ms "
          f"(9 operations a point a step at 67 TFLOP/s) on {card}")
    return {"tiny_vs_cpu": tiny, "launches": launches, "fused_launches": fused_launches,
            "active_voxels": active, "proposals": n_props, "kept": n_kept,
            "peak_gib": peak, "stage_ms": stages, "detect_ms": det_ms,
            "detect_host_ms": det_host, "see_detect_frame_ms": fd_ms,
            "fused_frame_ms": ff_ms, "device_busy_ms": busy, "top_ops": top,
            "buckets": buckets, **alone}


def train_pvrcnn(dev, card, pts, valid, gt, steps: int = TIMED_STEPS, cfg=None, tiny_cfg=None,
                 label: str = "PV-RCNN", tiny_grad_tol: float = 1e-3) -> dict:
    """Phase 14 training (phase 15's with PV-RCNN++'s configs): the tiny step
    at ``tiny_cfg`` card vs the CPU's f64 step, then 1 + ``steps`` train
    steps at ``cfg`` (pvrcnn_detector_cfg by default; f32, batch 2 as
    pv_rcnn.yaml, MAX_NUMBER_OF_VOXELS' train cap, weights from seed 0) on
    two GT-completed frames; one split by CUDA events, one profiled; the
    train proposal NMS (9,000 -> 512) timed alone. Raises unless every loss
    is finite and every parameter moved after step 1, but the box branch's
    where step 1 sampled no foreground RoI (its regression loss reads 0)
    and its gradient is all zero."""
    tiny = check_tiny_pvrcnn_step_against_cpu(dev, tiny_cfg, label, tiny_grad_tol)
    cfg = DC.pvrcnn_detector_cfg() if cfg is None else cfg
    batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    pts, valid, gt = pts[:batch], valid[:batch], gt[:batch]
    cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    cpu_model, _ = build_detector(cfg, max_voxels=cap, device="cpu")
    model, _ = build_detector(cfg, seeded_state_dict(0, cpu_model), max_voxels=cap,
                              device=dev)
    state = create_train_state(model, cfg.OPTIMIZATION, total_steps=1000)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, tb, out = train_forward(state, pts, valid, gt, gen)
    apply_gradients(state, loss)
    losses = [{"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}]
    for n, p in model.named_parameters():
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"gradient of {n} is not finite")
    no_grad = [n for n, p in model.named_parameters() if not p.grad.any()]
    # without a foreground RoI (random weights) the box branch has no
    # gradient, and its zero biases no decay: only they may stay
    excused = ("roi_head.reg_layers.",) if tb["rcnn_loss_reg"].item() == 0 else ()
    idle = check_moved(model, start, excused, f"{label} train step 1")
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
    busy, top = profile_kernels((state, pts, valid, gt, gen), train_step)
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"a {label} training loss is not finite")
    tg = out["rcnn_targets"]
    fg = (tg["roi_sample_mask"] & tg["reg_valid_mask"]).sum(1).tolist()
    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN
    with torch.no_grad():
        cls_p, box_p = fwd["batch_cls_preds"].detach(), fwd["batch_box_preds"].detach()
        nms_ms = time_cuda(lambda: RH.proposal_layer(cls_p, box_p, nms_cfg), reps=3,
                           warmup=1)
        nms_host = host_ms(lambda: RH.proposal_layer(cls_p, box_p, nms_cfg), reps=3)
    step_ms = statistics.median(times)
    summary = {"tiny_vs_cpu": tiny, "step_ms": step_ms,
               "frames_per_s": batch * 1e3 / step_ms, "step_ms_all": times,
               "split_ms": split, "peak_gib": peak, "device_busy_ms": busy,
               "top_ops": top, "losses": [m["loss"] for m in values],
               "last_terms": values[-1], "no_gradient": no_grad, "idle": idle,
               "proposals": out["roi_mask"].sum(1).tolist(), "sampled_fg": fg,
               "train_nms_ms": nms_ms, "train_nms_host_ms": nms_host, "voxel_cap": cap}
    print(f"{label} train steps at batch {batch} ({cfg.MODEL.NAME} at full width, f32, "
          f"train cap {cap} voxels) on GT-completed frames: losses "
          + ", ".join(f"{v:.4f}" for v in summary["losses"])
          + "; last terms " + ", ".join(f"{k} {v:.4f}" for k, v in values[-1].items())
          + f"; proposals {summary['proposals']}, sampled fg {fg}; parameters with an "
          f"all-zero gradient in step 1: {no_grad}; of them still after it: {idle}")
    print(f"{label} train step {step_ms:.2f} ms (host clock to a synchronize, median of "
          f"{steps}) = {summary['frames_per_s']:.2f} frames/s; CUDA events: forward "
          f"{split['forward']:.2f} ms, loss {split['loss']:.2f} ms, backward + update "
          f"{split['backward_update']:.2f} ms; peak device memory {peak:.2f} GiB; "
          f"profiled step: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + f" on {card}")
    print(f"{label} train proposal NMS ({int(nms_cfg.NMS_PRE_MAXSIZE)} -> "
          f"{int(nms_cfg.NMS_POST_MAXSIZE)}, a {int(nms_cfg.NMS_PRE_MAXSIZE)}-step greedy "
          f"scan a frame, {batch} frames): {nms_ms:.2f} ms (CUDA events, median of 3), "
          f"{nms_host:.2f} ms host")
    return summary


# PV-RCNN++: serving and training (phase 15)

#: the f32 error of the tiny PV-RCNN++'s training forward in its gradients,
#: as a share of a tensor's largest (tests/test_torch_pvrcnn_plusplus_train.py:
#: its VectorPool and MSG batch norms carry more of it than PV-RCNN's 1e-3)
PLUSPLUS_F32_GRAD = 2e-3


def spc_sectors(xyz, ok, k: int, num_sectors: int) -> dict:
    """Each sector's count of the sector FPS's candidates (one frame) and
    its quota, as ``sector_fps_sample`` reckons them."""
    sec = sector_ids(xyz, num_sectors)
    quota = sector_quotas(sec[None], ok[None], num_sectors, k)[0]
    return {"counts": torch.bincount(sec[ok], minlength=num_sectors).tolist(),
            "quotas": quota.tolist(), "steps": int(quota.max())}


def serve_pvrcnn_plusplus(dev, card, s, vcn, seg, proj, l2c, image) -> dict:
    """Phase 15 serving: the tiny PV-RCNN++ (SPC + VectorPool) on the card
    against the CPU; PV-RCNN++ at pvrcnn_plusplus_detector_cfg (weights from
    seed 0) on the SEE frame's completed cloud through ``see_and_detect``
    and ``run_frame`` (K1 counted in each); detect_stage timed, its stages
    (the SPC filter, the grid dedupe and the sector FPS among them) timed
    and profiled, the SPC filter's kept points, the representatives and
    each sector's count and quota, and the largest bucket of the grid table
    JAX's VectorPool query would build for each group (cell = its radius)
    beside its capacity."""
    tiny = check_tiny_pvrcnn_against_cpu(dev, DC.tiny_pvrcnn_plusplus_cfg(), "PV-RCNN++")
    cfg = DC.pvrcnn_plusplus_detector_cfg()
    det, dcfg = build_detector(cfg, device="cpu")
    det, _ = build_detector(cfg, seeded_state_dict(0, det), device=dev)
    fr = detector_frames(det, cfg, "PV-RCNN++", s, vcn, seg, proj, l2c, image)
    args, pp, out, new_pts, new_valid = (fr[k] for k in ("args", "pp", "out", "new_pts",
                                                          "new_valid"))
    k = det.pfe.num_keypoints
    n_props, n_kept = int(out["roi_mask"].sum()), int(pp["pred_mask"].sum())
    distinct = int(torch.unique(out["keypoints"][0], dim=0).shape[0])
    n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_POST_MAXSIZE)
    if out["keypoints"].shape != (1, k, 3) or out["rcnn_reg"].shape != (1, n_rois, 7) \
            or n_props < 1 or n_kept < 1 or distinct < k // 2:
        raise AssertionError(f"PV-RCNN++ did no real work: {distinct} distinct keypoints, "
                             f"{n_props} proposals, {n_kept} kept")
    print(f"PV-RCNN++ at pv_rcnn_plusplus.yaml's PFE on the SEE frame's "
          f"{int(new_valid.sum())} valid points (see_and_detect): kernel launches "
          f"{fr['launches']}; {n_props} proposals, {n_kept} boxes kept, {distinct} distinct "
          f"keypoints of {k}; peak device memory {fr['peak']:.2f} GiB")
    print(f"fused frame with PV-RCNN++ (run_frame): kernel launches "
          f"{fr['fused_launches']}; {fr['spliced_f']} completions spliced, {fr['kept_f']} "
          f"boxes kept")

    pts, vld = new_pts[None], new_valid[None]
    stages, state = time_stages(pvrcnn_stages, det, cfg, pts, vld)
    det_ms = time_cuda(lambda: F.detect_stage(det, cfg, new_pts, new_valid),
                       reps=DETECT_REPS)
    det_host = host_ms(lambda: F.detect_stage(det, cfg, new_pts, new_valid), reps=DETECT_REPS)
    fd_ms = host_ms(lambda: F.see_and_detect(*args, det, cfg, IMAGE_SIZE), reps=FRAME_REPS)
    ff_ms = host_ms(lambda: F.run_frame(image, s["points"], s["valid"], seg, vcn, det,
                                        cfg, proj, l2c), reps=FRAME_REPS)
    busy, top = profile_kernels((det, cfg, new_pts, new_valid), F.detect_stage)
    sectors = spc_sectors(state["reps"][0], state["reps_ok"][0], k, det.pfe.num_sectors)
    spc = {"kept": int(state["near"].sum()), "representatives": int(state["reps_ok"].sum()),
           **sectors}
    print("PV-RCNN++ stages, CUDA-event / host ms (median of 3, each between "
          "synchronizes): " + ", ".join(f"{n} {a:.2f} / {b:.2f}" for n, (a, b)
                                        in stages.items()))
    print(f"PV-RCNN++ detect_stage {det_ms:.2f} ms (CUDA events, median of {DETECT_REPS}), "
          f"{det_host:.2f} ms host; SEE + PV-RCNN++ frame {fd_ms:.2f} ms, fused frame with "
          f"PV-RCNN++ {ff_ms:.2f} ms (host clock, one run) on {card}; profiled "
          f"detect_stage: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top))
    print(f"SPC: {spc['kept']} of {int(new_valid.sum())} valid points near a proposal, "
          f"{spc['representatives']} representatives after the grid dedupe; by sector "
          f"counts {spc['counts']}, quotas {spc['quotas']} (sum {sum(spc['quotas'])}); "
          f"the batched sector FPS ran {spc['steps']} steps over {det.pfe.num_sectors} "
          f"sectors")
    buckets = {}
    sources = [("raw_points", new_pts[new_valid], new_pts.shape[0])]
    for name in det.pfe.layer_names:
        st = state["ms3d"][name]
        sources.append((name, det.pfe.stage_centres(name, st)[st.mask], state["width"]))
    for name, sup, rows in sources:
        layer = det.pfe.SA_rawpoints if name == "raw_points" else \
            det.pfe.SA_layers[det.pfe.layer_names.index(name)]
        for g, grp in enumerate(layer.layers):
            # JAX's VectorPool query is its ball_query: grid_ball_query's
            # table, cell = the radius, capacity max(2 nsample, 32)
            cap = max(2 * grp.nsample, 32)
            big, over = jax_grid_buckets(sup, grp.radius, rows, cap)
            buckets[f"{name}.{g}"] = {"radius": grp.radius, "largest": big,
                                      "capacity": cap, "over": over,
                                      "supports": int(sup.shape[0]), "width": rows}
    print("largest bucket of JAX's VectorPool grid table (cell = the group's radius) "
          "beside its capacity, by source and group: " + ", ".join(
              f"{n} (r {v['radius']}) {v['largest']} / {v['capacity']} ({v['over']} buckets "
              f"over, {v['supports']} supports, JAX width {v['width']})"
              for n, v in buckets.items()))
    return {"tiny_vs_cpu": tiny, "launches": fr["launches"],
            "fused_launches": fr["fused_launches"], "proposals": n_props, "kept": n_kept,
            "distinct_keypoints": distinct, "peak_gib": fr["peak"], "stage_ms": stages,
            "detect_ms": det_ms, "detect_host_ms": det_host, "see_detect_frame_ms": fd_ms,
            "fused_frame_ms": ff_ms, "device_busy_ms": busy, "top_ops": top, "spc": spc,
            "buckets": buckets}


# Single-stage detectors: PointPillar and SECONDNet (phase 16)

SINGLE_STAGE = {"pointpillar": ("PointPillar", DC.pointpillar_detector_cfg,
                                DC.tiny_pointpillar_cfg),
                "second_multihead": ("SECONDNet (residual, multi-head)",
                                     DC.second_multihead_detector_cfg,
                                     DC.tiny_second_multihead_cfg),
                "second_focal": ("SECONDNet (focal)", DC.second_focal_detector_cfg,
                                 DC.tiny_second_focal_cfg)}
SINGLE_STAGE_OUT = ("batch_cls_preds", "batch_box_preds", "spatial_features_2d")


def single_stage_train_inputs():
    """tiny_train_inputs' blob frames and cars, with a pedestrian and a
    cyclist in frame 0, each near a node of the tiny stride-8 anchor grid
    (16 / 3 m apart), so that every class has a positive anchor: numpy
    (points, valid, gt)."""
    pts, valid, gt, _ = (t.numpy() for t in tiny_train_inputs("cpu"))
    gt[0, 2] = [10.6, 2.7, -0.6, 0.8, 0.6, 1.73, 0.1, 2.0]
    gt[0, 3] = [5.3, -2.6, -0.6, 1.76, 0.6, 1.73, 1.5, 3.0]
    return pts, valid, gt


@torch.no_grad()
def check_tiny_single_stage_against_cpu(dev) -> dict:
    """Each tiny single-stage detector (weights from seed 7 with random
    statistics, TF32 off) through ``detect_stage`` on the card against the
    port's CPU path (which the tests hold against JAX): head maps, boxes
    and BEV features within 1e-5 of a tensor's largest |value|,
    post-processed keep masks and labels equal. Returns the worst
    differences (relative to the largest) by detector."""
    cpu = torch.device("cpu")
    pts, valid = blob_points(4)
    worst = {}
    for key, (label, _, tiny) in SINGLE_STAGE.items():
        cfg = tiny()
        sd = seeded_state_dict(7, build_detector(cfg, device=cpu)[0], random_stats=True)
        res = {}
        for w in (dev, cpu):
            m, _ = build_detector(cfg, sd, device=w)
            res[w] = F.detect_stage(m, cfg, torch.from_numpy(pts), torch.from_numpy(valid),
                                    device=w)
        (pp_d, out_d), (pp_c, out_c) = res[dev], res[cpu]
        worst[key] = _worst({k: out_d[k].cpu() for k in SINGLE_STAGE_OUT},
                            {k: out_c[k] for k in SINGLE_STAGE_OUT},
                            lambda r: r.abs().max().item() + 1e-30)
        if worst[key][0] > 1e-5:
            raise AssertionError(f"tiny {label}: {worst[key][1]} off the CPU by "
                                 f"{worst[key][0]:.3g} of its largest")
        for k in ("pred_mask", "pred_labels"):
            if not torch.equal(pp_d[k].cpu(), pp_c[k]):
                raise AssertionError(f"tiny {label}: post-processing differs ({k})")
        if not pp_c["pred_mask"].any():
            raise AssertionError(f"tiny {label} kept no box")
    print("tiny single-stage detectors eval, card vs CPU (TF32 off): worst |diff| / "
          "largest " + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in worst.items())
          + "; kept boxes and labels equal")
    return {k: v[0] for k, v in worst.items()}


def check_tiny_single_stage_steps_against_cpu(dev) -> dict:
    """One train step of each tiny single-stage detector (weights from seed
    8 with random statistics) held by ``hold_tiny_step`` at 1e-5 (loss
    terms) and 5e-4 (gradients); its RoI priorities are a placeholder these
    detectors never read."""
    pts, valid, gt = single_stage_train_inputs()
    inputs = (pts, valid, gt, np.zeros((2, 1), np.float32))
    out = {}
    for key, (label, _, tiny) in SINGLE_STAGE.items():
        cfg = tiny()
        sd = seeded_state_dict(8, build_detector(cfg, device="cpu")[0], random_stats=True)
        out[key], terms = hold_tiny_step(dev, label, cfg, sd, inputs)
        if terms["rpn_loss_loc"].item() <= 0:
            raise AssertionError(f"tiny {label} step: no foreground anchor")
    return out


def check_atss_against_cpu(dev) -> dict:
    """The ATSS assigner (TOPK 9) on the card against the CPU: the
    three-class KITTI head at stride 8 over a 64 x 64 map (tests/
    test_multiclass.py's range [0, -32, -3, 64, 32, 1] at 0.125 m: 24,576
    anchors) and 21 ground-truth boxes of the three classes over two
    frames: labels and weights equal, targets within 1e-5."""
    head = DC._kitti_three_class_head(8)
    head.TARGET_ASSIGNER_CONFIG["NAME"] = "ATSS"
    head.TARGET_ASSIGNER_CONFIG["TOPK"] = 9
    logic = AnchorHeadLogic(head, 3, ["Car", "Pedestrian", "Cyclist"], [512, 512, 32],
                            [0, -32, -3, 64, 32, 1])
    rng = np.random.RandomState(3)
    sizes = np.float32([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]])
    cls = rng.randint(0, 3, (2, 12))
    gt = np.concatenate([rng.uniform([2, -30, -1.5], [62, 30, -0.5], (2, 12, 3)),
                         sizes[cls], rng.uniform(-3, 3, (2, 12, 1)),
                         (cls + 1)[..., None]], -1).astype(np.float32)
    gt[1, 9:] = 0.0
    ref = logic.assign_targets(torch.from_numpy(gt))
    got = logic.assign_targets(torch.from_numpy(gt).to(dev))
    ms = host_ms(lambda: logic.assign_targets(torch.from_numpy(gt).to(dev)), reps=3)
    for k in ("box_cls_labels", "reg_weights"):
        if not torch.equal(got[k].cpu(), ref[k]):
            raise AssertionError(f"ATSS on the card: {k} differs from the CPU's")
    err = (got["box_reg_targets"].cpu() - ref["box_reg_targets"]).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"ATSS on the card: targets off the CPU's by {err}")
    pos = int((ref["box_cls_labels"] > 0).sum())
    print(f"ATSS (TOPK 9) over {logic.anchors_flat.shape[0]} anchors and 21 ground-truth "
          f"boxes of three classes, card vs CPU: labels and weights equal ({pos} positive), "
          f"targets within {err:.3g}; {ms:.2f} ms on the card (host clock, median of 3)")
    if pos < 1:
        raise AssertionError("ATSS assigned no positive")
    return {"positives": pos, "max_target_err": err, "ms": ms}


def single_stage_stages(model, cfg, points, valid) -> tuple:
    """The detector's eval forward and post-processing, stage by stage,
    each between synchronizes: {stage: (CUDA-event ms, host ms)}, and the
    output. PointPillar: voxelize (its pillars), vfe, scatter; SECONDNet:
    voxelize, backbone_3d (and the height compression); both: bev_backbone,
    head (with the box decoding), post_processing."""
    times = {}

    stage = functools.partial(timed_stage, times)

    b = points.shape[0]
    with torch.no_grad():
        if isinstance(model, PointPillar):
            pts, pid, means, coords, mask = stage("voxelize",
                                                  lambda: model.pillars(points, valid))
            feats = stage("vfe", lambda: model.vfe(pts, pid, means, coords,
                                                   b * model.cfg.max_voxels))
            bev = stage("scatter", lambda: model.scatter(feats, coords, mask, b))
        else:
            st = stage("voxelize", lambda: SP.make_sparse_tensor(*voxelize_batch(
                points, valid, point_cloud_range=model.cfg.point_cloud_range,
                voxel_size=model.cfg.voxel_size, max_voxels=model.cfg.max_voxels,
                max_points_per_voxel=model.cfg.max_points_per_voxel),
                model.cfg.sparse_shape, b))
            bev = stage("backbone_3d", lambda: height_compression(
                model.backbone_3d(st)["encoded_spconv_tensor"]))
        bev2d = stage("bev_backbone", lambda: model.backbone_2d(bev))
        head_out = stage("head", lambda: model.dense_head(bev2d))
        cls_p, box_p = model.cfg.head_logic.predict_boxes(head_out)
        out = {"batch_cls_preds": cls_p, "batch_box_preds": box_p}
        stage("post_processing", lambda: post_processing(
            out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES), False))
    return times, out


def time_single_stage_nms(out, cfg) -> dict:
    """Post-processing's NMS alone on the frame's own head output (CUDA
    events, median of 3): each per-class pass (MULTI_CLASSES_NMS) or the one
    pass, and its greedy scan alone over the NMS_PRE_MAXSIZE top boxes."""
    nms = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    thresh = float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH)
    cls = torch.sigmoid(out["batch_cls_preds"][0])
    boxes = out["batch_box_preds"][0, :, :7]
    columns = [cls[:, k] for k in range(cls.shape[1])] if nms.MULTI_CLASSES_NMS \
        else [cls.max(-1).values]
    res = {"passes": len(columns)}
    pre, post = int(nms.NMS_PRE_MAXSIZE), int(nms.NMS_POST_MAXSIZE)
    with torch.no_grad():
        res["nms_ms"] = time_cuda(lambda: [nms_bev(boxes, sc, float(nms.NMS_THRESH), pre, post,
                                                   thresh) for sc in columns],
                                  reps=3, warmup=1)
        sc = columns[0]
        k = min(pre, boxes.shape[0])
        top = boxes[torch.sort(sc, descending=True, stable=True).indices[:k]]
        overlap = boxes_iou_bev(top, top, row_chunk=512 if k > 2048 else None)
        ok = torch.sort(sc, descending=True, stable=True).values[:k] >= thresh
        res["greedy_scan_ms"] = time_cuda(lambda: NMS._greedy_suppress(
            overlap, ok, float(nms.NMS_THRESH)), reps=3, warmup=1)
        res["iou_ms"] = time_cuda(lambda: boxes_iou_bev(top, top, row_chunk=512
                                                        if k > 2048 else None),
                                  reps=3, warmup=1)
    res.update(k=k, above_thresh=int(ok.sum()))
    return res


def group_positives(logic, gt) -> list:
    """Each anchor class's positive count in the assigner's targets for
    ``gt`` (B, M, 8)."""
    labels = logic.assign_targets(gt)["box_cls_labels"]
    return [int((labels == c + 1).sum()) for c in range(logic.num_class)]


def serve_single_stage(dev, card, key, s, vcn, seg, proj, l2c, image) -> dict:
    """Phase 16 serving of ``key`` (pointpillar or second_multihead, weights
    from seed 0) on the SEE frame's completed cloud: ``see_and_detect`` and
    ``run_frame`` (K1 counted in each, peak memory), ``detect_stage`` timed
    (CUDA events, median of DETECT_REPS), its stages, post-processing's NMS alone,
    the active pillars or voxels against the cap, device busy and top
    ops."""
    label, full, _ = SINGLE_STAGE[key]
    cfg = full()
    det, dcfg = build_detector(cfg, device="cpu")
    det, _ = build_detector(cfg, seeded_state_dict(0, det), device=dev)
    fr = detector_frames(det, cfg, label, s, vcn, seg, proj, l2c, image,
                         finite=SINGLE_STAGE_OUT)
    pp, out, new_pts, new_valid = (fr[k] for k in ("pp", "out", "new_pts", "new_valid"))
    active = [int(v) for v in out["active_voxels"]]
    kept = int(pp["pred_mask"].sum())
    labels = torch.bincount(pp["pred_labels"][0][pp["pred_mask"][0]].long(),
                            minlength=4)[1:].tolist()
    n_anchors = dcfg.head_logic.anchors_flat.shape[0]
    if out["batch_box_preds"].shape != (1, n_anchors, 7) or kept < 1 or active[0] < 1000:
        raise AssertionError(f"{label} did no real work: active {active}, {kept} kept")
    print(f"{label} at full width on the SEE frame's {int(new_valid.sum())} valid points "
          f"(see_and_detect): kernel launches {fr['launches']}; active "
          f"{'pillars' if key == 'pointpillar' else 'voxels input / conv1-4 / conv_out'} "
          f"{active} (cap {dcfg.max_voxels}); {n_anchors} anchors, {kept} boxes kept "
          f"(by class {labels}); peak device memory {fr['peak']:.2f} GiB")
    print(f"fused frame with {label} (run_frame): kernel launches {fr['fused_launches']}; "
          f"{fr['spliced_f']} completions spliced, {fr['kept_f']} boxes kept")
    pts, vld = new_pts[None], new_valid[None]
    stages, out = time_stages(single_stage_stages, det, cfg, pts, vld)
    nms = time_single_stage_nms(out, cfg)
    det_ms = time_cuda(lambda: F.detect_stage(det, cfg, new_pts, new_valid),
                       reps=DETECT_REPS)
    det_host = host_ms(lambda: F.detect_stage(det, cfg, new_pts, new_valid), reps=DETECT_REPS)
    fd_ms = host_ms(lambda: F.see_and_detect(*fr["args"], det, cfg, IMAGE_SIZE),
                    reps=FRAME_REPS)
    ff_ms = host_ms(lambda: F.run_frame(image, s["points"], s["valid"], seg, vcn, det,
                                        cfg, proj, l2c), reps=FRAME_REPS)
    busy, top = profile_kernels((det, cfg, new_pts, new_valid), F.detect_stage)
    print(f"{label} stages, CUDA-event / host ms (median of 3, each between "
          "synchronizes): " + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b)
                                        in stages.items()))
    print(f"{label} post-processing NMS alone ({nms['passes']} pass(es) of K={nms['k']}, "
          f"{nms['above_thresh']} of them above SCORE_THRESH in the first): "
          f"{nms['nms_ms']:.2f} ms, of which the {nms['k']} x {nms['k']} rotated IoU "
          f"{nms['iou_ms']:.2f} ms and the greedy scan {nms['greedy_scan_ms']:.2f} ms a "
          "pass (CUDA events, median of 3)")
    print(f"{label} detect_stage {det_ms:.2f} ms (CUDA events, median of {DETECT_REPS}), "
          f"{det_host:.2f} ms host; SEE + {label} frame {fd_ms:.2f} ms, fused frame with "
          f"{label} {ff_ms:.2f} ms (host clock, one run) on {card}; profiled "
          f"detect_stage: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top))
    return {"launches": fr["launches"], "fused_launches": fr["fused_launches"],
            "active": active, "cap": dcfg.max_voxels, "kept": kept, "kept_by_class": labels,
            "peak_gib": fr["peak"], "stage_ms": stages, "nms": nms, "detect_ms": det_ms,
            "detect_host_ms": det_host, "see_detect_frame_ms": fd_ms,
            "fused_frame_ms": ff_ms, "device_busy_ms": busy, "top_ops": top}


def train_single_stage(dev, card, key, pts, valid, gt, steps: int = 5) -> dict:
    """Phase 16 training of ``key`` at full width (f32, batch 4 as the
    configs', the train voxel cap, weights from seed 0) on the four
    GT-completed frames: 1 + ``steps`` train steps, one split by CUDA
    events, one profiled. Raises unless every loss is finite and every
    parameter moved after step 1, but a head group's box and direction
    convs while the step's targets give that group's classes no positive
    (their gradient all zero)."""
    label, full, _ = SINGLE_STAGE[key]
    cfg = full()
    batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    pts, valid, gt = pts[:batch], valid[:batch], gt[:batch]
    cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    cpu_model, _ = build_detector(cfg, max_voxels=cap, device="cpu")
    model, dcfg = build_detector(cfg, seeded_state_dict(0, cpu_model), max_voxels=cap,
                                 device=dev)
    state = create_train_state(model, cfg.OPTIMIZATION, total_steps=1000)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    positives = group_positives(dcfg.head_logic, gt)
    excused = ()
    head = model.dense_head
    for g, grp in enumerate(getattr(head, "groups", ())):
        if sum(positives[c] for c in grp) == 0:
            excused += (f"dense_head.rpn_heads.{g}.conv_box.",
                        f"dense_head.rpn_heads.{g}.conv_dir_cls.")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, tb, out = train_forward(state, pts, valid, gt)
    apply_gradients(state, loss)
    losses = [{"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}]
    for n, p in model.named_parameters():
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"{label}: gradient of {n} is not finite")
    idle = check_moved(model, start, excused, f"{label} train step 1")
    train_step(state, pts, valid, gt)                       # warm-up
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_step(state, pts, valid, gt))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    fwd = model(pts, valid, gt_boxes=gt)
    ev[1].record()
    loss, _ = model.loss(fwd, gt)
    ev[2].record()
    apply_gradients(state, loss)
    ev[3].record()
    torch.cuda.synchronize()
    split = {k: ev[i].elapsed_time(ev[i + 1])
             for i, k in enumerate(("forward", "loss", "backward_update"))}
    busy, top = profile_kernels((state, pts, valid, gt), train_step)
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"a {label} training loss is not finite")
    step_ms = statistics.median(times)
    summary = {"step_ms": step_ms, "frames_per_s": batch * 1e3 / step_ms,
               "step_ms_all": times, "split_ms": split, "peak_gib": peak,
               "device_busy_ms": busy, "top_ops": top,
               "losses": [m["loss"] for m in values], "last_terms": values[-1],
               "positives_by_class": positives, "idle": idle, "voxel_cap": cap,
               "active": [int(v) for v in out["active_voxels"]]}
    print(f"{label} train steps at batch {batch} (full width, f32, train cap {cap}) on "
          f"GT-completed frames: losses " + ", ".join(f"{v:.4f}" for v in summary["losses"])
          + "; last terms " + ", ".join(f"{k} {v:.4f}" for k, v in values[-1].items())
          + f"; positive anchors by class {positives}; active {summary['active']}; "
          f"parameters still after step 1 (no foreground in their group): {idle}")
    print(f"{label} train step {step_ms:.2f} ms (host clock to a synchronize, median of "
          f"{steps} after a warm-up) = {summary['frames_per_s']:.2f} frames/s; CUDA events: "
          f"forward {split['forward']:.2f} ms, loss {split['loss']:.2f} ms, backward + update "
          f"{split['backward_update']:.2f} ms; peak device memory {peak:.2f} GiB; profiled "
          f"step: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + f" on {card}")
    return summary


def serve_second_focal(dev, card, new_pts, new_valid) -> dict:
    """Phase 16: the focal SECONDNet at full width (weights from seed 0) on
    the SEE frame's completed cloud: one timed eval forward (CUDA events,
    median of 3) and the voxels each focal layer adds."""
    label, full, _ = SINGLE_STAGE["second_focal"]
    cfg = full()
    det, dcfg = build_detector(cfg, device="cpu")
    det, _ = build_detector(cfg, seeded_state_dict(0, det), device=dev)
    pp, out = F.detect_stage(det, cfg, new_pts, new_valid)
    for k in SINGLE_STAGE_OUT:
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"{label} output {k} is not finite")
    with torch.no_grad():
        bb = det.voxel_backbone(new_pts[None], new_valid[None])[1]
    # the voxels a focal layer adds: its stage's actives less its input's
    # (each stage's later convs are submanifold)
    ins = [int(a["mask"].sum()) for a in bb["focal_aux"]]
    outs = [int(bb["multi_scale_3d_features"][f"x_conv{i}"].mask.sum()) for i in (1, 2, 3)]
    added = [o - i for o, i in zip(outs, ins)]
    det_ms = time_cuda(lambda: F.detect_stage(det, cfg, new_pts, new_valid), reps=3, warmup=1)
    kept = int(pp["pred_mask"].sum())
    print(f"{label} at full width on the SEE frame: detect_stage {det_ms:.2f} ms (CUDA "
          f"events, median of 3) on {card}; active voxels {[int(v) for v in out['active_voxels']]}"
          f" (cap {dcfg.max_voxels}); the focal layers' inputs {ins} voxels, each adds "
          f"{added} (at most {det.backbone_3d.conv1[0].topk * 26} each); {kept} boxes kept")
    if kept < 1:
        raise AssertionError(f"{label} kept no box")
    return {"detect_ms": det_ms, "focal_inputs": ins, "focal_added": added, "kept": kept,
            "active": [int(v) for v in out["active_voxels"]]}


def single_stage(dev, card, s, vcn, seg, proj, l2c, image, g_pts, g_valid, g_gt) -> dict:
    """Phase 16: the tiny single-stage detectors and ATSS card vs CPU, then
    PointPillar and the multi-head SECONDNet at full width on the completed
    frame and in the train step, and the focal SECONDNet's eval forward."""
    res = {"tiny_vs_cpu": check_tiny_single_stage_against_cpu(dev),
           "tiny_steps_vs_cpu": check_tiny_single_stage_steps_against_cpu(dev),
           "atss": check_atss_against_cpu(dev)}
    for key in ("pointpillar", "second_multihead"):
        res[key] = serve_single_stage(dev, card, key, s, vcn, seg, proj, l2c, image)
        res[key]["train"] = train_single_stage(dev, card, key, g_pts, g_valid, g_gt)
    new_pts, new_valid, _ = F.complete_frame(s["points"], s["valid"], s["det_boxes"],
                                             s["det_masks"], s["det_scores"], vcn, proj, l2c,
                                             IMAGE_SIZE)
    res["second_focal"] = serve_second_focal(dev, card, new_pts, new_valid)
    return res


# CenterPoint and Voxel R-CNN (phase 17)

CENTER_RCNN = {"centerpoint": ("CenterPoint", DC.centerpoint_detector_cfg,
                               DC.tiny_centerpoint_cfg),
               "voxel_rcnn": ("Voxel R-CNN", DC.voxel_rcnn_detector_cfg,
                              DC.tiny_voxel_rcnn_cfg)}
#: the eval outputs phase 17 checks finite and holds card vs CPU
CENTER_RCNN_OUT = {"centerpoint": ("batch_box_preds", "batch_cls_preds",
                                   "spatial_features_2d"),
                   "voxel_rcnn": ("batch_cls_preds", "batch_box_preds", "rcnn_cls",
                                  "rcnn_reg", "rois")}


def tiny_center_rcnn_cfg(key: str):
    """The tiny config of ``key`` with DP_RATIO 0 (the card and the CPU draw
    no dropout)."""
    cfg = CENTER_RCNN[key][2]()
    if "ROI_HEAD" in cfg.MODEL:
        cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    return cfg


@torch.no_grad()
def check_tiny_center_rcnn_against_cpu(dev) -> dict:
    """The tiny CenterPoint and Voxel R-CNN (weights from seed 7 with random
    statistics, TF32 off) through ``detect_stage`` on the card against the
    port's CPU path (which the tests hold against JAX), Voxel R-CNN's
    ball-query members pinned to the CPU's: the decoded outputs (boxes,
    probabilities or logits, refined RoIs) within 1e-6 of a tensor's
    largest |value|, the head maps and BEV features within 1e-5 (the f32
    sums of cuDNN and the CPU's convolutions part by up to about 1e-6 of a
    one-channel map's largest); CenterPoint's decoded labels, Voxel
    R-CNN's proposals, and the kept sets and labels after post-processing
    equal. Returns the worst differences (relative to the largest) by
    detector."""
    cpu = torch.device("cpu")
    pts, valid = blob_points(4)
    worst, flips = {}, {}
    for key, (label, _, _) in CENTER_RCNN.items():
        cfg = tiny_center_rcnn_cfg(key)
        sd = seeded_state_dict(7, build_detector(cfg, device=cpu)[0], random_stats=True)

        def run(w, pinned=None):
            m, _ = build_detector(cfg, sd, device=w)
            with selection_choices(pinned) as chosen:
                res = F.detect_stage(m, cfg, torch.from_numpy(pts), torch.from_numpy(valid),
                                     device=w)
            return res, chosen

        (pp_c, out_c), chosen = run(cpu)
        (pp_d, out_d), _ = run(dev, chosen)
        flips[key] = selection_flips(run(dev)[1], chosen)
        decoded = [k for k in CENTER_RCNN_OUT[key] if k != "spatial_features_2d"]
        maps = {k: out_c[k] for k in out_c if k == "spatial_features_2d"}
        maps.update({f"head_out.{k}": v for k, v in out_c["head_out"].items()})
        got = {k: out_d[k].cpu() for k in decoded}
        got.update({k: out_d[k].cpu() for k in maps if k in out_d})
        got.update({f"head_out.{k}": v.cpu() for k, v in out_d["head_out"].items()})
        exact = ("batch_pred_labels",) if key == "centerpoint" else ("roi_mask", "roi_labels")
        rel = lambda r: r.abs().max().item() + 1e-30          # noqa: E731
        worst[key] = {"decoded": _worst(got, {k: out_c[k] for k in decoded}, rel),
                      "maps": _worst(got, maps, rel)}
        for part, tol in (("decoded", 1e-6), ("maps", 1e-5)):
            if worst[key][part][0] > tol:
                raise AssertionError(f"tiny {label}: {worst[key][part][1]} off the CPU by "
                                     f"{worst[key][part][0]:.3g} of its largest")
        for k in exact + ("pred_mask", "pred_labels"):
            src_d, src_c = (out_d, out_c) if k in exact else (pp_d, pp_c)
            if not torch.equal(src_d[k].cpu(), src_c[k]):
                raise AssertionError(f"tiny {label}: {k} differs from the CPU's")
        if not pp_c["pred_mask"].any():
            raise AssertionError(f"tiny {label} kept no box")
    print("tiny CenterPoint and Voxel R-CNN eval, card vs CPU (TF32 off, Voxel R-CNN's "
          "ball-query members pinned to the CPU's): worst |diff| / largest, decoded outputs "
          "(bound 1e-6) and head maps and BEV features (1e-5): "
          + ", ".join(f"{k} {v['decoded'][0]:.3g} ({v['decoded'][1]}), {v['maps'][0]:.3g} "
                      f"({v['maps'][1]})" for k, v in worst.items())
          + "; decoded labels, proposals, kept boxes and labels equal; rows the unpinned "
          f"card chose otherwise {flips}")
    return {k: {part: w[0] for part, w in v.items()} for k, v in worst.items()}


def check_tiny_center_rcnn_steps_against_cpu(dev) -> dict:
    """One train step of the tiny CenterPoint (the single-stage inputs:
    cars, a pedestrian, a cyclist) and the tiny Voxel R-CNN (cars near its
    training proposals, fixed RoI priorities, DP_RATIO 0, its ball-query
    members pinned to the CPU's), weights from seed 8 with random
    statistics, held by ``hold_tiny_step`` at 1e-5 (loss terms) and 5e-4
    (gradients)."""
    out = {}
    for key, (label, _, _) in CENTER_RCNN.items():
        cfg = tiny_center_rcnn_cfg(key)
        sd = seeded_state_dict(8, build_detector(cfg, device="cpu")[0], random_stats=True)
        rcnn = key == "voxel_rcnn"
        if rcnn:
            pts, valid, gt = pvrcnn_train_inputs(cfg, sd)
            n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
            u = np.random.RandomState(9).rand(2, n_rois).astype(np.float32)
        else:
            pts, valid, gt = single_stage_train_inputs()
            u = np.zeros((2, 1), np.float32)
        out[key], terms = hold_tiny_step(
            dev, label, cfg, sd, (pts, valid, gt, u), pin_queries=rcnn,
            note=", DP_RATIO 0, fixed RoI priorities" if rcnn else "")
        fg = "rcnn_loss_reg" if rcnn else "loc_loss"
        if terms[fg].item() <= 0:
            raise AssertionError(f"tiny {label} step: no foreground ({fg} 0)")
    return out


def center_rcnn_stages(model, cfg, points, valid) -> tuple:
    """The eval forward and post-processing of CenterPoint or Voxel R-CNN,
    stage by stage, each between synchronizes: {stage: (CUDA-event ms, host
    ms)}, and the state the callers read. Both: voxelize, backbone_3d (with
    the height compression), bev_backbone, head (CenterPoint's center head;
    Voxel R-CNN's anchor head with its box decoding); CenterPoint: decode
    (the max-pool and the top k), post_processing (its final NMS); Voxel
    R-CNN: proposals (the proposal NMS), pool_{stage} for each source (its
    ball query and SA layer, PRE_MLP with it), rcnn_head, post_processing."""
    times = {}

    stage = functools.partial(timed_stage, times)

    dcfg, b = model.cfg, points.shape[0]
    with torch.no_grad():
        st = stage("voxelize", lambda: SP.make_sparse_tensor(*voxelize_batch(
            points, valid, point_cloud_range=dcfg.point_cloud_range,
            voxel_size=dcfg.voxel_size, max_voxels=dcfg.max_voxels,
            max_points_per_voxel=dcfg.max_points_per_voxel), dcfg.sparse_shape, b))
        bb = stage("backbone_3d", lambda: model.backbone_3d(st))
        bev = height_compression(bb["encoded_spconv_tensor"])
        bev2d = stage("bev_backbone", lambda: model.backbone_2d(bev.float()))
        head_out = stage("head", lambda: model.dense_head(bev2d))
        state = {"ms3d": bb["multi_scale_3d_features"], "bev": bev}
        if "ROI_HEAD" not in cfg.MODEL:
            out = stage("decode", lambda: model.decode(head_out))
        else:
            cls_p, box_p = stage("head_decode", lambda: dcfg.head_logic.predict_boxes(head_out))
            props = stage("proposals", lambda: RH.proposal_layer(
                cls_p, box_p, cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST))
            rois = props["rois"][..., :7]
            head = model.roi_head
            width = PV.jax_stage_width(dcfg, b)
            pooled = [stage(f"pool_{n}", lambda n=n: head.pool_source(
                n, rois, state["ms3d"][n], width)) for n in head.sources]
            cls, reg = stage("rcnn_head", lambda: head.head(torch.cat(pooled, -1)))
            out = {**props, "rois": PVH.decode_rcnn_boxes(rois, reg), "rcnn_iou": cls}
            state.update(rois=rois, width=width)
        stage("post_processing", lambda: post_processing(
            out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES), "ROI_HEAD" in cfg.MODEL))
    return times, state


def time_roi_pools(model, state) -> dict:
    """Each Voxel R-CNN source alone on the frame's proposals (CUDA events,
    median of 3): its ball query (every grid point of every RoI against the
    stage's active voxel centres, at JAX's width) beside its bound, the f32
    (queries x supports) distance pass written once at 3.35 TB/s, and its
    whole pool (PRE_MLP, query, grouping, MLP, max)."""
    head, rois, width = model.roi_head, state["rois"], state["width"]
    grid = PVH.roi_grid_points(rois[0], head.grid_size).reshape(-1, 3)
    res = {}
    with torch.no_grad():
        for n in head.sources:
            st = state["ms3d"][n]
            sup = head.centres(n, st, rois.dtype)[st.mask]
            layer = head.get_submodule(f"pool_{n}")
            q, m = grid.shape[0], sup.shape[0]
            res[n] = {
                "queries": q, "supports": m, "radius": layer.radii[0],
                "ball_query_ms": time_cuda(lambda: PN2.ball_query_multi(
                    grid, sup, layer.radii, layer.nsamples, width=width), reps=3, warmup=0),
                "ball_query_bound_ms": q * m * 4 / HBM_BYTES_PER_S * 1e3,
                "pool_ms": time_cuda(lambda: head.pool_source(n, rois, st, width),
                                     reps=3, warmup=0)}
    return res


def time_first_bev_conv(model, bev) -> dict:
    """The BEV backbone's first 3x3 conv alone on the frame's BEV map
    (cuDNN, f32, TF32 off; CUDA events, median of 3), beside its FLOP bound
    at 67 TFLOP/s: the shape ROADMAP Next item 2 asks about."""
    conv = model.backbone_2d.blocks[0][1]
    x = torch.nn.functional.pad(bev.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    with torch.no_grad():
        ms = time_cuda(lambda: conv(x), reps=3, warmup=1)
    _, cin, h, w = x.shape
    cout = conv.weight.shape[0]
    oh, ow = (h - 3) // conv.stride[0] + 1, (w - 3) // conv.stride[1] + 1
    flops = 2 * cin * cout * 9 * oh * ow
    return {"shape": f"{cin} -> {cout} at {oh}x{ow}", "ms": ms,
            "bound_ms": flops / FP32_FLOPS * 1e3}


def time_center_head_convs(model, bev) -> dict:
    """CenterPoint's head on the frame's BEV features (cuDNN, f32, TF32 off;
    CUDA events, median of 3): the whole head, then each conv alone on its
    own input as a contiguous NCHW tensor (as the head runs it) and with
    channels-last strides (the NCHW view of an NHWC map): {"head_ms": ms,
    "convs": {name: (shape, ms contiguous, ms channels-last)}}."""
    head = model.dense_head
    convs_ms = {}
    with torch.no_grad():
        bev2d = model.backbone_2d(bev.float())
        x = bev2d.permute(0, 3, 1, 2).contiguous()
        whole = time_cuda(lambda: head(bev2d), reps=3, warmup=1)
        convs = [("shared_conv", head.shared_conv, x)]
        h = head.relu(head.shared_bn(head.shared_conv(x)))
        for name in head.sep.heads:
            c0 = head.sep.get_submodule(f"{name}_conv0")
            convs += [(f"{name}_conv0", c0, h),
                      (f"{name}_out", head.sep.get_submodule(f"{name}_out"), head.relu(c0(h)))]
        for name, conv, inp in convs:
            last = inp.contiguous(memory_format=torch.channels_last)
            convs_ms[name] = (f"{conv.in_channels} -> {conv.out_channels} at "
                              f"{inp.shape[2]}x{inp.shape[3]}",
                              time_cuda(lambda: conv(inp), reps=3, warmup=1),
                              time_cuda(lambda: conv(last), reps=3, warmup=1))
    return {"head_ms": whole, "convs": convs_ms}


def serve_center_rcnn(dev, card, key, s, vcn, seg, proj, l2c, image) -> dict:
    """Phase 17 serving of ``key`` (centerpoint or voxel_rcnn, its full
    config, weights from seed 0) on the SEE frame's completed cloud:
    ``see_and_detect`` and ``run_frame`` (K1 counted in each, peak memory),
    ``detect_stage`` timed (CUDA events, median of DETECT_REPS) and its
    stages, the first BEV conv alone, Voxel R-CNN's pools alone, the active
    voxels against the cap and against JAX's extraction capacity, device
    busy and top ops; the SEE + detector and fused frames (host, one run)."""
    label, full, _ = CENTER_RCNN[key]
    cfg = full()
    det, dcfg = build_detector(cfg, device="cpu")
    det, _ = build_detector(cfg, seeded_state_dict(0, det), device=dev)
    fr = detector_frames(det, cfg, label, s, vcn, seg, proj, l2c, image,
                         finite=CENTER_RCNN_OUT[key])
    pp, out, new_pts, new_valid = (fr[k] for k in ("pp", "out", "new_pts", "new_valid"))
    active = [int(v) for v in out["active_voxels"]]
    jax_capacity = PV.jax_stage_width(dcfg, 1)
    kept = int(pp["pred_mask"].sum())
    labels = torch.bincount(pp["pred_labels"][0][pp["pred_mask"][0]].long(),
                            minlength=dcfg.num_class + 1)[1:].tolist()
    rows = out["batch_box_preds"].shape[1]
    want = int(cfg.MODEL.POST_PROCESSING.MAX_OBJ_PER_SAMPLE) if key == "centerpoint" \
        else dcfg.head_logic.anchors_flat.shape[0]
    if rows != want or kept < 1 or active[0] < 1000:
        raise AssertionError(f"{label} did no real work: {rows} rows, active {active}, "
                             f"{kept} kept")
    over = [f"conv{i}" for i, a in enumerate(active[1:5], start=1) if a > jax_capacity]
    extra = f"; {int(out['roi_mask'].sum())} proposals" if key == "voxel_rcnn" else ""
    print(f"{label} at full width on the SEE frame's {int(new_valid.sum())} valid points "
          f"(see_and_detect): kernel launches {fr['launches']}; active voxels input / "
          f"conv1-4 / conv_out {active} (cap {dcfg.max_voxels}; JAX's extraction capacity "
          f"{jax_capacity}: over it {over}){extra}; {kept} boxes kept (by class {labels}); "
          f"peak device memory {fr['peak']:.2f} GiB")
    print(f"fused frame with {label} (run_frame): kernel launches {fr['fused_launches']}; "
          f"{fr['spliced_f']} completions spliced, {fr['kept_f']} boxes kept")
    pts, vld = new_pts[None], new_valid[None]
    stages, state = time_stages(center_rcnn_stages, det, cfg, pts, vld)
    conv = time_first_bev_conv(det, state["bev"])
    pools = time_roi_pools(det, state) if key == "voxel_rcnn" else {}
    head_convs = time_center_head_convs(det, state["bev"]) if key == "centerpoint" else {}
    det_ms = time_cuda(lambda: F.detect_stage(det, cfg, new_pts, new_valid),
                       reps=DETECT_REPS)
    fd_ms = host_ms(lambda: F.see_and_detect(*fr["args"], det, cfg, IMAGE_SIZE),
                    reps=FRAME_REPS)
    ff_ms = host_ms(lambda: F.run_frame(image, s["points"], s["valid"], seg, vcn, det,
                                        cfg, proj, l2c), reps=FRAME_REPS)
    busy, top = profile_kernels((det, cfg, new_pts, new_valid), F.detect_stage)
    print(f"{label} stages, CUDA-event / host ms (median of 3, each between "
          "synchronizes): " + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b)
                                        in stages.items()))
    print(f"{label} first BEV conv alone ({conv['shape']}, cuDNN f32): {conv['ms']:.3f} ms "
          f"(CUDA events, median of 3), bound {conv['bound_ms']:.4f} ms at 67 TFLOP/s")
    if head_convs:
        print(f"{label} head (cuDNN f32, CUDA events, median of 3) {head_convs['head_ms']:.3f} "
              "ms; each conv alone, contiguous NCHW / channels-last input: " + ", ".join(
                  f"{n} ({sh}) {a:.3f} / {b:.3f} ms"
                  for n, (sh, a, b) in head_convs["convs"].items()))
    for n, p in pools.items():
        print(f"{label} pool {n} alone ({p['queries']} grid points x {p['supports']} voxel "
              f"centres, r {p['radius']}): ball query {p['ball_query_ms']:.2f} ms, bound "
              f"{p['ball_query_bound_ms']:.4f} ms (the f32 distance pass at 3.35 TB/s); the "
              f"whole pool {p['pool_ms']:.2f} ms (CUDA events, median of 3)")
    print(f"{label} detect_stage {det_ms:.2f} ms (CUDA events, median of {DETECT_REPS}); SEE "
          f"+ {label} frame {fd_ms:.2f} ms, fused frame with {label} {ff_ms:.2f} ms (host "
          f"clock, one run) on {card}; profiled "
          f"detect_stage: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top))
    return {"launches": fr["launches"], "fused_launches": fr["fused_launches"],
            "active": active, "cap": dcfg.max_voxels, "jax_extract_capacity": jax_capacity,
            "kept": kept, "kept_by_class": labels, "peak_gib": fr["peak"],
            "stage_ms": stages, "first_bev_conv": conv, "pools": pools,
            "head_convs": head_convs,
            "detect_ms": det_ms, "see_detect_frame_ms": fd_ms, "fused_frame_ms": ff_ms,
            "device_busy_ms": busy, "top_ops": top}


def train_center_rcnn(dev, card, key, pts, valid, gt, steps: int = TIMED_STEPS) -> dict:
    """Phase 17 training of ``key`` at full width (f32, the config's batch:
    CenterPoint 4, Voxel R-CNN 2; the train voxel cap; weights from seed 0)
    on the GT-completed frames: 1 + 1 + ``steps`` train steps (step 1
    checked, a warm-up, the timed steps), one split by CUDA events, one
    profiled. Raises unless every loss is finite and every parameter moved
    after step 1, but CenterPoint's ``BIAS_BEFORE_BN`` and Voxel R-CNN's box
    branch where step 1 sampled no foreground RoI, each only while its
    gradient is all zero."""
    label, full, _ = CENTER_RCNN[key]
    cfg = full()
    batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    pts, valid, gt = pts[:batch], valid[:batch], gt[:batch]
    cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    cpu_model, _ = build_detector(cfg, max_voxels=cap, device="cpu")
    model, _ = build_detector(cfg, seeded_state_dict(0, cpu_model), max_voxels=cap,
                              device=dev)
    state = create_train_state(model, cfg.OPTIMIZATION, total_steps=1000)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, tb, out = train_forward(state, pts, valid, gt, gen)
    apply_gradients(state, loss)
    losses = [{"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}]
    for n, p in model.named_parameters():
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"{label}: gradient of {n} is not finite")
    excused = (BIAS_BEFORE_BN,)
    if key == "voxel_rcnn" and tb["rcnn_loss_reg"].item() == 0:
        excused += ("roi_head.reg_",)
    idle = check_moved(model, start, excused, f"{label} train step 1")
    train_step(state, pts, valid, gt, gen)                  # warm-up
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
    busy, top = profile_kernels((state, pts, valid, gt, gen), train_step)
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"a {label} training loss is not finite")
    step_ms = statistics.median(times)
    summary = {"step_ms": step_ms, "frames_per_s": batch * 1e3 / step_ms,
               "step_ms_all": times, "split_ms": split, "peak_gib": peak,
               "device_busy_ms": busy, "top_ops": top,
               "losses": [m["loss"] for m in values], "last_terms": values[-1],
               "idle": idle, "voxel_cap": cap,
               "active": [int(v) for v in out["active_voxels"]]}
    if key == "voxel_rcnn":
        tg = out["rcnn_targets"]
        summary.update(proposals=out["roi_mask"].sum(1).tolist(),
                       sampled_fg=(tg["roi_sample_mask"] & tg["reg_valid_mask"]).sum(1).tolist())
    print(f"{label} train steps at batch {batch} (full width, f32, train cap {cap}) on "
          f"GT-completed frames: losses " + ", ".join(f"{v:.4f}" for v in summary["losses"])
          + "; last terms " + ", ".join(f"{k} {v:.4f}" for k, v in values[-1].items())
          + f"; active {summary['active']}"
          + (f"; proposals {summary['proposals']}, sampled fg {summary['sampled_fg']}"
             if key == "voxel_rcnn" else "")
          + f"; parameters still after step 1 (all-zero gradient, excused): {idle}")
    print(f"{label} train step {step_ms:.2f} ms (host clock to a synchronize, median of "
          f"{steps} after a warm-up) = {summary['frames_per_s']:.2f} frames/s; CUDA events: "
          f"forward {split['forward']:.2f} ms, loss {split['loss']:.2f} ms, backward + update "
          f"{split['backward_update']:.2f} ms; peak device memory {peak:.2f} GiB; profiled "
          f"step: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + f" on {card}")
    return summary


def center_rcnn(dev, card, s, vcn, seg, proj, l2c, image, g_pts, g_valid, g_gt) -> dict:
    """Phase 17: the tiny CenterPoint and Voxel R-CNN card vs CPU (eval and
    one train step), then each at full width on the completed frame and in
    the train step."""
    parts, t0 = {}, time.time()
    res = {"tiny_vs_cpu": check_tiny_center_rcnn_against_cpu(dev),
           "tiny_steps_vs_cpu": check_tiny_center_rcnn_steps_against_cpu(dev)}
    parts["tiny"] = time.time() - t0
    for key in CENTER_RCNN:
        t0 = time.time()
        res[key] = serve_center_rcnn(dev, card, key, s, vcn, seg, proj, l2c, image)
        parts[f"{key}_serve"], t0 = time.time() - t0, time.time()
        res[key]["train"] = train_center_rcnn(dev, card, key, g_pts, g_valid, g_gt)
        parts[f"{key}_train"] = time.time() - t0
    res["part_s"] = parts
    print("phase 17 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return res


# --- phase 18: PointRCNN and Part-A2 --------------------------------------------

POINT_PART = {"pointrcnn": ("PointRCNN", DC.pointrcnn_detector_cfg, DC.tiny_pointrcnn_cfg),
              "parta2": ("Part-A2", DC.parta2_detector_cfg, DC.tiny_parta2_cfg)}
#: the eval outputs phase 18 checks finite and holds card vs CPU: the
#: decoded boxes, and the heads' logits and residuals
POINT_PART_OUT = {"pointrcnn": ("batch_box_preds", "rois", "batch_cls_preds", "rcnn_cls",
                                "rcnn_reg"),
                  "parta2": ("batch_box_preds", "rois", "batch_cls_preds", "seg_logits",
                             "part_reg", "rcnn_cls", "rcnn_reg")}
#: the tiny checks' bounds (relative to the largest) that differ from 1e-6
#: (eval outputs) and 1e-5 (loss terms): those of the output and the term
#: that the card's f32 run strays past the common bound in, set at twice
#: their own f32 error, the CPU's f32 run against its f64 run on the same
#: input (two f32 results each within e of the exact one part by up to
#: 2e); the checks print that error beside (PointRCNN's rcnn_cls 4.97e-6,
#: Part-A2's rcnn_loss_reg 6.54e-6)
POINT_PART_EVAL_TOLS = {"pointrcnn": {"rcnn_cls": 1e-5}}
POINT_PART_LOSS_TOLS = {"parta2": {"rcnn_loss_reg": 1.5e-5}}


def tiny_point_part_cfg(key: str):
    cfg = POINT_PART[key][2]()
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    return cfg


def three_nn_drift(got: list, ref: list) -> float:
    """The largest |difference| (m^2) between two records of ``three_nn``
    (of ``selection_choices``) in the distances of the same picks."""
    return max(((d - e).abs()[(i == j) & torch.isfinite(e)].max().item()
                for (i, d), (j, e) in zip(got, ref)), default=0.0)


@torch.no_grad()
def check_tiny_point_part_against_cpu(dev) -> dict:
    """The tiny PointRCNN and Part-A2 (weights from seed 7 with random
    statistics, TF32 off) through ``detect_stage`` on the card against the
    port's CPU path (which the tests hold against JAX), the picks of
    ``selection_choices`` pinned to the CPU's (three-NN's distances are the
    card's own): the decoded boxes and the heads' logits and residuals
    within 1e-6 of a tensor's largest |value| (``POINT_PART_EVAL_TOLS``
    names the others; the CPU's f32 run against its f64 run is printed
    beside); the proposals, and the kept sets and labels after
    post-processing, equal. Returns the worst differences (relative to the
    largest) by detector."""
    cpu = torch.device("cpu")
    pts, valid = blob_points(4)
    worst, own, flips, drift = {}, {}, {}, {}
    rel = lambda r: r.abs().max().item() + 1e-30          # noqa: E731
    for key, (label, _, _) in POINT_PART.items():
        cfg = tiny_point_part_cfg(key)
        sd = seeded_state_dict(7, build_detector(cfg, device=cpu)[0], random_stats=True)

        def run(w, pinned=None, dtype=torch.float32):
            m, _ = build_detector(cfg, sd, device=w)
            with selection_choices(pinned) as chosen:
                res = F.detect_stage(m.to(dtype), cfg, torch.from_numpy(pts).to(dtype),
                                     torch.from_numpy(valid), device=w)
            return res, chosen

        (pp_c, out_c), chosen = run(cpu)
        (pp_d, out_d), chosen_d = run(dev, chosen)
        out_64 = run(cpu, chosen, torch.float64)[0][1]
        flips[key] = selection_flips(run(dev)[1], chosen)
        drift[key] = three_nn_drift(chosen_d[f"{SMP.__name__}.three_nn"],
                                    chosen[f"{SMP.__name__}.three_nn"]) \
            if key == "pointrcnn" else None
        ks = POINT_PART_OUT[key]
        worst[key] = {k: _worst({k: out_d[k].cpu()}, {k: out_c[k]}, rel)[0] for k in ks}
        own[key] = {k: _worst({k: out_c[k]}, {k: out_64[k]}, rel)[0] for k in ks}
        tols = {k: POINT_PART_EVAL_TOLS.get(key, {}).get(k, 1e-6) for k in ks}
        over = [k for k in ks if worst[key][k] > tols[k]]
        if over:
            raise AssertionError(f"tiny {label}: " + ", ".join(
                f"{k} off the CPU by {worst[key][k]:.3g} of its largest (bound {tols[k]:g})"
                for k in over))
        for k in ("roi_mask", "roi_labels", "pred_mask", "pred_labels"):
            src_d, src_c = (out_d, out_c) if k.startswith("roi") else (pp_d, pp_c)
            if not torch.equal(src_d[k].cpu(), src_c[k]):
                raise AssertionError(f"tiny {label}: {k} differs from the CPU's")
        if not pp_c["pred_mask"].any():
            raise AssertionError(f"tiny {label} kept no box")
    print("tiny PointRCNN and Part-A2 eval, card vs CPU (TF32 off, the picks pinned to the "
          "CPU's, three-NN's distances the card's own): |diff| / largest by output (bound "
          f"1e-6; otherwise {POINT_PART_EVAL_TOLS}): " + "; ".join(
              f"{key} " + ", ".join(f"{k} {v:.3g}" for k, v in w.items())
              for key, w in worst.items())
          + "; the CPU's own f32 run against its f64 run: " + "; ".join(
              f"{key} " + ", ".join(f"{k} {v:.3g}" for k, v in w.items())
              for key, w in own.items())
          + f"; PointRCNN's three-NN distances of the same picks, card vs CPU, at most "
          f"{drift['pointrcnn']:.3g} m^2 apart; proposals, kept boxes and "
          f"labels equal; rows the unpinned card chose otherwise {flips}")
    return {"worst": worst, "cpu_f32_vs_f64": own, "three_nn_drift_m2": drift["pointrcnn"]}


def check_tiny_point_part_steps_against_cpu(dev) -> dict:
    """One train step of the tiny PointRCNN and Part-A2 (cars near their
    training proposals, fixed RoI priorities, DP_RATIO 0, the picks of
    ``selection_choices`` pinned to the CPU's), weights from seed 8 with
    random statistics, held by ``hold_tiny_step`` at 5e-4 (gradients) and
    1e-5 (loss terms; ``POINT_PART_LOSS_TOLS`` names the others). Each step
    has a foreground RoI, and Part-A2's a foreground voxel for its part
    head."""
    out = {}
    for key, (label, _, _) in POINT_PART.items():
        cfg = tiny_point_part_cfg(key)
        sd = seeded_state_dict(8, build_detector(cfg, device="cpu")[0], random_stats=True)
        if key == "pointrcnn":
            # the seeded residuals decode to boxes metres long on one side and
            # millimetres on another; a tenth of them keeps the proposals
            # box-shaped, so that ground truth beside one is foreground
            last = max(int(k.split(".")[2]) for k in sd if k.startswith("point_head.box_layers."))
            for leaf in ("weight", "bias"):
                sd[f"point_head.box_layers.{last}.{leaf}"] *= 0.1
        pts, valid, gt = pvrcnn_train_inputs(cfg, sd, relative=True)
        n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
        u = np.random.RandomState(9).rand(2, n_rois).astype(np.float32)
        out[key], terms = hold_tiny_step(
            dev, label, cfg, sd, (pts, valid, gt, u), pin_queries=True,
            loss_tols=POINT_PART_LOSS_TOLS.get(key), note=", DP_RATIO 0, fixed RoI priorities")
        if terms["rcnn_loss_reg"].item() <= 0:
            raise AssertionError(f"tiny {label} step: no foreground RoI")
        if key == "parta2" and terms["part_loss"].item() <= 0:
            raise AssertionError(f"tiny {label} step: no foreground voxel for the part head")
    return out


def check_inverse_conv_against_cpu(dev) -> dict:
    """``sparse_inverse_conv3d`` on the card against the CPU, forward and
    backward: a stride-2 conv of a random 2-frame sparse tensor (5 x 8 x 8,
    16 channels), then its inverse onto the input's rows (16 -> 32), the
    output and the gradients of the features and the weight within 1e-5
    of their largest."""
    rng = np.random.RandomState(0)
    occ = rng.rand(2, 5, 8, 8) < 0.2
    coords = torch.from_numpy(np.argwhere(occ).astype(np.int32))
    feats = torch.from_numpy(rng.randn(coords.shape[0], 16).astype(np.float32))
    w_down = torch.from_numpy((rng.randn(27, 16, 16) * 0.2).astype(np.float32))
    w_up = torch.from_numpy((rng.randn(27, 16, 32) * 0.2).astype(np.float32))
    dy = torch.from_numpy(rng.randn(coords.shape[0], 32).astype(np.float32))

    def run(w):
        st = SP.make_sparse_tensor(feats.to(w), coords.to(w), torch.ones(
            coords.shape[0], dtype=torch.bool, device=w), (5, 8, 8), 2)
        down = SP.sparse_conv3d(st, w_down.to(w), 3, 2, 1, out_capacity=SP.ALL)
        x = down.features.detach().requires_grad_(True)
        wu = w_up.to(w).clone().requires_grad_(True)
        with torch.enable_grad():
            y = SP.sparse_inverse_conv3d(down._replace(features=x), wu, st, 3, 2, 1).features
            y.backward(dy.to(w))
        return {"forward": y.detach().cpu(), "grad_features": x.grad.cpu(),
                "grad_weight": wu.grad.cpu()}

    ref, got = run(torch.device("cpu")), run(dev)
    worst = {k: (got[k] - ref[k]).abs().max().item() / (ref[k].abs().max().item() + 1e-30)
             for k in ref}
    print("sparse_inverse_conv3d card vs CPU (TF32 off): worst |diff| / largest "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + " (bound 1e-5)")
    if max(worst.values()) > 1e-5:
        raise AssertionError("sparse_inverse_conv3d on the card off the CPU")
    return worst


def pointrcnn_stages(model, cfg, points, valid) -> tuple:
    """PointRCNN's eval forward and post-processing stage by stage, each
    between synchronizes: fps{l} and sa{l} (its ball query, grouping and
    MLP) at each SA level, fp{l} (the three-NN interpolation and the MLP)
    from the deepest level up, point_head (with the box decoding),
    proposals (the 9,000 proposal NMS), roi_pool, rcnn_head and
    post_processing."""
    times = {}
    stage = functools.partial(timed_stage, times)
    bb = model.backbone_3d
    with torch.no_grad():
        xyz, feats, vld = [points[..., :3]], [None], [valid]
        for li in range(len(bb.SA_modules)):
            nx, nv = stage(f"fps{li}", lambda: bb.sample(li, xyz[-1], vld[-1]))
            feats.append(stage(f"sa{li}", lambda: bb.abstract(li, nx, xyz[-1], feats[-1],
                                                               vld[-1])))
            xyz.append(nx)
            vld.append(nv)
        up, ups = feats[-1], {}
        for li in range(len(bb.SA_modules) - 1, -1, -1):
            up = ups[li] = stage(f"fp{li}", lambda: bb.propagate(li, xyz[li], xyz[li + 1], up,
                                                                 vld[li + 1], feats[li]))
        head = model.point_head
        cls_p, reg_p = stage("point_head", lambda: head(up))
        boxes = model.coder.decode(reg_p, points[..., :3], cls_p.argmax(-1) + 1)
        props = stage("proposals", lambda: RH.proposal_layer(
            torch.where(valid[..., None], cls_p, -1e9), boxes,
            cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST))
        rois = props["rois"][..., :7]
        geo, pooled = stage("roi_pool", lambda: model.roi_head.pool(rois, points[..., :3], up,
                                                                    valid))
        cls, reg = stage("rcnn_head", lambda: model.roi_head.head(geo, pooled))
        out = {**props, "rois": PVH.decode_rcnn_boxes(rois, reg), "rcnn_iou": cls}
        stage("post_processing", lambda: post_processing(
            out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES), True))
    return times, {"xyz": xyz, "valid": vld, "fp_out": ups, "rois": rois}


def time_pointrcnn_ops(model, state) -> dict:
    """PointRCNN's ops alone on the frame (CUDA events, median of 3): each
    SA level's ball query (its queries against the level below's valid
    points, both radii) beside the (queries x supports) f32 distance pass
    at 3.35 TB/s; the three-NN interpolation of FP 0 beside its bound: the
    larger of its bytes (queries, supports and their features read once,
    the output written once) at 3.35 TB/s and its operations (11 a pair:
    the dot's 3 FMAs, the norms' 2 adds, 3 comparisons to pick 3) at 67
    TFLOP/s; and SA 0's FPS alone beside its bound, 9 operations a point a
    step."""
    bb, xyz, vld = model.backbone_3d, state["xyz"], state["valid"]
    res = {"ball_query": {}}
    with torch.no_grad():
        for li, layer in enumerate(bb.SA_modules):
            q, sup = xyz[li + 1][0], xyz[li][0][vld[li][0]]
            res["ball_query"][f"sa{li}"] = {
                "queries": q.shape[0], "supports": sup.shape[0],
                "ms": time_cuda(lambda: PN2.ball_query_multi(q, sup, layer.radii, layer.nsamples,
                                                             width=xyz[li].shape[1]),
                                reps=3, warmup=0),
                "bound_ms": q.shape[0] * sup.shape[0] * 4 / HBM_BYTES_PER_S * 1e3}
        q, s, f, v = xyz[0][0], xyz[1][0], state["fp_out"][1][0], vld[1][0]
        n, m, c = q.shape[0], s.shape[0], f.shape[1]
        byte_ms = (n * 12 + m * 12 + m * c * 4 + n * c * 4) / HBM_BYTES_PER_S * 1e3
        op_ms = 11 * n * m / FP32_FLOPS * 1e3
        bound, by = max((byte_ms, "bytes"), (op_ms, "operations"))
        res["three_nn"] = {"queries": n, "supports": m, "channels": c,
                           "ms": time_cuda(lambda: SMP.three_nn_interpolate(q, s, f, v), reps=3,
                                           warmup=1),
                           "bound_ms": bound, "bound_by": by}
        k, npts = bb.npoints[0], int(vld[0][0].sum())
        res["fps0"] = {"steps": k, "points": npts,
                       "ms": time_cuda(lambda: farthest_point_sample(xyz[0][:1], k, vld[0][:1]),
                                       reps=1, warmup=0),
                       "bound_ms": 9 * k * npts / FP32_FLOPS * 1e3}
    return res


def parta2_stages(model, cfg, points, valid) -> tuple:
    """Part-A2's eval forward and post-processing stage by stage, each
    between synchronizes: voxelize, unet_encoder, unet_decoder, part_head,
    bev_backbone (the height compression and the 2D backbone), head (the
    anchor head and its box decoding), proposals, roi_pool (both roiaware
    pools of every frame), rcnn_head and post_processing."""
    times = {}
    stage = functools.partial(timed_stage, times)
    dcfg, b = model.cfg, points.shape[0]
    unet = model.backbone_3d
    with torch.no_grad():
        st = stage("voxelize", lambda: SP.make_sparse_tensor(*voxelize_batch(
            points, valid, point_cloud_range=dcfg.point_cloud_range,
            voxel_size=dcfg.voxel_size, max_voxels=dcfg.max_voxels,
            max_points_per_voxel=dcfg.max_points_per_voxel), dcfg.sparse_shape, b))
        enc = stage("unet_encoder", lambda: VoxelBackBone8x.forward(unet, st))
        ms3d = enc["multi_scale_3d_features"]
        pf = stage("unet_decoder", lambda: unet.decode(ms3d))
        seg, part = stage("part_head", lambda: (model.seg_out(pf.features)[:, 0],
                                                model.part_out(pf.features)))
        bev = height_compression(enc["encoded_spconv_tensor"])
        bev2d = stage("bev_backbone", lambda: model.backbone_2d(bev.float()))
        cls_p, box_p = stage("head", lambda: dcfg.head_logic.predict_boxes(
            model.dense_head(bev2d)))
        props = stage("proposals", lambda: RH.proposal_layer(
            cls_p, box_p, cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST))
        rois = props["rois"][..., :7]
        feats = model.part_features(pf, seg, part)
        pooled = stage("roi_pool", lambda: model.pool(rois, pf, feats))
        cls, reg = stage("rcnn_head", lambda: model.roi_head(pooled))
        out = {**props, "rois": PVH.decode_rcnn_boxes(rois, reg), "rcnn_iou": cls}
        stage("post_processing", lambda: post_processing(
            out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES), True))
    return times, {"ms3d": ms3d, "pf": pf, "feats": feats, "rois": rois, "bev": bev}


def time_parta2_ops(model, state) -> dict:
    """Part-A2's ops alone on the frame (CUDA events, median of 3): each
    inverse conv (on its UR block's merged input, onto the stage below's
    rows); the two roiaware pools of frame 0 (avg over the 4 part and
    segmentation channels, max over the 16 features) beside their bound,
    the larger of their bytes (the rois, the voxel centres and features
    read once, the pooled grid written once) at 3.35 TB/s and their
    operations (20 a (RoI, voxel) pair: the rotation, the cell and its
    bounds) at 67 TFLOP/s."""
    unet, ms3d, pf = model.backbone_3d, state["ms3d"], state["pf"]
    res = {"inverse_convs": {}, "roiaware": {}}
    with torch.no_grad():
        x = ms3d["x_conv4"]
        for i, _, _, _ in unet.UR:
            merged = unet.ur_block(i, ms3d[f"x_conv{i}"], x)
            inv = unet.get_submodule(f"inv_conv{i}")
            target = ms3d[f"x_conv{i - 1}"]
            res["inverse_convs"][f"inv_conv{i}"] = {
                "rows": [int(merged.mask.sum()), int(target.mask.sum())],
                "ms": time_cuda(lambda: inv(merged, target), reps=3, warmup=1)}
            x = inv(merged, target)
        rows = pf.mask & (pf.coords[:, 0] == 0)
        c, f = model.centres(pf)[rows], state["feats"][rows]
        ok = torch.ones_like(c[:, 0], dtype=torch.bool)
        ro, g = state["rois"][0], model.roi_head.grid_size
        for method, part in (("avg", f[:, :4]), ("max", f[:, 4:])):
            n, ch, r = c.shape[0], part.shape[1], ro.shape[0]
            byte_ms = (r * 28 + n * (12 + ch * 4) + r * g ** 3 * ch * 4) / HBM_BYTES_PER_S * 1e3
            op_ms = 20 * r * n / FP32_FLOPS * 1e3
            bound, by = max((byte_ms, "bytes"), (op_ms, "operations"))
            res["roiaware"][method] = {
                "rois": r, "voxels": n, "channels": ch, "grid": g, "bound_ms": bound,
                "bound_by": by, "ms": time_cuda(lambda: RA.roiaware_pool3d(
                    ro, c, part, ok, g, method), reps=3, warmup=1)}
    return res


def serve_point_part(dev, card, key, s, vcn, seg, proj, l2c, image) -> dict:
    """Phase 18 serving of ``key`` (pointrcnn or parta2, its full config,
    weights from seed 0) on the SEE frame's completed cloud:
    ``see_and_detect`` and ``run_frame`` (K1 counted in each, peak memory),
    ``detect_stage`` timed (CUDA events, one run) and its stages (one
    run after the warm-up of the frames above), the ops alone, Part-A2's
    first BEV conv alone and its active voxels against the cap and JAX's
    extraction capacity, device busy and top ops, the SEE + detector and
    fused frames (host clock, one run after the counted runs);
    PointRCNN also at 16,384 points
    resampled from the frame by ``resample_points`` (seed 0)."""
    label, full, _ = POINT_PART[key]
    cfg = full()
    det, dcfg = build_detector(cfg, device="cpu")
    det, _ = build_detector(cfg, seeded_state_dict(0, det), device=dev)
    fr = detector_frames(det, cfg, label, s, vcn, seg, proj, l2c, image,
                         finite=POINT_PART_OUT[key])
    pp, out, new_pts, new_valid = (fr[k] for k in ("pp", "out", "new_pts", "new_valid"))
    kept = int(pp["pred_mask"].sum())
    labels = torch.bincount(pp["pred_labels"][0][pp["pred_mask"][0]].long(),
                            minlength=dcfg.num_class + 1)[1:].tolist()
    n_props = int(out["roi_mask"].sum())
    res = {"launches": fr["launches"], "fused_launches": fr["fused_launches"], "kept": kept,
           "kept_by_class": labels, "proposals": n_props, "peak_gib": fr["peak"]}
    pts, vld = new_pts[None], new_valid[None]
    if key == "pointrcnn":
        rows = out["batch_box_preds"].shape[1]
        if rows != new_pts.shape[0] or kept < 1 or n_props < 1:
            raise AssertionError(f"{label} did no real work: {rows} rows, {kept} kept")
        extra = f"{rows} points scored"
        stages, state = pointrcnn_stages(det, cfg, pts, vld)
        ops = time_pointrcnn_ops(det, state)
        gen = torch.Generator(device=dev).manual_seed(0)
        sub = SMP.resample_points(new_pts, new_valid, 16384, generator=gen)
        sub_ms = time_cuda(lambda: F.detect_stage(det, cfg, sub, torch.ones(
            16384, dtype=torch.bool, device=dev)), reps=1, warmup=0)
        res.update(resampled_16384_ms=sub_ms)
    else:
        active = [int(v) for v in out["active_voxels"]]
        jax_capacity = PV.jax_stage_width(dcfg, 1)
        if kept < 1 or active[0] < 1000 or n_props < 1:
            raise AssertionError(f"{label} did no real work: active {active}, {kept} kept")
        over = [f"conv{i}" for i, a in enumerate(active[1:5], start=1) if a > jax_capacity]
        extra = (f"active voxels input / conv1-4 / conv_out {active} (cap {dcfg.max_voxels}; "
                 f"JAX's extraction capacity {jax_capacity}: over it {over})")
        stages, state = parta2_stages(det, cfg, pts, vld)
        ops = time_parta2_ops(det, state)
        ops["first_bev_conv"] = time_first_bev_conv(det, state["bev"])
        res.update(active=active, cap=dcfg.max_voxels, jax_extract_capacity=jax_capacity)
    print(f"{label} at full width on the SEE frame's {int(new_valid.sum())} valid points "
          f"(see_and_detect): kernel launches {fr['launches']}; {extra}; {n_props} proposals; "
          f"{kept} boxes kept (by class {labels}); peak device memory {fr['peak']:.2f} GiB")
    print(f"fused frame with {label} (run_frame): kernel launches {fr['fused_launches']}; "
          f"{fr['spliced_f']} completions spliced, {fr['kept_f']} boxes kept")
    det_ms = time_cuda(lambda: F.detect_stage(det, cfg, new_pts, new_valid), reps=FRAME_REPS,
                       warmup=0)
    fd_ms = host_ms(lambda: F.see_and_detect(*fr["args"], det, cfg, IMAGE_SIZE),
                    reps=FRAME_REPS)
    ff_ms = host_ms(lambda: F.run_frame(image, s["points"], s["valid"], seg, vcn, det, cfg,
                                        proj, l2c), reps=FRAME_REPS)
    busy, top = profile_kernels((det, cfg, new_pts, new_valid), F.detect_stage)
    print(f"{label} stages, CUDA-event / host ms (one run, each between synchronizes): "
          + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in stages.items()))
    if key == "pointrcnn":
        print(f"{label} ops alone (CUDA events): ball query " + ", ".join(
            f"{n} ({b['queries']} x {b['supports']}) {b['ms']:.2f} ms (bound {b['bound_ms']:.4f})"
            for n, b in ops["ball_query"].items())
            + f"; three-NN interpolation at FP 0 ({ops['three_nn']['queries']} x "
            f"{ops['three_nn']['supports']}, {ops['three_nn']['channels']} channels) "
            f"{ops['three_nn']['ms']:.2f} ms, bound {ops['three_nn']['bound_ms']:.4f} ms "
            f"({ops['three_nn']['bound_by']}); FPS at SA 0 ({ops['fps0']['steps']} steps over "
            f"{ops['fps0']['points']} points) {ops['fps0']['ms']:.2f} ms, bound "
            f"{ops['fps0']['bound_ms']:.4f} ms; detect_stage at 16,384 resampled points "
            f"{res['resampled_16384_ms']:.2f} ms (one run)")
    else:
        conv = ops["first_bev_conv"]
        print(f"{label} ops alone (CUDA events, median of 3): inverse convs " + ", ".join(
            f"{n} (rows {v['rows']}) {v['ms']:.2f} ms" for n, v in ops["inverse_convs"].items())
            + "; roiaware pools of frame 0 " + ", ".join(
                f"{m} ({v['rois']} RoIs x {v['voxels']} voxels, {v['channels']} channels, "
                f"{v['grid']}^3) {v['ms']:.3f} ms, bound {v['bound_ms']:.4f} ms ({v['bound_by']})"
                for m, v in ops["roiaware"].items())
            + f"; first BEV conv ({conv['shape']}, cuDNN f32) {conv['ms']:.3f} ms, bound "
            f"{conv['bound_ms']:.4f} ms at 67 TFLOP/s")
    print(f"{label} detect_stage {det_ms:.2f} ms (CUDA events, one run); SEE + {label} "
          f"frame {fd_ms:.2f} ms, fused frame with {label} {ff_ms:.2f} ms (host clock, one run "
          f"after the counted runs) on {card}; profiled detect_stage: device "
          f"busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top))
    res.update(stage_ms=stages, ops=ops, detect_ms=det_ms, see_detect_frame_ms=fd_ms,
               fused_frame_ms=ff_ms, device_busy_ms=busy, top_ops=top)
    return res


def train_point_part(dev, card, key, pts, valid, gt, steps: int = TIMED_STEPS) -> dict:
    """Phase 18 training of ``key`` at full width (f32, the config's batch:
    PointRCNN 2, Part-A2 4 at its train voxel cap; weights from seed 0) on
    the GT-completed frames: 1 + 1 + ``steps`` train steps (step 1 checked,
    a warm-up, the timed steps), one split by CUDA events, one profiled.
    Raises unless every loss is finite and every parameter moved after step
    1, but the RoI head's box branch where step 1 sampled no foreground
    RoI, and Part-A2's ``part_out`` where no kept voxel's centre lies in a
    ground-truth box (its part loss 0), each only while its gradient is all
    zero."""
    label, full, _ = POINT_PART[key]
    cfg = full()
    batch = int(cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU)
    pts, valid, gt = pts[:batch], valid[:batch], gt[:batch]
    cap = None
    if key == "parta2":
        cap = int(cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    cpu_model, _ = build_detector(cfg, max_voxels=cap, device="cpu")
    model, _ = build_detector(cfg, seeded_state_dict(0, cpu_model), max_voxels=cap, device=dev)
    state = create_train_state(model, cfg.OPTIMIZATION, total_steps=1000)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, tb, out = train_forward(state, pts, valid, gt, gen)
    apply_gradients(state, loss)
    losses = [{"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}]
    for n, p in model.named_parameters():
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"{label}: gradient of {n} is not finite")
    excused = ("roi_head.reg_",) if tb["rcnn_loss_reg"].item() == 0 else ()
    if key == "parta2" and tb["part_loss"].item() == 0:
        excused += ("part_out.",)
    idle = check_moved(model, start, excused, f"{label} train step 1")
    train_step(state, pts, valid, gt, gen)                  # warm-up
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
    busy, top = profile_kernels((state, pts, valid, gt, gen), train_step)
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"a {label} training loss is not finite")
    step_ms = statistics.median(times)
    tg = out["rcnn_targets"]
    summary = {"step_ms": step_ms, "frames_per_s": batch * 1e3 / step_ms,
               "step_ms_all": times, "split_ms": split, "peak_gib": peak,
               "device_busy_ms": busy, "top_ops": top,
               "losses": [m["loss"] for m in values], "last_terms": values[-1],
               "idle": idle, "proposals": out["roi_mask"].sum(1).tolist(),
               "sampled_fg": (tg["roi_sample_mask"] & tg["reg_valid_mask"]).sum(1).tolist()}
    if key == "parta2":
        fg, _ = model.part_targets(out["_voxel_tensor"], gt)
        summary.update(voxel_cap=cap, active=[int(v) for v in out["active_voxels"]],
                       foreground_voxels=int(fg.sum()))
    print(f"{label} train steps at batch {batch} (full width, f32"
          + (f", train cap {cap}" if cap else "") + ") on GT-completed frames: losses "
          + ", ".join(f"{v:.4f}" for v in summary["losses"])
          + "; last terms " + ", ".join(f"{k} {v:.4f}" for k, v in values[-1].items())
          + (f"; active {summary['active']}, foreground voxels "
             f"{summary['foreground_voxels']}" if cap else "")
          + f"; proposals {summary['proposals']}, sampled fg {summary['sampled_fg']}"
          + f"; parameters still after step 1 (all-zero gradient, excused): {idle}")
    print(f"{label} train step {step_ms:.2f} ms (host clock to a synchronize, median of "
          f"{steps} after a warm-up) = {summary['frames_per_s']:.2f} frames/s; CUDA events: "
          f"forward {split['forward']:.2f} ms, loss {split['loss']:.2f} ms, backward + update "
          f"{split['backward_update']:.2f} ms; peak device memory {peak:.2f} GiB; profiled "
          f"step: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + f" on {card}")
    return summary


def point_part(dev, card, s, vcn, seg, proj, l2c, image, g_pts, g_valid, g_gt) -> dict:
    """Phase 18: the tiny PointRCNN and Part-A2 card vs CPU (eval and one
    train step) and the inverse conv card vs CPU, then each at full width
    on the completed frame and in the train step."""
    parts, t0 = {}, time.time()
    res = {"tiny_vs_cpu": check_tiny_point_part_against_cpu(dev),
           "tiny_steps_vs_cpu": check_tiny_point_part_steps_against_cpu(dev),
           "inverse_conv_vs_cpu": check_inverse_conv_against_cpu(dev)}
    parts["tiny"] = time.time() - t0
    for key in POINT_PART:
        t0 = time.time()
        res[key] = serve_point_part(dev, card, key, s, vcn, seg, proj, l2c, image)
        parts[f"{key}_serve"], t0 = time.time() - t0, time.time()
        res[key]["train"] = train_point_part(dev, card, key, g_pts, g_valid, g_gt)
        parts[f"{key}_train"] = time.time() - t0
    res["part_s"] = parts
    print("phase 18 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return res


# --- phase 19: CaDDN and the KITTI data path ------------------------------------------

#: the tiny CaDDN's two image backbones (configs.tiny_caddn_cfg)
CADDN_FORMS = {"image": "ImageBackbone", "resnet_tiny": "DeepLabV3 on ResNetTiny"}
#: the eval outputs phase 19 holds card vs CPU
CADDN_OUT = ("depth_logits", "batch_cls_preds", "batch_box_preds")
#: the tiny checks' bounds (relative to the largest) that differ from 1e-6
#: (eval outputs) and 1e-5 (loss terms), as POINT_PART_EVAL_TOLS: those of
#: the output that the card's f32 run strays past the common bound in, set
#: at twice its own f32 error, the CPU's f32 run against its f64 run on the
#: same input, which the check prints beside (the ImageBackbone's depth
#: logits 1.04e-6 off the CPU, their own error 7.3e-7)
CADDN_EVAL_TOLS = {"image": {"depth_logits": 1.5e-6}}
CADDN_LOSS_TOLS: dict = {}
#: the KITTI split of phase 19 (write_kitti_split) and its loaders
KITTI_FRAMES, KITTI_POINTS, KITTI_CARS = 8, 20_000, 8
KITTI_CAMERA_KEYS = ("images", "trans_cam_to_img", "depth_maps", "gt_boxes2d", "gt_boxes",
                     "gt_mask")


def caddn_tiny_inputs(seed: int = 0):
    """Two 96 x 320 images (the last 8 rows zero, as the dataset's pad), two
    P2s, ground-truth cars, depth maps (a tenth of the pixels 0, the top
    rows beyond the range) and 2D boxes, numpy from ``seed``: the tiny
    CaDDN's inputs (tests/test_torch_caddn.py)."""
    rng = np.random.RandomState(seed)
    h, w = 96, 320
    images = rng.rand(2, h, w, 3).astype(np.float32)
    images[:, -8:] = 0.0
    p2 = np.array([[[200, 0, 160, 0], [0, 200, 48, 0], [0, 0, 1, 0]],
                   [[190, 0, 150, 4.5], [0, 195, 50, 0.2], [0, 0, 1, 0.003]]], np.float32)
    gt = np.zeros((2, 3, 8), np.float32)
    gt[0, 0] = [8, 0, 0, 4.2, 2.0, 1.6, 0.2, 1]
    gt[0, 1] = [12, -3, -0.5, 3.9, 1.6, 1.5, -1.1, 1]
    gt[1, 0] = [6, 2, -0.3, 4.0, 1.7, 1.5, 1.4, 1]
    depth = rng.uniform(3, 25, (2, h, w)).astype(np.float32)
    depth[rng.rand(2, h, w) < 0.1] = 0.0
    depth[:, :4] = 40.0
    boxes2d = np.zeros((2, 3, 4), np.float32)
    boxes2d[0, 0] = [100, 20, 220, 90]
    boxes2d[0, 1] = [10.5, 30.2, 60.7, 70.1]
    boxes2d[1, 0] = [150, 10, 300, 80]
    return images, p2, gt, depth, boxes2d


def frustum_cell_flips(got: dict, ref: dict) -> int:
    """The voxels whose frustum cell (row, column, bin, validity) differs
    between two records of ``selection_choices``, over all calls."""
    key = f"{CADDN.__name__}.frustum_indices"
    n = 0
    for a, b in zip(got[key], ref[key]):
        ok = a[3] | b[3]
        n += int((ok & ((a[0] != b[0]) | (a[1] != b[1]) | (a[2] != b[2])
                        | (a[3] != b[3]))).sum())
    return n


@torch.no_grad()
def check_tiny_caddn_against_cpu(dev) -> dict:
    """The tiny CaDDN in both forms (weights from seed 7 with random
    statistics, TF32 off) on the card against the port's CPU path (which
    the tests hold against JAX), the frustum cells pinned to the CPU's
    (``selection_choices``): the depth logits and the decoded boxes and
    scores within 1e-6 of a tensor's largest |value| (``CADDN_EVAL_TOLS``
    names others), the kept sets and labels after post-processing equal;
    the CPU's f32 run against its f64 run printed beside, and the cells the
    unpinned card chose otherwise."""
    cpu = torch.device("cpu")
    images, p2 = caddn_tiny_inputs(0)[:2]
    rel = lambda r: r.abs().max().item() + 1e-30          # noqa: E731
    worst, own, flips = {}, {}, {}
    for form in CADDN_FORMS:
        cfg = DC.tiny_caddn_cfg(form)
        sd = seeded_state_dict(7, build_detector(cfg, device=cpu)[0], random_stats=True)

        def run(w, pinned=None, dtype=torch.float32):
            m, _ = build_detector(cfg, sd, device=w)
            m.to(dtype)
            with selection_choices(pinned) as chosen:
                out = m(torch.from_numpy(images).to(w, dtype), torch.from_numpy(p2).to(w, dtype))
            pp = post_processing(out, cfg.MODEL.POST_PROCESSING, 1, False)
            return out, pp, chosen

        out_c, pp_c, chosen = run(cpu)
        out_d, pp_d, _ = run(dev, chosen)
        out_64 = run(cpu, chosen, torch.float64)[0]
        flips[form] = frustum_cell_flips(run(dev)[2], chosen)
        worst[form] = {k: _worst({k: out_d[k].cpu()}, {k: out_c[k]}, rel)[0] for k in CADDN_OUT}
        own[form] = {k: _worst({k: out_c[k]}, {k: out_64[k]}, rel)[0] for k in CADDN_OUT}
        for k in ("pred_mask", "pred_labels"):
            if not torch.equal(pp_d[k].cpu(), pp_c[k]):
                raise AssertionError(f"tiny CaDDN ({CADDN_FORMS[form]}): {k} differs")
        if not pp_c["pred_mask"].any():
            raise AssertionError(f"tiny CaDDN ({CADDN_FORMS[form]}) kept no box")
    print("tiny CaDDN eval, card vs CPU (TF32 off, the frustum cells pinned to the CPU's): "
          f"|diff| / largest by output (bound 1e-6; otherwise {CADDN_EVAL_TOLS}): " + "; ".join(
              f"{CADDN_FORMS[f]} " + ", ".join(f"{k} {v:.3g}" for k, v in w.items())
              for f, w in worst.items())
          + "; the CPU's own f32 run against its f64 run: " + "; ".join(
              f"{CADDN_FORMS[f]} " + ", ".join(f"{k} {v:.3g}" for k, v in w.items())
              for f, w in own.items())
          + f"; kept boxes and labels equal; frustum cells the unpinned card chose "
          f"otherwise {flips}")
    over = [(f, k) for f in CADDN_FORMS for k in CADDN_OUT
            if worst[f][k] > CADDN_EVAL_TOLS.get(f, {}).get(k, 1e-6)]
    if over:
        raise AssertionError("tiny CaDDN off the CPU: " + ", ".join(
            f"{CADDN_FORMS[f]} {k} {worst[f][k]:.3g} (bound "
            f"{CADDN_EVAL_TOLS.get(f, {}).get(k, 1e-6):g})" for f, k in over))
    return {"worst": worst, "cpu_f32_vs_f64": own, "cell_flips": flips}


def check_tiny_caddn_steps_against_cpu(dev) -> dict:
    """One train step of the tiny CaDDN in both forms (weights from seed 8
    with random statistics; depth maps, and 2D boxes for DDNLoss) held by
    ``hold_tiny_step`` with the ReLU signs and the frustum cells pinned:
    loss terms within 1e-5, gradients within 5e-4 of their tensor's
    largest. ddn_loss, and with DDNLoss fg_loss, must be above 0."""
    out = {}
    images, p2, gt, depth, boxes2d = caddn_tiny_inputs(1)
    for form, label in CADDN_FORMS.items():
        cfg = DC.tiny_caddn_cfg(form)
        sd = seeded_state_dict(8, build_detector(cfg, device="cpu")[0], random_stats=True)
        extra = {"depth_maps": depth, **({"gt_boxes2d": boxes2d} if form == "resnet_tiny"
                                         else {})}
        out[form], terms = hold_tiny_step(dev, f"CaDDN ({label})", cfg, sd,
                                          (images, p2, gt, None, extra), pin_queries=True,
                                          loss_tols=CADDN_LOSS_TOLS.get(form))
        if terms["ddn_loss"].item() <= 0 or (form == "resnet_tiny"
                                             and terms["fg_loss"].item() <= 0):
            raise AssertionError(f"tiny CaDDN ({label}) step: no depth or foreground loss")
    return out


def caddn_stages(model, cfg, images, p2) -> tuple:
    """CaDDN's eval forward and post-processing stage by stage, each
    between synchronizes: DeepLab backbone (the normalisation and the
    ResNet), ASPP + upsample (the classifier and the logits' resize),
    channel reduce, frustum -> voxel (the cells and the sample), collapse,
    BEV backbone, head (the anchor head and the decode), post-processing.
    -> ({stage: (CUDA-event ms, host ms)}, output, post-processed)."""
    t = {}
    ddn = model.ddn
    f4, f8 = timed_stage(t, "deeplab_backbone", lambda: ddn.backbone(
        ddn.normalize(images).permute(0, 3, 1, 2)))
    logits = timed_stage(t, "aspp_upsample", lambda: torch.nn.functional.interpolate(
        ddn.classifier(f8), size=f4.shape[-2:], mode="bilinear", align_corners=False))
    feat = timed_stage(t, "channel_reduce", lambda: model.channel_reduce(f4))
    feat, logits = feat.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1)
    stride = images.shape[1] // feat.shape[1]
    bev = timed_stage(t, "frustum_to_voxel", lambda: model.frustum_bev(feat, logits, p2, stride))
    bev = timed_stage(t, "collapse", lambda: model.collapse(bev))
    bev2d = timed_stage(t, "bev_backbone", lambda: model.backbone_2d(bev.permute(0, 2, 3, 1)))

    def head():
        h = model.dense_head(bev2d)
        return (h, *model.cfg.head_logic.predict_boxes(h))

    h, cls, box = timed_stage(t, "head", head)
    out = {"head_out": h, "batch_cls_preds": cls, "batch_box_preds": box,
           "depth_logits": logits}
    pp = timed_stage(t, "post_processing", lambda: post_processing(
        out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES), False))
    return t, out, pp


def time_frustum_ops(model, images, p2) -> dict:
    """The frustum sample (``frustum_to_voxels`` at the frame's cells) alone,
    forward and forward + backward, and the collapse conv alone, each by
    CUDA events (median of 5) beside its bound: the sample's bytes (the
    features, the bin probabilities and the cells read once, the voxel
    features written once; the backward's: the voxel features' gradient
    and the cells read, the two inputs' gradients written) at 3.35 TB/s,
    the conv's operations (2 x in x out x cells) at 67 TFLOP/s or its
    bytes, the larger. The backward's device time by op names its
    scatter-add."""
    with torch.no_grad():
        feat, logits = model.image_features(images)
    b, h, w, c = feat.shape
    ddist = torch.softmax(logits, dim=-1)[..., :model.num_bins].contiguous()
    stride = images.shape[1] // h
    hom = model.voxel_hom(images.device)
    cells = CADDN.frustum_indices(p2, hom, (h, w), stride, model.depth_min, model.depth_max,
                                  model.num_bins)
    v = hom.shape[0]
    cell_bytes = b * v * (4 + 4 + 8 + 1)
    in_bytes = feat.numel() * 4 + ddist.numel() * 4 + cell_bytes
    out_bytes = b * v * c * 4
    with torch.no_grad():
        fwd_ms = time_cuda(lambda: CADDN.frustum_to_voxels(feat, ddist, *cells), reps=5)
    fl, dl = feat.clone().requires_grad_(True), ddist.clone().requires_grad_(True)
    grad = torch.ones(b, v, c, device=images.device)

    def fwd_bwd():
        with torch.enable_grad():
            CADDN.frustum_to_voxels(fl, dl, *cells).backward(grad)

    both_ms = time_cuda(fwd_bwd, reps=5)
    _, per_op = profile_ops((), fwd_bwd)
    bwd_bytes = out_bytes + cell_bytes + feat.numel() * 4 + ddist.numel() * 4
    fwd_bound = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    both_bound = fwd_bound + bwd_bytes / HBM_BYTES_PER_S * 1e3
    conv = model.collapse[0]
    with torch.no_grad():
        x = model.frustum_bev(feat, logits, p2, stride)
        conv_ms = time_cuda(lambda: conv(x), reps=5)
    cells_n = x.shape[2] * x.shape[3]
    conv_flop_ms = 2 * conv.in_channels * conv.out_channels * cells_n * b / FP32_FLOPS * 1e3
    conv_byte_ms = (x.numel() + conv.weight.numel() + b * conv.out_channels * cells_n) * 4 \
        / HBM_BYTES_PER_S * 1e3
    conv_bound, conv_by = max((conv_flop_ms, "operations"), (conv_byte_ms, "bytes"))
    scatter = {k: round(ms, 3) for k, ms in sorted(per_op.items(), key=lambda kv: -kv[1])[:4]}
    return {"voxels": v, "channels": c, "valid_cells": int(cells[3].sum()),
            "forward_ms": fwd_ms, "forward_bound_ms": fwd_bound, "forward_bound_by": "bytes",
            "forward_backward_ms": both_ms, "forward_backward_bound_ms": both_bound,
            "backward_ops_ms": scatter,
            "collapse_conv": {"shape": f"{conv.in_channels} -> {conv.out_channels} 1x1 over "
                                       f"{x.shape[2]} x {x.shape[3]}",
                              "ms": conv_ms, "bound_ms": conv_bound, "bound_by": conv_by}}


def serve_caddn(dev, card, images, p2) -> dict:
    """Phase 19 serving: CaDDN at caddn_detector_cfg (DeepLabV3-ResNet101,
    weights from seed 0) on one 384 x 1280 frame of the KITTI split (the
    dataset's pad) with its P2: the eval forward through post-processing
    (outputs finite, boxes kept, peak memory), its stages (median of 3
    runs after a warm-up), the whole (CUDA events, median of 3), device
    busy and top kernels, the frustum sample and the collapse conv alone."""
    cfg = DC.caddn_detector_cfg()
    cpu_model, dcfg = build_detector(cfg, device="cpu")
    model, _ = build_detector(cfg, seeded_state_dict(0, cpu_model), device=dev)
    post = cfg.MODEL.POST_PROCESSING
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = model(images, p2)
        pp = post_processing(out, post, 3, False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in CADDN_OUT:
        if not torch.isfinite(out[k]).all():
            raise AssertionError(f"CaDDN output {k} is not finite")
    n_anchors = dcfg.head_logic.anchors_flat.shape[0]
    if out["batch_box_preds"].shape != (1, n_anchors, 7) or \
            out["depth_logits"].shape != (1, 96, 320, 81):
        raise AssertionError(f"CaDDN output shapes {out['batch_box_preds'].shape}, "
                             f"{out['depth_logits'].shape}")
    kept = int(pp["pred_mask"].sum())
    if kept < 1:
        raise AssertionError("CaDDN kept no box")
    with torch.no_grad():
        runs = [caddn_stages(model, cfg, images, p2)[0] for _ in range(4)][1:]
        stages = {k: (statistics.median(r[k][0] for r in runs),
                      statistics.median(r[k][1] for r in runs)) for k in runs[0]}
        eval_ms = time_cuda(lambda: post_processing(model(images, p2), post, 3, False),
                            reps=3, warmup=1)
        busy, top = profile_kernels((images, p2), lambda i, q: post_processing(
            model(i, q), post, 3, False))
    ops = time_frustum_ops(model, images, p2)
    print(f"CaDDN at full width (caddn_detector_cfg: DeepLabV3-ResNet101, {dcfg.grid_size} "
          f"grid, {n_anchors} anchors) on a 384x1280 KITTI frame: {kept} boxes kept; eval "
          f"forward + post-processing {eval_ms:.2f} ms (CUDA events, median of 3); peak device "
          f"memory {peak:.2f} GiB; device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + f" on {card}")
    print("CaDDN stages, CUDA-event / host ms (median of 3, each between synchronizes): "
          + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in stages.items()))
    cc = ops["collapse_conv"]
    print(f"CaDDN ops alone (CUDA events, median of 5): frustum sample ({ops['voxels']} voxels "
          f"x {ops['channels']} channels, {ops['valid_cells']} valid) forward "
          f"{ops['forward_ms']:.3f} ms, bound {ops['forward_bound_ms']:.4f} ms (bytes); "
          f"forward + backward {ops['forward_backward_ms']:.3f} ms, bound "
          f"{ops['forward_backward_bound_ms']:.4f} ms, its ops by device ms "
          f"{ops['backward_ops_ms']}; collapse conv ({cc['shape']}, cuDNN f32) {cc['ms']:.3f} "
          f"ms, bound {cc['bound_ms']:.4f} ms ({cc['bound_by']})")
    return {"kept": kept, "peak_gib": peak, "eval_ms": eval_ms, "stage_ms": stages,
            "device_busy_ms": busy, "top_kernels": top, "ops": ops}


def train_caddn(dev, card, batch: dict, steps: int = 3) -> dict:
    """Phase 19 training: CaDDN at caddn_detector_cfg (batch 2, weights from
    seed 0) on a loader batch of the KITTI split's camera items (images,
    P2, depth maps, 2D boxes, ground truth): 1 + 1 + ``steps`` train steps
    (step 1 checked: losses finite and above 0 where they must be, every
    parameter moved, every gradient finite), one split by CUDA events, one
    profiled, peak memory."""
    cfg = DC.caddn_detector_cfg()
    model, _ = build_detector(cfg, seeded_state_dict(0, build_detector(cfg, device="cpu")[0]),
                              device=dev)
    state = create_train_state(model, cfg.OPTIMIZATION, total_steps=1000)
    args = (batch["images"], batch["trans_cam_to_img"], batch["gt_boxes"])
    extra = {"depth_maps": batch["depth_maps"], "gt_boxes2d": batch["gt_boxes2d"]}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, tb, _ = train_forward(state, *args, **extra)
    apply_gradients(state, loss)
    losses = [{"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()}}]
    for n, p in model.named_parameters():
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"CaDDN: gradient of {n} is not finite")
    if tb["ddn_loss"].item() <= 0 or tb["fg_loss"].item() <= 0:
        raise AssertionError("CaDDN step 1: no depth or foreground loss")
    idle = check_moved(model, start, (), "CaDDN train step 1")
    train_step(state, *args, **extra)                       # warm-up
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_step(state, *args, **extra))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    fwd = model(*args[:2])
    ev[1].record()
    loss, _ = model.loss(fwd, args[2], **extra)
    ev[2].record()
    apply_gradients(state, loss)
    ev[3].record()
    torch.cuda.synchronize()
    split = {k: ev[i].elapsed_time(ev[i + 1])
             for i, k in enumerate(("forward", "loss", "backward_update"))}
    busy, top = profile_kernels((state, *args), lambda *a: train_step(*a, **extra))
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError("a CaDDN training loss is not finite")
    step_ms = statistics.median(times)
    summary = {"step_ms": step_ms, "frames_per_s": 2e3 / step_ms, "step_ms_all": times,
               "split_ms": split, "peak_gib": peak, "device_busy_ms": busy, "top_kernels": top,
               "losses": [m["loss"] for m in values], "last_terms": values[-1], "idle": idle}
    print("CaDDN train steps at batch 2 (full width, f32) on the KITTI split's camera items: "
          "losses " + ", ".join(f"{v:.4f}" for v in summary["losses"]) + "; last terms "
          + ", ".join(f"{k} {v:.4f}" for k, v in values[-1].items()))
    print(f"CaDDN train step {step_ms:.2f} ms (host clock to a synchronize, median of {steps} "
          f"after a warm-up) = {summary['frames_per_s']:.2f} frames/s; CUDA events: forward "
          f"{split['forward']:.2f} ms, loss {split['loss']:.2f} ms, backward + update "
          f"{split['backward_update']:.2f} ms; peak device memory {peak:.2f} GiB; profiled "
          f"step: device busy {busy:.2f} ms; device time by kernel: "
          + "; ".join(f"{n} {t:.2f} ms" for n, t in top) + f" on {card}")
    return summary


def kitti_cfg(root: str, **kw) -> Cfg:
    """kitti_dataset.yaml's data config over the synthetic split at the
    flagship's range, points x y z of x y z intensity, FOV points only, no
    augmentation; ``kw`` overrides."""
    cfg = {"DATASET": "KittiDataset", "DATA_PATH": root,
           "POINT_CLOUD_RANGE": [0, -40, -3, 70.4, 40, 1],
           "DATA_SPLIT": {"train": "train", "test": "val"},
           "INFO_PATH": {"train": ["kitti_infos_train.pkl"], "test": ["kitti_infos_val.pkl"]},
           "FOV_POINTS_ONLY": True,
           "POINT_FEATURE_ENCODING": {"encoding_type": "absolute_coordinates_encoding",
                                      "used_feature_list": ["x", "y", "z"],
                                      "src_feature_list": ["x", "y", "z", "intensity"]},
           "DATA_PROCESSOR": [{"NAME": "shuffle_points",
                               "SHUFFLE_ENABLED": {"train": True, "test": False}}]}
    cfg.update(kw)
    return Cfg(cfg)


#: kitti_dataset.yaml's DATA_AUGMENTOR with the split's own GT database
KITTI_AUGMENTOR = {
    "DISABLE_AUG_LIST": ["placeholder"],
    "AUG_CONFIG_LIST": [
        {"NAME": "gt_sampling", "DB_INFO_PATH": ["kitti_dbinfos_train.pkl"],
         "PREPARE": {"filter_by_min_points": ["Car:5"]}, "SAMPLE_GROUPS": ["Car:15"],
         "NUM_POINT_FEATURES": 4},
        {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]},
        {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
        {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]}]}


def kitti_data_path(dev, card, vcn, root: str, steps: int = 3) -> dict:
    """Phase 19's data path on a synthetic KITTI split of ``KITTI_FRAMES``
    frames under ``root``: GT completion of the split (K1 counted) into the
    .pcd files SCKittiDataset reads; SCKittiDataset in training with
    kitti_dataset.yaml's augmentor (the GT-database paste, world flip along
    x, rotation, scaling) through BackgroundLoader (batch 4, uploaded to the
    card) and ``augment_on_device`` (a generator a frame) into ``steps``
    SECOND-IoU train steps at the flagship config; ``eval_one_epoch`` of the
    flagship SECOND-IoU over the split with KITTI's AP and recall; the
    camera items' loader batch for CaDDN. Times: the loader's wait a batch
    (host clock), the augmentation a batch (CUDA events), eval s a frame."""
    from seevcn_torch.data.kitti.dataset import KittiDataset, SCKittiDataset
    from seevcn_torch.data.loader import BackgroundLoader
    from seevcn_torch.geom.pcd_io import write_pcd
    from seevcn_torch.train.eval import eval_one_epoch

    t0 = time.time()
    infos = write_kitti_split(root, KITTI_FRAMES, seed=0, n_points=KITTI_POINTS,
                              n_cars=KITTI_CARS)
    n_boxes = sum(len(i["annos"]["name"]) for i in infos)
    write_s = time.time() - t0
    base = KittiDataset(kitti_cfg(root), ["Car"], False, max_points=KITTI_POINTS,
                        max_boxes=16)
    frames = [base[i] for i in range(len(base))]
    pts, valid, gt, gm = (torch.from_numpy(np.stack([f[k] for f in frames])).to(dev)
                          for k in ("points", "points_valid", "gt_boxes", "gt_mask"))
    K.reset_launches()
    new_pts, new_valid, st = complete_gt_frames(vcn, pts, valid, gt[..., :7], gm, device=dev)
    torch.cuda.synchronize()
    launches = K.LAUNCHES["min_sqdist_pruned"]
    if launches < 1:
        raise AssertionError("K1 was not launched by the KITTI split's GT completion")
    os.makedirs(os.path.join(root, "training", "vcn"), exist_ok=True)
    for info, p, v in zip(infos, new_pts, new_valid):
        write_pcd(os.path.join(root, "training", "vcn",
                               f"{info['point_cloud']['lidar_idx']}.pcd"), p[v].cpu().numpy())
    spliced = int(st["inst_valid"].sum())

    det_cfg = DC.flagship_detector_cfg()
    cap = int(det_cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    sd = seeded_state_dict(0, build_detector(det_cfg, device="cpu")[0])
    sc_cfg = kitti_cfg(root, DATA_AUGMENTOR=KITTI_AUGMENTOR, POINT_FEATURE_ENCODING={
        "used_feature_list": ["x", "y", "z"], "src_feature_list": ["x", "y", "z"]})
    sc = SCKittiDataset(sc_cfg, ["Car"], True, max_points=40_000, max_boxes=64)
    if sc.gt_sampler is None or len(sc.aug_list) != 3:
        raise AssertionError("SCKittiDataset did not take the augmentor's four entries")
    model, _ = build_detector(det_cfg, sd, max_voxels=cap, device=dev)
    state = create_train_state(model, det_cfg.OPTIMIZATION, total_steps=1000)
    loader = BackgroundLoader(sc, batch_size=4, device=dev, seed=0)
    waits, aug_ms, losses, pasted = [], [], [], []
    it, epoch = iter(loader), 0
    for step in range(steps):
        t1 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            epoch += 1
            sc.set_epoch(epoch)
            it = iter(loader)
            batch = next(it)
        torch.cuda.synchronize()
        waits.append((time.perf_counter() - t1) * 1e3)
        pasted.append(int(batch["gt_mask"].sum()))
        gens = [torch.Generator(device=dev).manual_seed(100 * step + b) for b in range(4)]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        batch = sc.augment_on_device(batch, gens)
        ev[1].record()
        torch.cuda.synchronize()
        aug_ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(train_step(state, batch["points"], batch["points_valid"],
                                 batch["gt_boxes"], torch.Generator(device=dev).manual_seed(
                                     step)))
    values = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(math.isfinite(v) for m in values for v in m.values()):
        raise AssertionError("a SECOND-IoU loss on the KITTI split is not finite")

    eval_model, _ = build_detector(det_cfg, sd, device=dev)
    val = KittiDataset(kitti_cfg(root), ["Car"], False, max_points=40_000, max_boxes=64)
    logs = []
    t1 = time.time()
    report, ap, recall = eval_one_epoch(eval_model, det_cfg, val, batch_size=4,
                                        logger=logs.append)
    eval_s = (time.time() - t1) / len(val)
    if report is None or "Car AP_R40" not in report or recall["num_gt"] != n_boxes:
        raise AssertionError(f"eval_one_epoch over the KITTI split: num_gt "
                             f"{recall['num_gt']} of {n_boxes} boxes written; report {report}")
    ap_keys = sorted(f"{c}/{m}" for c in ap for m in ap[c])

    cam_cfg = kitti_cfg(root, POINT_CLOUD_RANGE=DC.caddn_detector_cfg().DATA_CONFIG
                        .POINT_CLOUD_RANGE,
                        GET_ITEM_LIST=["points", "images", "depth_maps", "calib_matricies",
                                       "gt_boxes2d"])
    cam = KittiDataset(cam_cfg, ["Car", "Pedestrian", "Cyclist"], True, max_points=4096,
                       max_boxes=16)
    t1 = time.perf_counter()
    cam_batch = next(iter(BackgroundLoader(cam, batch_size=2, keys=KITTI_CAMERA_KEYS,
                                           device=dev, seed=0)))
    torch.cuda.synchronize()
    cam_ms = (time.perf_counter() - t1) * 1e3
    summary = {"frames": len(infos), "boxes": n_boxes, "write_s": write_s,
               "gt_completion_launches": launches, "spliced": spliced,
               "loader_wait_ms": waits, "augment_ms": aug_ms, "gt_after_paste": pasted,
               "train_losses": [m["loss"] for m in values], "eval_s_per_frame": eval_s,
               "ap": ap, "ap_keys": ap_keys, "recall": recall, "camera_batch_ms": cam_ms}
    print(f"KITTI split ({len(infos)} frames, {n_boxes} cars, written in {write_s:.1f} s): GT "
          f"completion K1 launches {launches}, {spliced} completions spliced into the .pcds; "
          f"SCKittiDataset (GT paste, flip, rotation, scaling) -> BackgroundLoader (batch 4, "
          f"to the card) -> augment_on_device -> {steps} SECOND-IoU train steps: loader wait "
          + ", ".join(f"{v:.1f}" for v in waits) + " ms a batch (host), augmentation "
          + ", ".join(f"{v:.2f}" for v in aug_ms) + " ms a batch (CUDA events), ground truth "
          f"a batch after the paste {pasted}, losses "
          + ", ".join(f"{v['loss']:.4f}" for v in values)
          + f"; eval_one_epoch {eval_s:.3f} s a frame, recall {recall}, AP keys {ap_keys}; "
          f"the camera items' first batch of 2 in {cam_ms:.1f} ms (host) on {card}")
    return summary, cam_batch


def caddn_kitti(dev, card, vcn) -> dict:
    """Phase 19: the tiny CaDDN card vs CPU (eval and one train step, both
    forms), then the KITTI data path on a synthetic split, then CaDDN at
    full width on one of its frames and in the train step on its camera
    items."""
    parts, t0 = {}, time.time()
    res = {"tiny_vs_cpu": check_tiny_caddn_against_cpu(dev),
           "tiny_steps_vs_cpu": check_tiny_caddn_steps_against_cpu(dev)}
    parts["tiny"], t0 = time.time() - t0, time.time()
    with tempfile.TemporaryDirectory(prefix="kitti_split_") as root:
        res["kitti_data"], cam = kitti_data_path(dev, card, vcn, root)
    parts["kitti_data"], t0 = time.time() - t0, time.time()
    res["caddn"] = serve_caddn(dev, card, cam["images"][:1], cam["trans_cam_to_img"][:1])
    parts["caddn_serve"], t0 = time.time() - t0, time.time()
    res["caddn"]["train"] = train_caddn(dev, card, cam)
    parts["caddn_train"] = time.time() - t0
    res["part_s"] = parts
    print("phase 19 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return res


# --- phase 20: the KITTI SEE-VCN workflow through the CLIs --------------------------

#: phase 20's raw KITTI tree: frames of a 64-beam scan's size (make_scene, 8 cars,
#: the background the cars hide left out, as a scan has it)
WORKFLOW_FRAMES, WORKFLOW_POINTS, WORKFLOW_CARS = 4, 120_000, 8
#: the isolation and completion settings of the reference's KIT-DET_VCN-VC.yaml
#: (SURVEY.md §3.1), VCN_VC at 1,024 points; the masks shrink 3%
KIT_DET_VCN_VC = {"PC_ISOLATION": {"MIN_LIDAR_PTS": 30, "EPS_SCALING": 4.0, "MIN_EPS": 0.3,
                                   "MAX_EPS": 1.0},
                  "SURFACE_COMPLETION": {"VRES": 0.4, "VCN": {
                      "MODEL": "VCN_VC", "NORM_WITH_GT": False, "SEL_K_NEAREST": 30,
                      "CLUSTER_EPS": 0.4, "BATCH_SIZE_LIMIT": 32}}}
WORKFLOW_SHRINK = 3.0
#: the points a box's num_points_in_gt from create_infos may differ from the
#: writer's: the labels' text moves a box by about 2e-6 m, so a scan point on a
#: face (make_scene's cars are box surfaces) can change sides
NUM_POINTS_SLACK = 2
#: generate_masks' score threshold on the seeded Mask R-CNN: low enough that
#: detections of random weights come out
MASK_SCORE_THRESH = 0.05
#: run_see's DET path on the cars' masks: the scan points that each completed
#: instance must replace at least (the GT path replaces about 80 a car), and
#: the share of the isolated points that must lie on a car (its box + 0.2 m)
WORKFLOW_MIN_DROPPED, WORKFLOW_IN_CAR = 25, 0.9
#: phase 20's bounds, card vs CPU: the points of an isolated instance that may
#: differ (DBSCAN's Gram-form adjacency at eps), the completed rows the two
#: sides' counts may differ by, and the share of the rows that may lie
#: farther than SEE_ROW_TOL from the other side's: a k-NN or cluster pick at
#: a near tie, which the CPU's own f32 run against its f64 run shows too
#: (the check prints both). An exact row count failed on the card once (GT
#: frame 0: 3,820 rows against the CPU's 3,821, one row 0.049 m off)
SEE_ISO_SLACK, SEE_ROW_SLACK, SEE_ROW_SHARE, SEE_ROW_TOL = 2, 2, 1e-3, 1e-3


def car_box_detections(infos, image_shape=KITTI_IMAGE_SHAPE) -> list:
    """generate_masks' detections made from the ground truth (as the JAX
    package's tests/test_see_e2e.py makes them): one a car of each info,
    the 2D hull of its box's corners projected with KITTI's calibration,
    cut to the image, as its mask and box, score 0.9. -> [(file_name, (H,
    W), detections)] for ``detections_to_coco``."""
    from seevcn_torch.geom.calibration import KittiCalibration

    calib = KittiCalibration({"P2": KITTI_P2, "R0": KITTI_R0, "Tr_velo2cam": KITTI_V2C})
    h, w = image_shape
    per_image = []
    for info in infos:
        dets = []
        for box in info["annos"]["gt_boxes_lidar"]:
            uv, _ = calib.lidar_to_img(_box_corners(box[:3], box[3:6], box[6]))
            x0, y0 = np.maximum(uv.min(0), 0)
            x1, y1 = np.minimum(uv.max(0), [w - 1, h - 1])
            mask = np.zeros((h, w), bool)
            mask[int(y0):int(y1) + 1, int(x0):int(x1) + 1] = True
            dets.append({"mask": mask, "bbox": [x0, y0, x1 - x0, y1 - y0], "score": 0.9,
                         "category_id": 3})
        per_image.append((f"{info['point_cloud']['lidar_idx']}.png", (h, w), dets))
    return per_image


def convex_hull(p: np.ndarray) -> np.ndarray:
    """(N, 2) -> the convex hull's vertices, counter-clockwise (Andrew's
    monotone chain)."""
    p = np.unique(p, axis=0)
    if len(p) < 3:
        return p

    def chain(q):
        out = []
        for x in q:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0]) * (x[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1]) * (x[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(x)
        return out[:-1]
    return np.array(chain(p) + chain(p[::-1]))


def car_hull_detections(root: str, infos, image_shape=KITTI_IMAGE_SHAPE) -> list:
    """generate_masks' detections made from the scan, as a segmentation
    model would outline each car: the convex hull of the car's own lidar
    points (those in its box) projected with KITTI's calibration, filled
    by ``polygons_to_mask``, as its mask, its extent as its box, score 0.9.
    -> [(file_name, (H, W), detections)] for ``detections_to_coco``."""
    from seevcn_torch.geom import boxes as GB
    from seevcn_torch.geom.calibration import KittiCalibration
    from seevcn_torch.see.masks import polygons_to_mask

    calib = KittiCalibration({"P2": KITTI_P2, "R0": KITTI_R0, "Tr_velo2cam": KITTI_V2C})
    h, w = image_shape
    per_image = []
    for info in infos:
        idx = info["point_cloud"]["lidar_idx"]
        pts = np.fromfile(os.path.join(root, "training", "velodyne", f"{idx}.bin"),
                          np.float32).reshape(-1, 4)[:, :3]
        boxes = info["annos"]["gt_boxes_lidar"]
        inside = GB.points_in_boxes(torch.from_numpy(pts),
                                    torch.from_numpy(boxes).float()).numpy()
        dets = []
        for j in range(len(boxes)):
            uv, _ = calib.lidar_to_img(pts[inside[j]])
            mask = polygons_to_mask([np.round(convex_hull(uv)).ravel().tolist()], h, w)
            ys, xs = np.nonzero(mask)
            dets.append({"mask": mask.astype(bool),
                         "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min()),
                                  float(ys.max() - ys.min())], "score": 0.9,
                         "category_id": 3})
        per_image.append((f"{idx}.png", (h, w), dets))
    return per_image


def plain_tree(o):
    """A Cfg tree -> plain dicts and lists (for yaml)."""
    if isinstance(o, dict):
        return {k: plain_tree(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [plain_tree(v) for v in o]
    if isinstance(o, np.generic):
        return o.item()
    return o


def write_yaml(path: str, cfg) -> str:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(plain_tree(cfg), f)
    return path


def rows_apart(got: np.ndarray, ref: np.ndarray, dev) -> np.ndarray:
    """Each row's distance to the nearest row of the other cloud, both ways
    (for two clouds of the same rows up to rounding), in f64 on ``dev``."""
    a, b = (torch.from_numpy(x).to(dev, torch.float64) for x in (got, ref))
    d = torch.cdist(a, b)
    return torch.cat([d.amin(1), d.amin(0)]).cpu().numpy()


def completed_f64(see, instances, boxes=None) -> np.ndarray:
    """``see``'s completion of ``instances`` (its VCN list form, then the
    rows made unique) with the VCN and the chain after it in f64 on its
    device: the witness of which picks are near ties."""
    from seevcn_torch.models.vcn.inference import forward_chain, resample_to_fixed

    vcn = see.vcn
    model = copy.deepcopy(vcn.model).double()
    pc = torch.from_numpy(resample_to_fixed(instances, vcn.num_points)).to(vcn.device,
                                                                             torch.float64)
    gt = None
    if vcn.norm_with_gt:
        gt = torch.from_numpy(np.stack([np.asarray(b, np.float64)[:7] for b in boxes])
                              ).to(vcn.device)
    out = forward_chain(model, pc, gt, sel_k=vcn.sel_k, eps=vcn.cluster_eps)[3].cpu().numpy()
    return np.unique(np.vstack(out).astype(np.float32), axis=0)


def hold_see_frame_against_cpu(see, cpu, idx: int, path: str) -> dict:
    """One frame of SEEVCN on the card against the port's CPU path (which
    the tests hold against JAX), stage by stage, each stage fed the CPU's
    inputs so that a difference cannot cascade: isolation (DET: the mask
    points, then DBSCAN; GT: the box crop) with at most SEE_ISO_SLACK
    points of an instance apart, and (DET) WORKFLOW_IN_CAR of the points on
    a car; the completed clouds (the instances' np.unique rows, so a pick
    that differs changes the count too) with row counts within
    SEE_ROW_SLACK and at most SEE_ROW_SHARE of the rows farther than
    SEE_ROW_TOL from the other side's, beside two witnesses
    (``completed_f64``): the same numbers for the CPU's f32 run against
    its f64 run, and for the card's f64 run against the CPU's; the
    replacement's kept scan points equal but for points within 1e-5 r^2 of
    r^2 of the completed cloud."""
    from seevcn_torch.geom import boxes as GB

    points = cpu.data_obj.get_pointcloud(idx)
    boxes = cpu.data_obj.get_gt_boxes(idx)
    labels = None
    if path == "det":
        proj = cpu.get_det_instances(idx)
        inst_d, inst_c = see.isolate_det_pts(proj), cpu.isolate_det_pts(proj)
        comp_d, comp_c = see.complete_det_pts(inst_c), cpu.complete_det_pts(inst_c)
    else:
        (inst_d, _), (inst_c, labels) = (see.isolate_gt_pts(points, boxes),
                                         cpu.isolate_gt_pts(points, boxes))
        comp_d, comp_c = see.complete_gt_pts(inst_c, labels), cpu.complete_gt_pts(inst_c, labels)
    if len(inst_d) != len(inst_c) or not inst_c:
        raise AssertionError(f"SEE {path} frame {idx}: {len(inst_d)} instances on the card, "
                             f"{len(inst_c)} on the CPU")
    iso_apart = [len({tuple(r) for r in a} ^ {tuple(r) for r in b})
                 for a, b in zip(inst_d, inst_c)]
    grown = np.asarray(boxes, np.float32)[:, :7].copy()
    grown[:, 3:6] += 0.4
    iso = np.concatenate(inst_d)
    in_car = float(GB.points_in_boxes(torch.from_numpy(iso[:, :3].copy()),
                                      torch.from_numpy(grown)).numpy().any(0).mean())
    done_d, done_c = comp_d["all_instances"], comp_c["all_instances"]
    completed = inst_c
    if path == "det":                  # what complete_det_pts completes: merged, filtered
        if len(cpu.data_obj.camera_channels) > 1:
            completed = cpu.merge_multi_camera_detections(inst_c)
        completed = [x for x in completed if x.shape[0] > cpu.min_lidar_pts]
    done_64, done_d64 = (completed_f64(s_, completed, labels) for s_ in (cpu, see))
    apart = rows_apart(done_d, done_c, see.device)
    apart_64 = rows_apart(done_c, done_64, see.device)
    apart_d64 = rows_apart(done_d64, done_64, see.device)
    row_share, row_share_64, row_share_d64 = (float((a > SEE_ROW_TOL).mean())
                                              for a in (apart, apart_64, apart_d64))
    out_d = see.replace_with_completed_pts(points, done_c)
    out_c = cpu.replace_with_completed_pts(points, done_c)
    n = len(done_c)
    kept_d, kept_c = ({tuple(r) for r in o[n:]} for o in (out_d, out_c))
    d = MD.min_sqdist_plain(torch.from_numpy(points[:, :3].copy()).to(see.device),
                            torch.from_numpy(done_c).to(see.device))
    tie = ((d - RADIUS * RADIUS).abs() <= 1e-5 * RADIUS * RADIUS).cpu().numpy()
    ties = {tuple(r) for r in points[tie, :3]}
    stray = len((kept_d ^ kept_c) - ties)
    res = {"instances": len(inst_c), "iso_apart_max": max(iso_apart),
           "isolated_points": len(iso), "isolated_in_car": in_car,
           "completed_rows": n, "completed_rows_card": len(done_d),
           "completed_rows_f64": len(done_64),
           "rows_apart_max": float(apart.max()), "rows_apart_share": row_share,
           "rows_apart_max_f64": float(apart_64.max()), "rows_apart_share_f64": row_share_64,
           "completed_rows_card_f64": len(done_d64),
           "rows_apart_max_card_f64": float(apart_d64.max()),
           "rows_apart_share_card_f64": row_share_d64,
           "kept_apart": len(kept_d ^ kept_c), "ties": int(tie.sum()),
           "dropped": see.last_stats["dropped"]}
    if max(iso_apart) > SEE_ISO_SLACK or row_share > SEE_ROW_SHARE or stray \
            or abs(len(done_d) - n) > SEE_ROW_SLACK \
            or (path == "det" and in_car < WORKFLOW_IN_CAR):
        raise AssertionError(f"SEE {path} frame {idx} on the card off the CPU path: {res}")
    return res


def kitti_workflow(dev, card) -> dict:
    """Phase 20: the KITTI SEE-VCN workflow through the port's CLIs on a raw
    tree of WORKFLOW_FRAMES frames of WORKFLOW_POINTS points: create_infos;
    generate_masks with the seeded Mask R-CNN at 384 x 1280 (jax:<ckpt>,
    images/s); a mask file from the cars' projected boxes; run_see's DET
    path at KIT-DET_VCN-VC's settings (K1 counted, a second run that skips
    every frame, the GT path), the native IO route asserted; one frame of
    each path card vs CPU; train_detector at SECOND-IoU's flagship widths on
    the completed split (batch 4, one epoch, then a resume for a second,
    rotation to one checkpoint) and test_detector on DATA_CONFIG_TAR."""
    from seevcn_torch.cli import create_infos as CI
    from seevcn_torch.cli import generate_masks as GM
    from seevcn_torch.cli import run_see as RS
    from seevcn_torch.cli import test_detector as TD
    from seevcn_torch.cli import train_detector as TR
    from seevcn_torch.data.kitti.see_adapter import KittiObjects
    from seevcn_torch.see.pipeline import SEEVCN
    from seevcn_torch.utils import native_io as NIO
    from seevcn_torch.utils.config import cfg_from_yaml_file

    parts, res = {}, {}
    on = ["--device", dev.type]
    t_phase = t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="kitti_workflow_") as root:
        # (a) the raw tree: velodyne, calib, image_2, label_2, ImageSets
        infos = write_kitti_split(root, WORKFLOW_FRAMES, seed=20, n_points=WORKFLOW_POINTS,
                                  n_cars=WORKFLOW_CARS, labels=True, occlude=True)
        for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl", "kitti_dbinfos_train.pkl"):
            os.remove(os.path.join(root, name))
        shutil.rmtree(os.path.join(root, "gt_database"))
        parts["raw_tree"], t0 = time.time() - t0, time.time()

        # (b) create_infos, held against the writer's annos
        paths = CI.main(["--dataset", "kitti", "--root", root, "--workers", "4"])
        with open(paths["val"], "rb") as f:
            made = pickle.load(f)
        # the boxes come back from the labels' 9 digits (about 2e-6 m off), so
        # a point on a face may fall on the other side: NUM_POINTS_SLACK a box
        box_err = max(float(np.abs(m["annos"]["gt_boxes_lidar"]
                                   - i["annos"]["gt_boxes_lidar"]).max())
                      for m, i in zip(made, infos))
        count_err = max(int(np.abs(m["annos"]["num_points_in_gt"]
                                   - i["annos"]["num_points_in_gt"]).max())
                        for m, i in zip(made, infos))
        if len(made) != len(infos) or box_err > 1e-5 or count_err > NUM_POINTS_SLACK or any(
                list(m["annos"]["name"]) != list(i["annos"]["name"]) for m, i in zip(made, infos)):
            raise AssertionError(f"create_infos off the written annos: boxes {box_err} m, "
                                 f"num_points_in_gt {count_err}")
        res["create_infos"] = {"box_err_m": box_err, "num_points_in_gt_err": count_err,
                               "boxes": sum(len(m["annos"]["name"]) for m in made)}
        parts["create_infos"], t0 = time.time() - t0, time.time()

        # (c) generate_masks with the seeded Mask R-CNN on the camera images
        seg_cfg = SM.Seg2DConfig(image_size=IMAGE_SIZE)
        ckpt = os.path.join(root, "seg2d.ckpt")
        save_seg2d_checkpoint(ckpt, init_seg2d(SM.MaskRCNN(seg_cfg),
                                               torch.Generator().manual_seed(0)), seg_cfg)
        masks = GM.main(["--image_dir", os.path.join(root, "training", "image_2"),
                         "--out", os.path.join(root, "masks_model.json"),
                         "--backend", f"jax:{ckpt}", "--score_thresh", str(MASK_SCORE_THRESH)]
                        + on)
        with open(masks["out"]) as f:
            coco = json.load(f)
        n_polys = sum(len(a["segmentation"]) for a in coco["annotations"])
        if not coco["annotations"] or n_polys < 1:
            raise AssertionError("generate_masks wrote no polygon from the model's masks")
        res["generate_masks"] = {"images": masks["images"], "detections": masks["detections"],
                                 "annotations": len(coco["annotations"]), "polygons": n_polys,
                                 "s": masks["s"], "images_per_s": masks["images"] / masks["s"]}
        parts["generate_masks"], t0 = time.time() - t0, time.time()

        # (d) the masks SEE reads: the hull of each car's own projected points
        GM.detections_to_coco(car_hull_detections(root, infos),
                              os.path.join(root, "masks_image_2.json"))
        # (e) run_see's DET path, K1 counted, then a resumed run, then the GT path
        vcn_path = os.path.join(root, "VCN_VC.pth")
        torch.save({"base_model": seeded_vcn_state_dict(0)}, vcn_path)
        see_cfg = {"DATA": {"DATASET": "kitti", "DATA_DIR": root,
                            "INFO_PATHS": ["kitti_infos_val.pkl"],
                            "MASK_PATHS": {"image_2": "masks_image_2.json"},
                            "CAMERA_CHANNELS": ["image_2"], "TAG": "workflow",
                            "CLASSES": ["Car"], "SHRINK_MASK_PERCENTAGE": WORKFLOW_SHRINK},
                   **KIT_DET_VCN_VC}
        see_cfg["SURFACE_COMPLETION"] = {**see_cfg["SURFACE_COMPLETION"], "VCN": {
            **see_cfg["SURFACE_COMPLETION"]["VCN"], "CKPT_PATH": vcn_path}}
        see_yaml = write_yaml(os.path.join(root, "KIT-DET_VCN-VC.yaml"), see_cfg)
        K.reset_launches()
        det = RS.main(["--cfg_file", see_yaml, "--path", "det"] + on)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = K.LAUNCHES["min_sqdist_pruned"]
        frames = det["frames"]
        if not NIO.native_available():
            raise AssertionError("native_io took the numpy route: the library did not build")
        if len(frames) != WORKFLOW_FRAMES or launches < WORKFLOW_FRAMES:
            raise AssertionError(f"run_see: {len(frames)} frames written, K1 launched "
                                 f"{launches} times")
        if any(r["completed"] < 1 or r["dropped"] < WORKFLOW_MIN_DROPPED * r["completed"]
               for r in frames.values()):
            raise AssertionError(f"run_see did no real work in a frame: {frames}")
        again = RS.main(["--cfg_file", see_yaml, "--path", "det"] + on)
        if again["frames"]:
            raise AssertionError("run_see's second run did not skip every frame")
        gt = RS.main(["--cfg_file", see_yaml, "--path", "gt", "--save_dir",
                      os.path.join(root, "vcn_gt")] + on)
        if len(gt["frames"]) != WORKFLOW_FRAMES or any(
                r["completed"] < 1 for r in gt["frames"].values()):
            raise AssertionError(f"run_see --path gt: {gt['frames']}")
        res["run_see"] = {"det": {i: {k: r[k] for k in ("s", "isolated", "completed",
                                                        "dropped")} for i, r in frames.items()},
                          "gt": {i: {k: r[k] for k in ("s", "isolated", "completed",
                                                       "dropped")}
                                 for i, r in gt["frames"].items()},
                          "k1_launches": launches, "native_io": NIO.native_available()}
        parts["run_see"], t0 = time.time() - t0, time.time()

        # (f) one frame of each path on the card against the CPU path
        cfg = cfg_from_yaml_file(see_yaml)
        data_obj = KittiObjects(cfg.DATA)
        card_see = SEEVCN(cfg, data_obj=data_obj, device=dev)
        cpu_see = SEEVCN(cfg, data_obj=data_obj, device="cpu")
        res["card_vs_cpu"] = {p: hold_see_frame_against_cpu(card_see, cpu_see, 0, p)
                              for p in ("det", "gt")}
        parts["card_vs_cpu"], t0 = time.time() - t0, time.time()

        # (g) train_detector on the completed split, then a resume
        det_cfg = DC.flagship_detector_cfg()
        dc = kitti_cfg(root, DATASET="SCKittiDataset", PROCESSED_DATA_TAG="vcn_workflow",
                       INFO_PATH={"train": [os.path.relpath(det["infos"], root)],
                                  "test": [os.path.relpath(det["infos"], root)]},
                       POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z"],
                                               "src_feature_list": ["x", "y", "z"]},
                       DATA_AUGMENTOR=KITTI_AUGMENTOR)
        dc["DATA_PROCESSOR"] = list(dc.DATA_PROCESSOR) + list(det_cfg.DATA_CONFIG.DATA_PROCESSOR)
        det_cfg["DATA_CONFIG"] = dc
        det_cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 4
        det_yaml = write_yaml(os.path.join(root, "second_iou_sc_kitti.yaml"), det_cfg)
        out_dir = os.path.join(root, "output")
        common = ["--cfg_file", det_yaml, "--output_dir", out_dir, "--max_ckpt_save_num", "1",
                  "--fix_random_seed"] + on
        first = TR.main(common + ["--epochs", "1"])
        after_first = {k: v.detach().cpu().clone()
                       for k, v in first["state"].model.state_dict().items()}
        second = TR.main(common + ["--epochs", "2"])
        resumed = second["resumed"]
        if resumed is None or resumed["epoch"] != 0 or resumed["step"] != first["state"].step \
                or any(not torch.equal(resumed["state_dict"][k], v)
                       for k, v in after_first.items()):
            raise AssertionError("train_detector's resume did not read epoch 0's weights "
                                 "bit for bit")
        names = [os.path.basename(c) for c in second["ckpts"]]
        if names != ["checkpoint_epoch_1.pth"] or not all(
                math.isfinite(v) for v in first["losses"] + second["losses"]):
            raise AssertionError(f"train_detector: checkpoints {names}, losses "
                                 f"{first['losses'] + second['losses']}")
        res["train_detector"] = {"losses": first["losses"] + second["losses"],
                                 "steps": second["state"].step,
                                 "step_s": first["steps_s"] + second["steps_s"],
                                 "ckpts": names, "resumed_step": resumed["step"]}
        parts["train_detector"], t0 = time.time() - t0, time.time()

        # (h) test_detector on the newest checkpoint with DATA_CONFIG_TAR
        tar_yaml = write_yaml(os.path.join(root, "second_iou_sc_kitti_tar.yaml"), {
            **plain_tree(det_cfg), "DATA_CONFIG_TAR": {**plain_tree(kitti_cfg(root)),
                                                       "CLASS_NAMES": ["Car"]}})
        report, ap, recall = TD.main(["--cfg_file", tar_yaml, "--ckpt", second["ckpts"][-1],
                                      "--batch_size", "4"] + on)
        n_gt = sum(len(i["annos"]["name"]) for i in infos)
        if report is None or "Car AP_R40" not in report or recall["num_gt"] != n_gt:
            raise AssertionError(f"test_detector: num_gt {recall['num_gt']} of {n_gt}; "
                                 f"report {report}")
        res["test_detector"] = {"ap_keys": sorted(f"{c}/{m}" for c in ap for m in ap[c]),
                                "recall": recall}
        parts["test_detector"] = time.time() - t0
    res["part_s"], res["phase_s"] = parts, time.time() - t_phase
    gm, rs = res["generate_masks"], res["run_see"]
    print(f"generate_masks (seeded Mask R-CNN at {IMAGE_SIZE[0]}x{IMAGE_SIZE[1]}, score >= "
          f"{MASK_SCORE_THRESH}): {gm['images']} images of 375x1242 in {gm['s']:.2f} s = "
          f"{gm['images_per_s']:.2f} images/s, detections a image {gm['detections']}, "
          f"{gm['annotations']} annotations, {gm['polygons']} polygons on {card}")
    print("run_see --path det (KIT-DET_VCN-VC, VCN_VC at 1,024 points) by frame: " + "; ".join(
        f"{i}: {r['s']:.3f} s, {r['isolated']} isolated, {r['completed']} completed, "
        f"{r['dropped']} scan points dropped" for i, r in rs["det"].items())
        + f"; K1 launches {rs['k1_launches']}; native IO route {rs['native_io']}; --path gt "
        "by frame: " + "; ".join(f"{i}: {r['s']:.3f} s, {r['completed']} completed, "
                                 f"{r['dropped']} dropped" for i, r in rs["gt"].items()))
    print("SEE frame 0, card vs CPU stage by stage: " + "; ".join(
        f"{p}: {r['instances']} instances, points apart <= {r['iso_apart_max']} an instance, "
        f"{r['isolated_points']} isolated points, share on a car {r['isolated_in_car']:.4f}; "
        f"{r['completed_rows']} / {r['completed_rows_card']} completed rows on the CPU / the card "
        f"(max {r['rows_apart_max']:.3g} m apart, share past {SEE_ROW_TOL} m "
        f"{r['rows_apart_share']:.6f}); the CPU's f64 witness {r['completed_rows_f64']} rows "
        f"(max {r['rows_apart_max_f64']:.3g} m from the CPU's f32, share past {SEE_ROW_TOL} m "
        f"{r['rows_apart_share_f64']:.6f}), the card's f64 {r['completed_rows_card_f64']} rows "
        f"(max {r['rows_apart_max_card_f64']:.3g} m from the CPU's f64, share past "
        f"{SEE_ROW_TOL} m {r['rows_apart_share_card_f64']:.6f}); kept points apart "
        f"{r['kept_apart']} (ties "
        f"{r['ties']})" for p, r in res["card_vs_cpu"].items()))
    td = res["train_detector"]
    print(f"train_detector (SECOND-IoU flagship widths, batch 4, SCKittiDataset with the GT "
          f"paste): losses {', '.join(f'{v:.4f}' for v in td['losses'])}, step s "
          f"{', '.join(f'{v:.3f}' for v in td['step_s'])}, resumed at step "
          f"{td['resumed_step']} bit for bit, checkpoints kept {td['ckpts']}; test_detector on "
          f"DATA_CONFIG_TAR: recall {res['test_detector']['recall']}, AP keys "
          f"{res['test_detector']['ap_keys']}")
    print("phase 20 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return res


# --- phase 21: the other domains: Waymo -> nuScenes, Lyft and Baraja -----------------

#: phase 21's trees, DOMAIN_FRAMES frames each of make_scene's layout (DOMAIN_CARS
#: cars, the background the cars hide left out): Waymo's frame of its five lidars
#: (150,000 points), a nuScenes / Lyft 32-beam sweep (34,700 points; 2 sweeps a
#: sample), and a Baraja Spectrum-Scan frame (60,000 points: the repo holds no
#: published count for it)
DOMAIN_FRAMES, DOMAIN_CARS = 4, 8
WAYMO_POINTS, NUS_POINTS, BARAJA_POINTS = 150_000, 34_700, 60_000
#: nuScenes' six cameras (900 x 1600, CAM_FRONT's intrinsics) by yaw from the
#: ego's heading, in degrees; the lidar's mount on the ego
NUS_IMAGE = (900, 1600)
NUS_K = np.array([[1266.0, 0.0, 816.0], [0.0, 1266.0, 491.0], [0.0, 0.0, 1.0]])
NUS_CAMERAS = (("CAM_FRONT", 0.0), ("CAM_FRONT_RIGHT", -55.0), ("CAM_BACK_RIGHT", -110.0),
               ("CAM_BACK", 180.0), ("CAM_BACK_LEFT", 110.0), ("CAM_FRONT_LEFT", 55.0))
NUS_LIDAR_T = (0.94, 0.0, 1.84)
#: Waymo's five cameras: yaw in degrees and image (H, W), a 2,000-pixel focal
#: length, all at the lidar's origin
WAYMO_CAMERAS = (("FRONT", 0.0, (1280, 1920)), ("FRONT_LEFT", 45.0, (1280, 1920)),
                 ("FRONT_RIGHT", -45.0, (1280, 1920)), ("SIDE_LEFT", 90.0, (886, 1920)),
                 ("SIDE_RIGHT", -90.0, (886, 1920)))
WAYMO_FOCAL = 2000.0
WAYMO_SEQ = "segment-0000000000000000021_000_000_000_000"
#: the Baraja tree's front camera: json calibration, equidistant fisheye
BARAJA_IMAGE = (1080, 1920)
BARAJA_CALIB = {"intrinsic": [[900.0, 0.0, 960.0], [0.0, 900.0, 540.0], [0.0, 0.0, 1.0]],
                "extrinsic": [[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                              [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                "distcoeff": [0.02, -0.01, 0.005, -0.002]}
#: the projected points of a car a camera must hold for its mask
HULL_MIN_POINTS = 10


def quat_from_rotmat(r: np.ndarray) -> list:
    """(3, 3) rotation -> nuScenes' (w, x, y, z) quaternion (Shepperd's
    method: from the largest of the four squares)."""
    t = np.trace(r)
    sq = [1 + t, 1 + r[0, 0] - r[1, 1] - r[2, 2], 1 - r[0, 0] + r[1, 1] - r[2, 2],
          1 - r[0, 0] - r[1, 1] + r[2, 2]]
    k = int(np.argmax(sq))
    s = 2 * np.sqrt(sq[k])
    q = {0: (s / 4, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s),
         1: ((r[2, 1] - r[1, 2]) / s, s / 4, (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s),
         2: ((r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, s / 4, (r[1, 2] + r[2, 1]) / s),
         3: ((r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s, s / 4)}[k]
    return [float(v) for v in q]


def camera_rotation(yaw_deg: float) -> np.ndarray:
    """The rotation of a camera looking along ``yaw_deg`` in the horizontal
    plane: its columns are the camera's x (right), y (down) and z (forward)
    axes in the frame it is mounted in."""
    a = np.deg2rad(yaw_deg)
    return np.array([[np.sin(a), 0.0, np.cos(a)], [-np.cos(a), 0.0, np.sin(a)],
                     [0.0, -1.0, 0.0]])


def hull_detection(uv: np.ndarray, image_shape, category_id: int = 2):
    """A detection outlining one car's projected points ``uv`` (N, 2), as a
    segmentation model would: the convex hull of those in the image as its
    COCO polygon, its extent as its box, score 0.9; None with fewer than
    HULL_MIN_POINTS in the image."""
    h, w = image_shape
    uv = uv[(uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)]
    if len(uv) < HULL_MIN_POINTS:
        return None
    hull = convex_hull(np.round(uv))
    if len(hull) < 3:
        return None
    (x0, y0), (x1, y1) = hull.min(0), hull.max(0)
    return {"segmentation": [hull.ravel().tolist()],
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "score": 0.9, "category_id": category_id}


def cars_inside(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3+), (M, 7+) -> (M, N) bool: each box's points."""
    from seevcn_torch.geom import boxes as GB

    return GB.points_in_boxes(
        torch.from_numpy(np.ascontiguousarray(points[:, :3], np.float32)),
        torch.from_numpy(np.ascontiguousarray(boxes[:, :7], np.float32))).numpy()


def write_nuscenes_tree(root: str, n_samples: int, seed: int = 0, n_points: int = NUS_POINTS,
                        n_cars: int = DOMAIN_CARS, layout: str = "nuscenes",
                        cameras=NUS_CAMERAS) -> list:
    """A raw tree of the nuScenes release (``layout="nuscenes"``: tables under
    ``<root>/v1.0-trainval``, ``samples/`` and ``sweeps/``) or of Lyft's
    (``"lyft"``: tables under ``<root>/trainval/data``, files under
    ``trainval/``, ``ImageSets/train.txt``, no point counts in the
    annotations) with one scene of ``n_samples`` samples. A sample is
    ``make_scene(2 * n_points, n_cars, occlude=True)`` split into its LIDAR_TOP
    keyframe and the sweep 50 ms before it (the ego 0.5 m behind; 5 floats a
    point), each car a car annotation in the global frame, and ``cameras``
    (name, yaw) of NUS_IMAGE with NUS_K at the lidar's position. With
    the nuScenes layout, ``masks/<camera>.json`` holds a detection a car and
    camera from the hull of its projected points (``hull_detection``), so a
    car on the edge of two cameras is in both. -> a sample each: {"token",
    "boxes" (n_cars, 7) in the keyframe's lidar frame, "num_points" (the
    keyframe's points in each box)}."""
    from seevcn_torch.cli.generate_masks import detections_to_coco

    lyft = layout == "lyft"
    base = os.path.join(root, "trainval") if lyft else root     # the files' root
    tdir = os.path.join(base, "data") if lyft else os.path.join(root, "v1.0-trainval")
    os.makedirs(tdir, exist_ok=True)
    lidar_t = np.asarray(NUS_LIDAR_T)
    sensors = [{"token": "sens_lidar", "channel": "LIDAR_TOP", "modality": "lidar"}]
    cal = [{"token": "cs_lidar", "sensor_token": "sens_lidar", "translation": list(NUS_LIDAR_T),
            "rotation": [1.0, 0.0, 0.0, 0.0], "camera_intrinsic": []}]
    mounts = {}
    for ch, yaw in cameras:
        # at the lidar's position: make_scene leaves out what the cars hide
        # from the lidar, which is then what they hide from each camera
        mounts[ch] = (camera_rotation(yaw), lidar_t.copy())
        sensors.append({"token": f"sens_{ch}", "channel": ch, "modality": "camera"})
        cal.append({"token": f"cs_{ch}", "sensor_token": f"sens_{ch}",
                    "translation": mounts[ch][1].tolist(),
                    "rotation": quat_from_rotmat(mounts[ch][0]),
                    "camera_intrinsic": NUS_K.tolist()})
    scene_name = "host-a101-lidar0-1" if lyft else "scene-0001"
    tables = {"scene": [{"token": "scene0", "name": scene_name, "first_sample_token": "sample00",
                         "nbr_samples": n_samples}],
              "sample": [], "sample_data": [], "ego_pose": [], "sample_annotation": [],
              "instance": [], "category": [{"token": "cat_car",
                                            "name": "car" if lyft else "vehicle.car"}],
              "sensor": sensors, "calibrated_sensor": cal}
    per_camera = {ch: [] for ch, _ in cameras}
    out = []
    t0 = 1_533_000_000_000_000
    for i in range(n_samples):
        tok = f"sample{i:02d}"
        rng = np.random.RandomState(seed * 1000 + i)
        scene = make_scene(seed * 1000 + i, 2 * n_points, n_cars, occlude=True)
        key, boxes = scene["points"][:n_points], scene["gt_boxes"][:, :7].astype(np.float64)
        ts, ego = t0 + i * 500_000, np.array([50.0 * i, 0.0, 0.0])
        tables["sample"].append({"token": tok, "timestamp": ts, "scene_token": "scene0",
                                 "prev": f"sample{i - 1:02d}" if i else "",
                                 "next": f"sample{i + 1:02d}" if i < n_samples - 1 else ""})
        # the sweep 50 ms earlier holds the other half of the points, in its
        # own lidar frame (the ego 0.5 m behind: a static point sits 0.5 m
        # farther ahead), then the keyframe
        for name, pts, dt, shift in (("prev", scene["points"][n_points:] + [0.5, 0, 0],
                                      -50_000, -0.5), ("key", key, 0, 0.0)):
            sub = "lidar" if lyft else ("samples" if name == "key" else "sweeps") + "/LIDAR_TOP"
            fn = f"{sub}/{tok}_{name}.bin" if lyft else f"{sub}/{tok}_{name}.pcd.bin"
            os.makedirs(os.path.join(base, sub), exist_ok=True)
            raw = np.zeros((len(pts), 5), np.float32)
            raw[:, :3], raw[:, 3] = pts, rng.randint(0, 256, len(pts))
            raw.tofile(os.path.join(base, fn))
            sd = f"sd_{tok}_{name}"
            tables["ego_pose"].append({"token": f"ego_{sd}", "timestamp": ts + dt,
                                       "translation": (ego + [shift, 0, 0]).tolist(),
                                       "rotation": [1.0, 0.0, 0.0, 0.0]})
            tables["sample_data"].append({
                "token": sd, "sample_token": tok, "ego_pose_token": f"ego_{sd}",
                "calibrated_sensor_token": "cs_lidar", "timestamp": ts + dt,
                "fileformat": "bin" if lyft else "pcd", "is_key_frame": name == "key",
                "filename": fn, "prev": "" if name == "prev" else f"sd_{tok}_prev",
                "next": f"sd_{tok}_key" if name == "prev" else ""})
        for ch, _ in cameras:
            sub = "images" if lyft else f"samples/{ch}"
            fn = f"{sub}/{tok}_{ch}.jpeg" if lyft else f"{sub}/{tok}.jpg"
            os.makedirs(os.path.join(base, sub), exist_ok=True)
            with open(os.path.join(base, fn), "wb") as f:
                f.write(b"\xff\xd8\xff\xe0")
            tables["sample_data"].append({
                "token": f"sd_{tok}_{ch}", "sample_token": tok,
                "ego_pose_token": f"ego_sd_{tok}_key", "calibrated_sensor_token": f"cs_{ch}",
                "timestamp": ts, "fileformat": "jpg", "is_key_frame": True, "filename": fn,
                "width": NUS_IMAGE[1], "height": NUS_IMAGE[0], "prev": "", "next": ""})
        inside = cars_inside(key, boxes)
        for j, box in enumerate(boxes):
            ann = {"token": f"ann_{tok}_{j}", "sample_token": tok,
                   "instance_token": f"inst_{tok}_{j}",
                   "translation": (ego + lidar_t + box[:3]).tolist(),
                   "size": [box[4], box[3], box[5]],                       # w, l, h
                   "rotation": [float(np.cos(box[6] / 2)), 0.0, 0.0, float(np.sin(box[6] / 2))],
                   "prev": "", "next": "", "visibility_token": "4", "attribute_tokens": []}
            if not lyft:
                ann.update(num_lidar_pts=int(inside[j].sum()), num_radar_pts=0)
            tables["sample_annotation"].append(ann)
            tables["instance"].append({"token": f"inst_{tok}_{j}", "category_token": "cat_car",
                                       "nbr_annotations": 1})
        inside_all = cars_inside(scene["points"], boxes)
        for ch, _ in ([] if lyft else cameras):
            r, t = mounts[ch]
            dets = []
            for j in range(len(boxes)):
                cam = (scene["points"][inside_all[j]] + lidar_t - t) @ r
                front = cam[cam[:, 2] > 1.0]
                uv = front[:, :2] / front[:, 2:] * NUS_K[[0, 1], [0, 1]] + NUS_K[[0, 1], 2]
                d = hull_detection(uv, NUS_IMAGE)
                if d is not None:
                    dets.append(d)
            per_camera[ch].append((tok, NUS_IMAGE, dets))
        out.append({"token": tok, "boxes": boxes, "num_points": inside.sum(1)})
    for name, rows in tables.items():
        with open(os.path.join(tdir, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    if lyft:
        os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
        with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
            f.write(scene_name + "\n")
    else:
        for ch, _ in cameras:
            detections_to_coco(per_camera[ch], os.path.join(root, "masks", f"{ch}.json"))
    return out


def write_waymo_tree(root: str, n_frames: int, seed: int = 0, n_points: int = WAYMO_POINTS,
                     n_cars: int = DOMAIN_CARS, seq: str = WAYMO_SEQ) -> list:
    """A processed Waymo tree under ``root``, as the reference's preprocessing
    leaves it (decoding the TFRecords needs the waymo_open_dataset SDK):
    ``make_scene(n_points, n_cars, occlude=True)`` frames as 6-column points
    (x y z intensity elongation, the no-label-zone flag -1) and Vehicle
    labels, through ``process_single_sequence(frames=...)`` into
    ``waymo_processed_data/<seq>/``; ``ImageSets/train.txt``; the five
    cameras' precomputed projections
    (``image_lidar_projections/{image_pc,fov_inds}/<camera>/<seq>_<idx:04d>.npy``)
    and their masks (``image_lidar_projections/masks/<camera>.json``, the hull
    of each car's projected points). -> the infos."""
    from seevcn_torch.cli.generate_masks import detections_to_coco
    from seevcn_torch.data.waymo_bootstrap import process_single_sequence

    proj = os.path.join(root, "image_lidar_projections")
    frames, per_camera = [], {c: [] for c, _, _ in WAYMO_CAMERAS}
    for i in range(n_frames):
        rng = np.random.RandomState(seed * 1000 + i)
        scene = make_scene(seed * 1000 + i, n_points, n_cars, occlude=True)
        pts, boxes = scene["points"], scene["gt_boxes"][:, :7]
        feats = np.zeros((n_points, 6), np.float32)
        feats[:, :3], feats[:, 3], feats[:, 4], feats[:, 5] = pts, rng.rand(n_points), \
            rng.rand(n_points) * 0.1, -1.0
        inside = cars_inside(pts, boxes)
        frames.append({
            "points": feats,
            "labels": [{"name": "Vehicle", "box": boxes[j].tolist(),
                        "difficulty": 1 if inside[j].sum() > 5 else 2, "tracking_difficulty": 1,
                        "num_points_in_gt": int(inside[j].sum()), "obj_id": f"veh_{i}_{j}"}
                       for j in range(len(boxes))],
            "pose": np.eye(4, dtype=np.float32), "context_name": seq,
            "timestamp_micros": 1_550_000_000_000_000 + i * 100_000,
            "image_shapes": [shape for _, _, shape in WAYMO_CAMERAS],
            "num_points_of_each_lidar": [n_points]})
        stem = f"{seq}_{i:04d}"
        for cam, yaw, (h, w) in WAYMO_CAMERAS:
            c = pts.astype(np.float64) @ camera_rotation(yaw)
            z = np.where(c[:, 2] > 0.5, c[:, 2], 1.0)
            uv = np.stack([WAYMO_FOCAL * c[:, 0] / z + w / 2,
                           WAYMO_FOCAL * c[:, 1] / z + h / 2], 1)
            fov = (c[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) \
                & (uv[:, 1] < h)
            for sub, arr in (("image_pc", uv[fov]), ("fov_inds", fov)):
                os.makedirs(os.path.join(proj, sub, cam), exist_ok=True)
                np.save(os.path.join(proj, sub, cam, f"{stem}.npy"), arr)
            dets = [d for d in (hull_detection(uv[fov & inside[j]], (h, w))
                                for j in range(len(boxes))) if d is not None]
            per_camera[cam].append((stem, (h, w), dets))
    infos = process_single_sequence(f"{seq}_with_camera_labels.tfrecord",
                                    os.path.join(root, "waymo_processed_data"), frames=frames)
    for cam, _, _ in WAYMO_CAMERAS:
        detections_to_coco(per_camera[cam], os.path.join(proj, "masks", f"{cam}.json"))
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write(f"{seq}.tfrecord\n")
    return infos


def write_baraja_tree(root: str, n_frames: int, seed: int = 0, n_points: int = BARAJA_POINTS,
                      n_cars: int = DOMAIN_CARS) -> list:
    """A Baraja Spectrum-Scan tree (the reference's custom dataset) under
    ``root``: ``test/pcd/<idx>.pcd`` (``make_scene(n_points, n_cars,
    occlude=True)``), ``test/calib/<idx>.json`` (BARAJA_CALIB: the front
    camera's intrinsics, extrinsics and equidistant-fisheye coefficients),
    ``infos/baraja_infos_test.pkl`` (lidar_idx, image shape, Car annos with
    num_points_in_gt) and ``test/masks/front.json`` (the hull of each car's
    points projected through the fisheye). -> the infos."""
    from seevcn_torch.cli.generate_masks import detections_to_coco
    from seevcn_torch.geom.calibration import JsonCalibration
    from seevcn_torch.geom.pcd_io import write_pcd

    calib = JsonCalibration({**BARAJA_CALIB, "distortion_model": "fisheye"})
    for sub in ("pcd", "calib"):
        os.makedirs(os.path.join(root, "test", sub), exist_ok=True)
    os.makedirs(os.path.join(root, "infos"), exist_ok=True)
    infos, per_image = [], []
    for i in range(n_frames):
        fid = f"{i:06d}"
        scene = make_scene(seed * 1000 + i, n_points, n_cars, occlude=True)
        pts, boxes = scene["points"], scene["gt_boxes"][:, :7]
        write_pcd(os.path.join(root, "test", "pcd", f"{fid}.pcd"), pts)
        with open(os.path.join(root, "test", "calib", f"{fid}.json"), "w") as f:
            json.dump(BARAJA_CALIB, f)
        inside = cars_inside(pts, boxes)
        dets = []
        for j in range(len(boxes)):
            uv, depth = calib.lidar_to_img(pts[inside[j]])
            d = hull_detection(uv[depth > 1.0], BARAJA_IMAGE)
            if d is not None:
                dets.append(d)
        per_image.append((f"{fid}.jpg", BARAJA_IMAGE, dets))
        infos.append({"point_cloud": {"lidar_idx": fid},
                      "image": {"image_shape": np.array(BARAJA_IMAGE)},
                      "annos": {"name": np.array(["Car"] * len(boxes)),
                                "gt_boxes_lidar": boxes.astype(np.float32),
                                "num_points_in_gt": inside.sum(1)}})
    with open(os.path.join(root, "infos", "baraja_infos_test.pkl"), "wb") as f:
        pickle.dump(infos, f)
    detections_to_coco(per_image, os.path.join(root, "test", "masks", "front.json"))
    return infos


#: the demo (phase 22): a frame of make_scene's cloud with occluded cars, one
#: front camera at the lidar (no distortion) of the demo's default 720 x 1260
#: image, which is the committed JPEG fixture of that size. 56,000 points so
#: that the completed frame (about 3,400 rows more: 8 cars' completions less
#: the points they replace) fits the demo detector's 60,000-row pad
DEMO_POINTS, DEMO_CARS = 56_000, 8
DEMO_IMAGE = (720, 1260)
DEMO_CALIB = {"intrinsic": [[640.0, 0.0, 630.0], [0.0, 640.0, 360.0], [0.0, 0.0, 1.0]],
              "extrinsic": [[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0],
                            [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]]}
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "jpeg")
DEMO_JPEG = os.path.join(JPEG_FIXTURES, "demo_720x1260_420.jpg")
#: the same picture, progressive, behind an EXIF segment with a 16 x 9 thumbnail
DEMO_JPEG_EXIF = os.path.join(JPEG_FIXTURES, "demo_720x1260_progressive_exif.jpg")
#: phase 22's timed decodes: the nuScenes-size fixture of each entropy coding
JPEG_TIMED = {"baseline": "nuscenes_900x1600_420.jpg",
              "progressive": "nuscenes_900x1600_progressive.jpg",
              "arithmetic": "arithmetic_900x1600.jpg"}


def write_demo_tree(root: str, n_frames: int = 1, seed: int = 0, n_points: int = DEMO_POINTS,
                    n_cars: int = DEMO_CARS) -> list:
    """The demo's tree under ``root`` (``data/demo_dataset.py``):
    ``pcd/<idx>.pcd`` (``make_scene(n_points, n_cars, occlude=True)``),
    ``calib/<idx>.json`` (DEMO_CALIB), ``image/front/<idx>.jpg`` (the
    720 x 1260 JPEG fixture) and ``masks/front.json`` (the hull of each car's
    points projected into the image). -> each frame's car boxes (n_cars, 7)."""
    from seevcn_torch.cli.generate_masks import detections_to_coco
    from seevcn_torch.geom.calibration import JsonCalibration
    from seevcn_torch.geom.pcd_io import write_pcd

    calib = JsonCalibration(DEMO_CALIB)
    for sub in ("pcd", "calib", os.path.join("image", "front"), "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    per_image, boxes_out = [], []
    for i in range(n_frames):
        fid = f"{i:06d}"
        scene = make_scene(seed * 1000 + i, n_points, n_cars, occlude=True)
        pts, boxes = scene["points"], scene["gt_boxes"][:, :7]
        write_pcd(os.path.join(root, "pcd", f"{fid}.pcd"), pts)
        with open(os.path.join(root, "calib", f"{fid}.json"), "w") as f:
            json.dump(DEMO_CALIB, f)
        shutil.copyfile(DEMO_JPEG, os.path.join(root, "image", "front", f"{fid}.jpg"))
        inside = cars_inside(pts, boxes)
        dets = []
        for j in range(len(boxes)):
            uv, depth = calib.lidar_to_img(pts[inside[j]])
            d = hull_detection(uv[depth > 1.0], DEMO_IMAGE)
            if d is not None:
                dets.append(d)
        per_image.append((f"{fid}.jpg", DEMO_IMAGE, dets))
        boxes_out.append(boxes)
    detections_to_coco(per_image, os.path.join(root, "masks", "front.json"))
    return boxes_out


def domain_see_cfg(domain: str, root: str, tag: str, vcn_path: str) -> dict:
    """Phase 21's SEE config of ``domain`` (the reference adapters' keys) at
    KIT-DET_VCN-VC's isolation and completion settings."""
    data = {"waymo": {"DATASET": "waymo", "CAMERA_CHANNELS": [c for c, _, _ in WAYMO_CAMERAS],
                      "CLASSES": ["Car"], "SPLIT": "train"},
            "nuscenes": {"DATASET": "nuscenes", "VERSION": "v1.0-trainval",
                         "CAMERA_CHANNELS": [c for c, _ in NUS_CAMERAS], "CLASSES": ["car"],
                         "LIDAR_NSWEEPS": 2, "SPLIT": "train",
                         "INFO_PATHS": {"train": "nuscenes_infos_10sweeps_train.pkl"}},
            "baraja": {"DATASET": "custom", "SPLIT": "test", "CAMERA_CHANNELS": ["front"],
                       "CLASSES": ["Car"], "CAMERA_MODEL": "equidistant"}}[domain]
    cfg = {"DATA": {**data, "DATA_DIR": root, "TAG": tag,
                    "SHRINK_MASK_PERCENTAGE": WORKFLOW_SHRINK}, **KIT_DET_VCN_VC}
    cfg["SURFACE_COMPLETION"] = {**cfg["SURFACE_COMPLETION"], "VCN": {
        **cfg["SURFACE_COMPLETION"]["VCN"], "CKPT_PATH": vcn_path}}
    return cfg


def domain_data_cfg(name: str, root: str, info: str, src=("x", "y", "z"), **kw) -> Cfg:
    """A dataset config of phase 21 at the flagship's range: points x y z of
    ``src``, no augmentation; ``kw`` overrides."""
    cfg = {"DATASET": name, "DATA_PATH": root, "POINT_CLOUD_RANGE": [0, -40, -3, 70.4, 40, 1],
           "INFO_PATH": {"train": [info], "test": [info]},
           "POINT_FEATURE_ENCODING": {"encoding_type": "absolute_coordinates_encoding",
                                      "used_feature_list": ["x", "y", "z"],
                                      "src_feature_list": list(src)},
           "DATA_PROCESSOR": [{"NAME": "shuffle_points",
                               "SHUFFLE_ENABLED": {"train": True, "test": False}}]}
    cfg.update(kw)
    return Cfg(cfg)


#: the source's augmentations: kitti_dataset.yaml's but the GT paste (the
#: Waymo database holds 6-feature points, the completed clouds 3)
DOMAIN_AUGMENTOR = {"DISABLE_AUG_LIST": ["placeholder"],
                    "AUG_CONFIG_LIST": KITTI_AUGMENTOR["AUG_CONFIG_LIST"][1:]}


def flat_keys(ap: dict, prefix: str = "") -> dict:
    """A nested AP dict -> {"a/b/c": value}."""
    out = {}
    for k, v in ap.items():
        if isinstance(v, dict):
            out.update(flat_keys(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def metric_keys(metric: str, classes) -> set:
    """The keys of the JAX package's result dict of ``metric`` (the CPU tests
    hold the port's equal to JAX's)."""
    if metric == "waymo":
        return {f"{c}/L{lv}/{m}" for c in classes for lv in (1, 2) for m in ("AP", "APH")}
    if metric == "nuscenes":
        per = ["mAP", "trans_err", "scale_err", "orient_err"] + \
            [f"AP@{t}" for t in (0.5, 1.0, 2.0, 4.0)]
        return {f"{c}/{k}" for c in classes for k in per} | {
            "mAP", "NDS", "mtrans_err", "mscale_err", "morient_err"}
    if metric == "lyft":
        return set(classes) | {"mAP"}
    return {f"{c}/{m}/{d}" for c in classes for m in ("bbox", "bev", "3d") for d in (0, 1, 2)}


def domain_workflow(dev, card) -> dict:
    """Phase 21: the paper's multi-target run through the port's CLIs. A
    Waymo tree (the source) of DOMAIN_FRAMES frames of WAYMO_POINTS points,
    its GT database; nuScenes and Lyft trees (2 sweeps of NUS_POINTS a
    sample, six cameras) through create_infos, held against the writer's
    boxes; a Baraja tree. run_see's GT path on Waymo, its DET path on
    nuScenes, Waymo and Baraja (K1 counted: the replacement's, once a
    frame, apart from the multi-camera merge's, one a pair tested), one DET
    frame of each card vs CPU; train_detector (the flagship SECOND-IoU,
    batch 4, an epoch) on SCWaymoDataset; test_detector on Waymo (its AP /
    APH equal with the IoU on the card and on the CPU), SEE-completed
    nuScenes and Baraja, and Lyft, each with its own metric."""
    from seevcn_torch.cli import create_infos as CI
    from seevcn_torch.cli import run_see as RS
    from seevcn_torch.cli import test_detector as TD
    from seevcn_torch.cli import train_detector as TR
    from seevcn_torch.data import generic as GEN
    from seevcn_torch.data import waymo_eval as WE
    from seevcn_torch.data.see_adapters import SEE_ADAPTERS
    from seevcn_torch.data.waymo_bootstrap import create_waymo_groundtruth_database
    from seevcn_torch.see.pipeline import SEEVCN
    from seevcn_torch.utils.config import cfg_from_yaml_file

    parts, res = {}, {}
    on = ["--device", dev.type]
    n_gt = DOMAIN_FRAMES * DOMAIN_CARS
    t_phase = t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="domain_workflow_") as base:
        root = {k: os.path.join(base, k) for k in ("waymo", "nuscenes", "lyft", "baraja")}
        # (a) the trees
        write_waymo_tree(root["waymo"], DOMAIN_FRAMES, seed=21, n_points=WAYMO_POINTS)
        parts["tree_waymo"], t0 = time.time() - t0, time.time()
        written = {"nuscenes": write_nuscenes_tree(root["nuscenes"], DOMAIN_FRAMES, seed=22,
                                                       n_points=NUS_POINTS),
                   "lyft": write_nuscenes_tree(root["lyft"], DOMAIN_FRAMES, seed=23,
                                               n_points=NUS_POINTS, layout="lyft")}
        parts["tree_nuscenes_lyft"], t0 = time.time() - t0, time.time()
        write_baraja_tree(root["baraja"], DOMAIN_FRAMES, seed=24, n_points=BARAJA_POINTS)
        parts["tree_baraja"], t0 = time.time() - t0, time.time()

        # (b) Waymo's GT database; nuScenes' and Lyft's infos through create_infos
        with open(create_waymo_groundtruth_database(
                os.path.join(root["waymo"], "waymo_processed_data"), save_path=root["waymo"],
                sampled_interval=1), "rb") as f:
            vehicles = len(pickle.load(f).get("Vehicle", []))
        if vehicles != n_gt:
            raise AssertionError(f"the Waymo GT database holds {vehicles} of {n_gt} cars")
        res["infos"] = {"waymo_db_vehicles": vehicles}
        for key, flags in (("nuscenes", []), ("lyft", ["--version", "trainval"])):
            paths = CI.main(["--dataset", key, "--root", root[key], "--max_sweeps", "10",
                             "--classes", "car"] + flags)
            with open(paths["train"], "rb") as f:
                made = pickle.load(f)
            files = root[key] if key == "nuscenes" else os.path.join(root[key], "trainval")
            box_err = count_err = sweep_err = 0.0
            for m, w in zip(made, written[key]):
                box_err = max(box_err, float(np.abs(m["gt_boxes"][:, :7] - w["boxes"]).max()))
                pts = np.fromfile(os.path.join(files, m["lidar_path"]),
                                  np.float32).reshape(-1, 5)
                count_err = max(count_err, float(np.abs(cars_inside(pts, m["gt_boxes"]).sum(1)
                                                        - w["num_points"]).max()))
                sweep_err = max(sweep_err, float(np.abs(
                    m["sweeps"][0]["transform_matrix"][:3, 3] - [-0.5, 0.0, 0.0]).max()))
            if len(made) != DOMAIN_FRAMES or box_err > 1e-5 or count_err > NUM_POINTS_SLACK \
                    or sweep_err > 1e-9 or any(list(m["gt_names"]) != ["car"] * DOMAIN_CARS
                                               or len(m["sweeps"]) != 9 for m in made):
                raise AssertionError(f"create_infos --dataset {key} off the written tree: boxes "
                                     f"{box_err} m, points in boxes {count_err}, sweep "
                                     f"{sweep_err} m")
            res["infos"][key] = {"box_err_m": box_err, "num_points_err": count_err,
                                 "sweep_err_m": sweep_err, "boxes": DOMAIN_CARS * len(made)}
        parts["create_infos"], t0 = time.time() - t0, time.time()

        # (c) run_see: GT on the source, DET on the targets; K1 counted
        vcn_path = os.path.join(base, "VCN_VC.pth")
        torch.save({"base_model": seeded_vcn_state_dict(0)}, vcn_path)
        yamls, runs, launches = {}, {}, {}
        for key, path in (("waymo", "gt"), ("nuscenes", "det"), ("waymo", "det"),
                          ("baraja", "det")):
            run = f"{key}_{path}"
            yamls[run] = write_yaml(os.path.join(base, f"see_{run}.yaml"),
                                    domain_see_cfg(key, root[key], path, vcn_path))
            K.reset_launches()
            t_run = time.time()
            out = RS.main(["--cfg_file", yamls[run], "--path", path] + on)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            run_s = time.time() - t_run
            frames = out["frames"]
            merge = sum(r.get("merge_checks", 0) for r in frames.values())
            merged = sum(r.get("merged", 0) for r in frames.values())
            replace = K.LAUNCHES["min_sqdist_pruned"] - merge
            launches[run] = {"replace": replace, "merge": merge, "merged_pairs": merged}
            if len(frames) != DOMAIN_FRAMES or not os.path.exists(out["infos"]) or any(
                    r["completed"] < 1 or r["dropped"] < WORKFLOW_MIN_DROPPED * r["completed"]
                    for r in frames.values()):
                raise AssertionError(f"run_see {run} did no real work in a frame: {frames}")
            if dev.type == "cuda" and replace != DOMAIN_FRAMES:
                raise AssertionError(f"run_see {run}: K1 launched {replace} times in the "
                                     f"replacement of {DOMAIN_FRAMES} frames")
            runs[run] = {"infos": out["infos"], "s": run_s, "frames": {
                i: {k: r.get(k, 0) for k in ("s", "isolated", "merged", "completed", "dropped")}
                for i, r in frames.items()}}
        if launches["nuscenes_det"]["merged_pairs"] < 1 or (
                dev.type == "cuda" and launches["nuscenes_det"]["merge"] < 1):
            raise AssertionError(f"no multi-camera merge on nuScenes: {launches}")
        res["run_see"], res["domain_see_launches"] = runs, launches
        parts["run_see"], t0 = time.time() - t0, time.time()

        # (d) one DET frame of each target dataset, card vs CPU
        res["card_vs_cpu"] = {}
        for key in ("nuscenes", "waymo", "baraja"):
            cfg = cfg_from_yaml_file(yamls[f"{key}_det"])
            data_obj = SEE_ADAPTERS[cfg.DATA.DATASET](cfg.DATA)
            res["card_vs_cpu"][key] = hold_see_frame_against_cpu(
                SEEVCN(cfg, data_obj=data_obj, device=dev),
                SEEVCN(cfg, data_obj=data_obj, device="cpu"), 0, "det")
        parts["card_vs_cpu"], t0 = time.time() - t0, time.time()

        # (e) train_detector: the flagship SECOND-IoU on SEE-completed Waymo
        det_cfg = DC.flagship_detector_cfg()

        def named(cfg, classes):
            """``cfg`` with the one-class head's anchors and CLASS_NAMES named
            after ``classes`` (test_detector builds the model with the
            target's names, as JAX's does; the weights do not depend on it)."""
            cfg = Cfg(copy.deepcopy(plain_tree(cfg)))
            cfg["CLASS_NAMES"] = list(classes)
            cfg.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]["class_name"] = classes[0]
            return cfg

        det_cfg = named(det_cfg, ["Vehicle"])
        dc = domain_data_cfg("SCWaymoDataset", root["waymo"],
                             os.path.relpath(runs["waymo_gt"]["infos"], root["waymo"]),
                             DATA_AUGMENTOR=DOMAIN_AUGMENTOR)
        dc["DATA_PROCESSOR"] = list(dc.DATA_PROCESSOR) + list(det_cfg.DATA_CONFIG.DATA_PROCESSOR)
        det_cfg["DATA_CONFIG"] = dc
        det_cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 4
        train_yaml = write_yaml(os.path.join(base, "second_iou_sc_waymo.yaml"), det_cfg)
        trained = TR.main(["--cfg_file", train_yaml, "--output_dir",
                           os.path.join(base, "output"), "--epochs", "1",
                           "--fix_random_seed"] + on)
        if not trained["ckpts"] or not trained["losses"] or not all(
                math.isfinite(v) for v in trained["losses"]):
            raise AssertionError(f"train_detector on SCWaymoDataset: {trained['losses']}, "
                                 f"{trained['ckpts']}")
        res["train_detector"] = {"losses": trained["losses"], "step_s": trained["steps_s"],
                                 "steps": trained["state"].step}
        parts["train_detector"], t0 = time.time() - t0, time.time()

        # (f) test_detector on each target with its own metric
        targets = {
            "waymo": ("WaymoDataset", root["waymo"], runs["waymo_gt"]["infos"], ["Vehicle"],
                      "waymo", ("x", "y", "z", "intensity")),
            "nuscenes": ("SCNuScenesDataset", root["nuscenes"], runs["nuscenes_det"]["infos"],
                         ["car"], "nuscenes", ("x", "y", "z")),
            "baraja": ("SCCustomDataset", root["baraja"], runs["baraja_det"]["infos"], ["Car"],
                       "kitti", ("x", "y", "z")),
            "lyft": ("LyftDataset", os.path.join(root["lyft"], "trainval"),
                     os.path.join(root["lyft"], "trainval", "lyft_infos_train.pkl"), ["car"],
                     "lyft", ("x", "y", "z", "intensity"))}
        res["test_detector"], test_s = {}, {}
        captured = []
        waymo_evaluation = GEN.WaymoDataset.evaluation

        def recording(self, det_annos, class_names, device="cuda", **kw):
            captured.append(det_annos)
            return waymo_evaluation(self, det_annos, class_names, device=device, **kw)

        for key, (name, data_root, info, classes, metric, src) in targets.items():
            t_run = time.time()
            tar = domain_data_cfg(name, data_root, os.path.relpath(info, data_root), src=src,
                                  CLASS_NAMES=classes, **({"EVAL_METRIC": metric}
                                                          if metric != "kitti" else {}))
            tar_yaml = write_yaml(os.path.join(base, f"second_iou_tar_{key}.yaml"), {
                **plain_tree(named(det_cfg, classes)), "DATA_CONFIG_TAR": plain_tree(tar)})
            GEN.WaymoDataset.evaluation = recording
            try:
                report, ap, recall = TD.main(["--cfg_file", tar_yaml, "--ckpt",
                                              trained["ckpts"][-1], "--batch_size", "4"] + on)
            finally:
                GEN.WaymoDataset.evaluation = waymo_evaluation
            test_s[key] = time.time() - t_run
            flat = flat_keys(ap)
            keys = {k for k in flat if "/aos/" not in k}      # AOS with the boxes' alphas
            if report is None or keys != metric_keys(metric, classes) or not all(
                    math.isfinite(v) for v in flat.values()) or recall["num_gt"] != n_gt:
                raise AssertionError(f"test_detector on {key}: keys {sorted(flat)}, recall "
                                     f"{recall}")
            res["test_detector"][key] = {"metric": metric, "ap": flat, "recall": recall}
            if key == "waymo":
                # the same predictions scored with the IoU on the CPU
                ds = GEN.WaymoDataset(tar, classes, False)
                cpu = ds.evaluation(captured[-1], classes, device="cpu")[1]
                gt_annos, det = ds._metric_annos(captured[-1], classes)
                near = {str(d): WE.near_threshold_pairs(det, gt_annos, classes, device=d)
                        for d in (dev, "cpu")}
                res["test_detector"][key].update(cpu_ap=cpu, near_threshold=near,
                                                 detections=sum(len(d["name"]) for d in det))
                if cpu != ap:
                    raise AssertionError(f"Waymo AP / APH with the IoU on the card {ap} and on "
                                         f"the CPU {cpu}; pairs within 1e-6 of a threshold "
                                         f"{near}")
        parts["test_detector"] = time.time() - t0
    res["test_s"] = test_s
    res["part_s"], res["phase_s"] = parts, time.time() - t_phase
    print("phase 21 run_see by dataset and path: " + "; ".join(
        f"{run} {r['s']:.2f} s ({', '.join(f'{v['s']:.3f}' for v in r['frames'].values())} s "
        f"a frame; isolated {[v['isolated'] for v in r['frames'].values()]}, merged "
        f"{[v['merged'] for v in r['frames'].values()]}, completed "
        f"{[v['completed'] for v in r['frames'].values()]}, scan points dropped "
        f"{[v['dropped'] for v in r['frames'].values()]}; K1 {res['domain_see_launches'][run]})"
        for run, r in res["run_see"].items()) + f" on {card}")
    print("phase 21 card vs CPU, one DET frame each: " + "; ".join(
        f"{k}: {r['instances']} instances, points apart <= {r['iso_apart_max']}, share on a "
        f"car {r['isolated_in_car']:.4f}, {r['completed_rows']} / {r['completed_rows_card']} "
        f"completed rows CPU / card (share past {SEE_ROW_TOL} m {r['rows_apart_share']:.6f}; "
        f"the CPU's f64 witness {r['completed_rows_f64']} rows, share "
        f"{r['rows_apart_share_f64']:.6f}; the card's f64 {r['completed_rows_card_f64']}), "
        f"kept points apart {r['kept_apart']} (ties {r['ties']})"
        for k, r in res["card_vs_cpu"].items()))
    td = res["test_detector"]
    print(f"phase 21 train_detector (flagship SECOND-IoU on SCWaymoDataset, batch 4): losses "
          f"{res['train_detector']['losses']}, step s {res['train_detector']['step_s']}; "
          "test_detector: " + "; ".join(
              f"{k} ({r['metric']}) {test_s[k]:.2f} s, recall {r['recall']}, "
              f"{', '.join(f'{m} {v:.4f}' for m, v in sorted(r['ap'].items())[:4])}"
              for k, r in td.items())
          + f"; Waymo AP/APH equal with the IoU on the card and the CPU over "
          f"{td['waymo']['detections']} detections, pairs within 1e-6 of a threshold "
          f"{td['waymo']['near_threshold']}")
    print("phase 21 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return res


#: phase 22's sizes: generate_masks' images a route, the pairs of the paired
#: BEV IoU, the beams of the two DA frames
DEMO_MASK_IMAGES, IOU_PAIRS, DA_BEAMS = 2, 4096, (64, 16)
#: the bf16 tolerances of tests/test_torch_bev_bf16.py: elementwise, and the
#: share of bf16's own distance from f32 within which an output must lie
BF16_ATOL, BF16_RTOL, NOISE_SHARE = 2e-3, 1e-3, 0.75


def _phase_ms(dev, fn, reps: int = 3) -> float:
    """Median ms of ``fn()``: CUDA events on the card, the host clock on the
    CPU (a dry run of phase 22 here)."""
    if dev.type == "cuda":
        return time_cuda(fn, reps=reps, warmup=1)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def check_jpeg_fixtures(dev) -> dict:
    """Phase 22 (a): every committed JPEG fixture, one of each mode the
    decoder reads (``fixtures.json``'s ``mode``: baseline, gray, 4:1:1,
    progressive, progressive behind an EXIF thumbnail, arithmetic, CMYK,
    lossless), decoded on this host against the sha256 of the array cv2
    read where it was written. The 900 x 1600 decodes of JPEG_TIMED timed
    (host clock, median of 5 after one warm-up)."""
    import hashlib

    from seevcn_torch.data import jpeg as JPG

    t0 = time.time()
    JPG.build()
    build_s = time.time() - t0
    with open(os.path.join(JPEG_FIXTURES, "fixtures.json")) as f:
        table = json.load(f)
    matched = {}
    for name, rec in sorted(table.items()):
        arr = JPG.read_jpeg(os.path.join(JPEG_FIXTURES, name))
        if list(arr.shape) != rec["shape"] or \
                hashlib.sha256(arr.tobytes()).hexdigest() != rec["sha256"]:
            raise AssertionError(f"{name} ({rec['mode']}): the decode is not cv2's array")
        matched[name] = rec["mode"]
    ms = {}
    for mode, name in JPEG_TIMED.items():
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            blob = f.read()
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            JPG.decode_jpeg(blob)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[mode] = statistics.median(times[1:])
    return {"build_s": build_s, "matched": matched, "modes": sorted(set(matched.values())),
            "ms_900x1600": ms,
            "mp_per_s": {k: 900 * 1600 / 1e6 / (v / 1e3) for k, v in ms.items()}}


def masks_jpeg_vs_png(dev, base: str) -> dict:
    """Phase 22 (b): generate_masks with the seeded Mask R-CNN (as phase 20)
    on DEMO_MASK_IMAGES copies of the 900 x 1600 fixture, once as JPEGs and
    once as PNGs of the same pixels (a warm-up image first): images/s of
    each route and the detections of each, which must agree in number. Two
    images a route are a liveness check, not a rate: the model's time swamps
    the read and swings run to run. What the routes differ in, the read
    (``data/image.read_image_bgr``) of one image, is timed alone on the host
    clock (median of 7 after a first read)."""
    from seevcn_torch.cli import generate_masks as GM
    from seevcn_torch.data.image import read_image_bgr
    from seevcn_torch.data.jpeg import read_jpeg
    from seevcn_torch.data.png import write_png

    fixture = os.path.join(JPEG_FIXTURES, "nuscenes_900x1600_420.jpg")
    rgb = np.ascontiguousarray(read_jpeg(fixture)[..., ::-1])
    dirs = {k: os.path.join(base, f"images_{k}") for k in ("warm", "jpg", "png")}
    for k, d in dirs.items():
        os.makedirs(d)
        for i in range(1 if k == "warm" else DEMO_MASK_IMAGES):
            if k == "png":
                write_png(os.path.join(d, f"{i:06d}.png"), rgb)
            else:
                shutil.copyfile(fixture, os.path.join(d, f"{i:06d}.jpg"))
    read_ms = {}
    for k, ext in (("jpg", "jpg"), ("png", "png")):
        path = os.path.join(dirs[k], f"000000.{ext}")
        if not np.array_equal(read_image_bgr(path), rgb[..., ::-1]):
            raise AssertionError(f"the {k} route reads other pixels")
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            read_image_bgr(path)
            times.append((time.perf_counter() - t0) * 1e3)
        read_ms[k] = statistics.median(times)
    seg_cfg = SM.Seg2DConfig(image_size=IMAGE_SIZE)
    ckpt = os.path.join(base, "seg2d.ckpt")
    save_seg2d_checkpoint(ckpt, init_seg2d(SM.MaskRCNN(seg_cfg),
                                           torch.Generator().manual_seed(0)), seg_cfg)
    out = {}
    for k, d in dirs.items():
        r = GM.main(["--image_dir", d, "--out", os.path.join(base, f"masks_{k}.json"),
                     "--backend", f"jax:{ckpt}", "--score_thresh", str(MASK_SCORE_THRESH),
                     "--device", dev.type])
        out[k] = {"images": r["images"], "detections": r["detections"], "s": r["s"],
                  "images_per_s": r["images"] / r["s"]}
    if out["jpg"]["detections"] != out["png"]["detections"] or out["jpg"]["images"] != \
            DEMO_MASK_IMAGES:
        raise AssertionError(f"generate_masks: JPEG route {out['jpg']}, PNG route {out['png']}")
    out["read_ms"] = read_ms
    return out


def demo_cli(dev, base: str) -> dict:
    """Phase 22 (c): the demo end to end (``cli/demo.py``) on a demo tree
    (``write_demo_tree``) with VCN_VC and SECOND-IoU ``.pth`` files from
    seeded weights: a first run, a timed run, then a run with the launch
    counts set to 0 just before it, inside ``profiling.trace()`` (its spans
    and K1's kernel read from the trace file); the PNG read back; the same
    demo's SEE on the CPU held to phase 20's row bounds."""
    from seevcn_torch.cli import demo as DEMO
    from seevcn_torch.data.png import read_png
    from seevcn_torch.geom.pcd_io import read_pcd
    from seevcn_torch.utils.ckpt import save_detector_checkpoint
    from seevcn_torch.utils.profiling import trace

    write_demo_tree(base, n_points=DEMO_POINTS, n_cars=DEMO_CARS)
    torch.save({"base_model": seeded_vcn_state_dict(0)}, os.path.join(base, "vcn.pth"))
    cpu_det, _ = build_detector(DC.mini_detector_cfg(), device="cpu")
    save_detector_checkpoint(os.path.join(base, "det.pth"),
                             seeded_state_dict(0, cpu_det, random_stats=True))
    see_args = ["--root", base, "--masks", f"front={os.path.join(base, 'masks', 'front.json')}",
                "--vcn_ckpt", os.path.join(base, "vcn.pth")]
    args = see_args + ["--det_ckpt", os.path.join(base, "det.pth"), "--device", dev.type]
    res, runs = {}, []
    for i in range(2):
        t0 = time.time()
        timed = DEMO.main(args + ["--out", os.path.join(base, f"out{i}")])
        _sync(dev)
        runs.append(time.time() - t0)
    tdir = os.path.join(base, "trace")
    K.reset_launches()
    t0 = time.time()
    with trace(tdir):
        got = DEMO.main(args + ["--out", os.path.join(base, "out_traced")])
        _sync(dev)
    traced_s = time.time() - t0
    launches = dict(K.LAUNCHES)
    with open(glob_one(os.path.join(tdir, "trace_*.json"))) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    spans = sorted(n for n in names if n.startswith("demo/"))
    if spans != ["demo/detector", "demo/plots", "demo/see"]:
        raise AssertionError(f"the demo's trace holds the spans {spans}")
    if dev.type == "cuda" and launches["min_sqdist_pruned"] < 1:
        raise AssertionError("kernel K1 was not launched by the demo")
    if got["rows_cut"]:
        raise AssertionError(f"the demo's detector pad cut {got['rows_cut']} rows")
    png = read_png(got["png"])
    boxes, scores = got["boxes"], got["scores"]
    if png.shape != (1500, 1500, 3) or not np.isfinite(boxes).all() or len(boxes) < 1 \
            or not (scores > 0.3).all() or got["completed_pts"] is None:
        raise AssertionError(f"the demo: png {png.shape}, {len(boxes)} detections")
    res["exif_front"] = demo_on_exif_front(dev, base, args, got, timed)
    res.update(instances=got["instances"], completed_rows=len(got["completed_pts"]),
               dropped=got["dropped"], detections=len(boxes), rows_cut=got["rows_cut"],
               frame_rows=len(got["frame_points"]), first_s=runs[0], s=runs[1],
               traced_s=traced_s, demo_launches=launches["min_sqdist_pruned"], spans=spans,
               trace_kernels=len(kernels),
               k1_in_trace=sorted(n[:40] for n in kernels if "k1_" in n), png=list(png.shape))
    # the same demo's SEE on the CPU, against the card's frame
    cpu = DEMO.main(see_args + ["--device", "cpu", "--out", os.path.join(base, "out_cpu")])
    n_d, n_c = len(got["completed_pts"]), len(cpu["completed_pts"])
    apart = rows_apart(got["completed_pts"], cpu["completed_pts"], dev)
    share = float((apart > SEE_ROW_TOL).mean())
    points = read_pcd(os.path.join(base, "pcd", "000000.pcd"))
    kept_d, kept_c = ({tuple(r) for r in f[n:]} for f, n in (
        (got["frame_points"], n_d), (cpu["frame_points"], n_c)))
    d = MD.min_sqdist_plain(torch.from_numpy(points[:, :3].copy()),
                            torch.from_numpy(cpu["completed_pts"]))
    tie = ((d - RADIUS * RADIUS).abs() <= 1e-5 * RADIUS * RADIUS).numpy()
    stray = len((kept_d ^ kept_c) - {tuple(r) for r in points[tie, :3]})
    res["card_vs_cpu"] = {"instances": [got["instances"], cpu["instances"]],
                          "completed_rows": [n_d, n_c], "rows_apart_share": share,
                          "kept_apart": stray}
    if got["instances"] != cpu["instances"] or abs(n_d - n_c) > SEE_ROW_SLACK \
            or share > SEE_ROW_SHARE or stray > 2 * SEE_ROW_SLACK:
        raise AssertionError(f"the demo's frame on the card off the CPU's: {res['card_vs_cpu']}")
    return res


#: the demo's outputs the front image cannot move: its SEE pass and the
#: detector's input (exact), then the detector's boxes and scores, which
#: two runs on the same input leave apart in their last bits on the card
#: (its atomics): held at tests/test_torch_demo.py's f32 tolerance
DEMO_EXACT = ("instances", "dropped", "rows_cut", "completed_pts", "frame_points")
DEMO_BOX_TOL, DEMO_SCORE_TOL = 1e-4, 1e-5


def demo_apart(a: dict, b: dict) -> dict:
    """The exact outputs that differ, and the largest |difference| of the
    boxes and of the scores (inf where their counts differ)."""
    out = {"exact": [k for k in DEMO_EXACT
                     if not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))]}
    for k in ("boxes", "scores"):
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        out[k] = float(np.abs(x - y).max(initial=0.0)) if x.shape == y.shape else float("inf")
    return out


def demo_on_exif_front(dev, base: str, args: list, traced: dict, timed: dict) -> dict:
    """Phase 22 (c'): the demo once more, its front image swapped for the
    progressive copy with an EXIF thumbnail (DEMO_JPEG_EXIF), the launch
    counts set to 0 just before. Its shape must be the frame's (720, 1260),
    where kitti/bootstrap's byte scan finds the thumbnail's; K1 launches
    once; the demo reads the image's shape only, so its SEE output and the
    detector's input equal the baseline front image's traced run value for
    value, and the boxes and scores match them at DEMO_BOX_TOL and
    DEMO_SCORE_TOL (the two baseline runs' own spread printed beside)."""
    from seevcn_torch.cli import demo as DEMO
    from seevcn_torch.data.demo_dataset import DemoObjects
    from seevcn_torch.data.kitti.bootstrap import read_image_shape

    front = os.path.join(base, "image", "front", "000000.jpg")
    shutil.copyfile(DEMO_JPEG_EXIF, front)
    shape = DemoObjects(base).get_image_shape(0)
    scanned = [int(v) for v in read_image_shape(front)]
    K.reset_launches()
    t0 = time.time()
    got = DEMO.main(args + ["--out", os.path.join(base, "out_exif")])
    _sync(dev)
    s = time.time() - t0
    launches = K.LAUNCHES["min_sqdist_pruned"]
    shutil.copyfile(DEMO_JPEG, front)
    apart = demo_apart(got, traced)
    out = {"shape": list(shape), "byte_scan_shape": scanned, "k1_launches": launches, "s": s,
           "apart": apart, "baseline_runs_apart": demo_apart(timed, traced)}
    if shape != DEMO_IMAGE or (dev.type == "cuda" and launches != 1) or apart["exact"] \
            or apart["boxes"] > DEMO_BOX_TOL or apart["scores"] > DEMO_SCORE_TOL:
        raise AssertionError(f"the demo on the EXIF front image: {out}")
    return out


def glob_one(pattern: str) -> str:
    import glob

    found = glob.glob(pattern)
    if len(found) != 1:
        raise AssertionError(f"{pattern}: {len(found)} files")
    return found[0]


@torch.no_grad()
def hold_bev_bf16(det, det_cfg, det16, cfg16, bev) -> dict:
    """The flagship's bf16 BEV stage (``bev_head``: the BEV backbone and the
    dense head) on the card against the same stage on the CPU, all fed the
    card's BEV map ``bev``; each of its outputs (the BEV features and the
    head's raw pre-NMS class, box and direction logits) held two ways, by
    the two bf16 tolerances of tests/test_torch_bev_bf16.py:
    - elementwise, atol BF16_ATOL, rtol BF16_RTOL;
    - within the bf16 noise: mean |card - CPU| at most NOISE_SHARE of the
      mean |difference| of the CPU's bf16 stage from its f32 one.
    The first alone cannot tell bf16 from f32 where the outputs are small
    (the seeded flagship's are about 1e-3), so the card's f32 stage
    (``det``) must fail the second: an f32 fallback cannot pass. The
    decoded boxes take the direction bins' argmax, which a tie of the held
    direction logits may turn: those are counted. -> per output the max
    |card - CPU|, its mean over the noise's, and the same for the card's f32
    stage; the direction bins that differ; the CPU stages' seconds."""
    cpu = torch.device("cpu")
    models = {name: build_detector(c, {k: v.cpu() for k, v in m.state_dict().items()},
                                   device=cpu)[0]
              for name, m, c in (("bf16", det16, cfg16), ("f32", det, det_cfg))}
    t0 = time.time()
    ref, ref32 = (models[n].bev_head(bev.cpu()) for n in ("bf16", "f32"))
    cpu_s = time.time() - t0
    got, f32 = det16.bev_head(bev), det.bev_head(bev)

    def parts(o):
        return {"bev2d": o[0], **{k: o[1][k] for k in ("cls_preds", "box_preds",
                                                        "dir_cls_preds") if k in o[1]}}

    ref_p, ref32_p, got_p, f32_p = (parts(o) for o in (ref, ref32, got, f32))
    out, bad = {"cpu_s": cpu_s}, []
    for k, r in ref_p.items():
        r = r.float()
        noise = (ref32_p[k].float() - r).abs().mean().item()
        d16, d32 = ((x[k].float().cpu() - r).abs() for x in (got_p, f32_p))
        out[k] = {"max_abs": d16.max().item(), "share": d16.mean().item() / noise,
                  "f32_max_abs": d32.max().item(), "f32_share": d32.mean().item() / noise}
        if (d16 > BF16_ATOL + BF16_RTOL * r.abs()).any() or out[k]["share"] > NOISE_SHARE:
            bad.append(k)
        if out[k]["f32_share"] <= NOISE_SHARE:
            bad.append(f"{k} (f32)")
    if "dir_cls_preds" in ref_p:
        nb = det16.cfg.head_logic.num_dir_bins
        out["direction_flips"] = int((ref_p["dir_cls_preds"].reshape(-1, nb).argmax(-1) !=
                                      got_p["dir_cls_preds"].reshape(-1, nb).cpu().argmax(-1)).sum())
    if bad:
        raise AssertionError(f"flagship bf16 BEV stage, card vs CPU, fails on {bad}: {out}")
    return out


def bev_bf16(dev, new_pts, new_valid, det, det_cfg, g_pts, g_valid, g_gt) -> dict:
    """Phase 22 (d): BACKBONE_2D.DTYPE bfloat16. The tiny SECOND-IoU card vs
    CPU (pre-NMS outputs at the CPU test's bf16 tolerance); the flagship with
    the f32 detector's weights on the SEE frame's output: its BEV stage card
    vs CPU on the card's BEV map (``hold_bev_bf16``), detect_stage and
    the BEV backbone alone beside the f32 run's (CUDA events, median of 3),
    one finite train step; the 256 -> 128 3x3 conv at 200 x 176 alone in
    bf16 and f32."""
    cpu = torch.device("cpu")
    tiny = DC.tiny_detector_cfg()
    tiny.MODEL.BACKBONE_2D["DTYPE"] = "bfloat16"
    sd = seeded_state_dict(2, build_detector(tiny, device=cpu)[0], random_stats=True)
    pts, valid = blob_points(3)
    outs = {}
    for w in (dev, cpu):
        m, _ = build_detector(tiny, sd, device=w)
        outs[w] = F.detect_stage(m, tiny, torch.from_numpy(pts), torch.from_numpy(valid),
                                 device=w)[1]
    tiny_err = {}
    for k in ("batch_cls_preds", "batch_box_preds"):
        got, ref = outs[dev][k].cpu(), outs[cpu][k]
        tiny_err[k] = (got - ref).abs().max().item()
        if not ((got - ref).abs() <= BF16_ATOL + BF16_RTOL * ref.abs()).all():
            raise AssertionError(f"tiny bf16 BEV: {k} off the CPU by {tiny_err[k]}")
    cfg16 = copy.deepcopy(det_cfg)
    cfg16.MODEL.BACKBONE_2D["DTYPE"] = "bfloat16"
    det16, _ = build_detector(cfg16, det.state_dict(), device=dev)
    pp16, out16 = F.detect_stage(det16, cfg16, new_pts, new_valid, device=dev)
    for k in ("batch_cls_preds", "batch_box_preds", "rcnn_iou"):
        if not torch.isfinite(out16[k]).all():
            raise AssertionError(f"bf16 BEV detector output {k} is not finite")
    kept16 = int(pp16["pred_mask"].sum())
    seen = {}
    hook = det.backbone_2d.register_forward_pre_hook(
        lambda mod, a: seen.setdefault("bev", a[0].detach()))
    _, out32 = F.detect_stage(det, det_cfg, new_pts, new_valid, device=dev)
    hook.remove()
    bev = seen["bev"]
    hold = hold_bev_bf16(det, det_cfg, det16, cfg16, bev)
    bev_gap = ((out16["spatial_features_2d"] - out32["spatial_features_2d"]).abs().max()
               / out32["spatial_features_2d"].abs().max()).item()
    with torch.no_grad():
        ms = {"detect_stage_bf16": _phase_ms(dev, lambda: F.detect_stage(
                  det16, cfg16, new_pts, new_valid, device=dev)),
              "detect_stage_f32": _phase_ms(dev, lambda: F.detect_stage(
                  det, det_cfg, new_pts, new_valid, device=dev)),
              "bev_bf16": _phase_ms(dev, lambda: det16.backbone_2d(bev)),
              "bev_f32": _phase_ms(dev, lambda: det.backbone_2d(bev))}
        top = {k: profile_kernels((m.backbone_2d, bev), lambda bb, x: bb(x))[1][:3]
               for k, m in (("bf16", det16), ("f32", det))} if dev.type == "cuda" else {}
    # one train step at the flagship's train cap, bf16 BEV
    cap = int(det_cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    model, _ = build_detector(cfg16, det.state_dict(), max_voxels=cap, device=dev)
    state = create_train_state(model, cfg16.OPTIMIZATION, total_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()
    loss, _, _ = train_forward(state, g_pts, g_valid, g_gt, gen)
    apply_gradients(state, loss)
    _sync(dev)
    step_s = time.time() - t0
    if not torch.isfinite(loss) or any(not torch.isfinite(p.grad).all()
                                       for p in model.parameters() if p.grad is not None):
        raise AssertionError("the bf16 BEV train step is not finite")
    # the conv shape cuDNN runs slowly in f32, alone
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, 256, 200, 176, generator=g, device=dev)
    wt = torch.randn(128, 256, 3, 3, generator=g, device=dev) * 0.02
    conv = {"f32": _phase_ms(dev, lambda: torch.nn.functional.conv2d(x, wt, padding=1), 5),
            "bf16": _phase_ms(dev, lambda: torch.nn.functional.conv2d(
                x.bfloat16(), wt.bfloat16(), padding=1), 5)}
    flops = 2 * 128 * 256 * 9 * 200 * 176
    return {"tiny_vs_cpu": tiny_err, "hold": hold, "kept": kept16, "bev_gap_vs_f32": bev_gap,
            "ms": ms,
            "bev_top_kernels": top,
            "train_step_s": step_s, "train_loss": loss.item(), "conv_ms": conv,
            "conv_bound_ms": {"bf16": flops / BF16_FLOPS * 1e3, "f32": flops / FP32_FLOPS * 1e3}}


def synth_da_frames(dev, det, det_cfg) -> dict:
    """Phase 22 (e): one spinning-lidar DA frame a beam count of DA_BEAMS
    (``data/synth_da.py``, host numpy): s a frame and its points; the
    flagship detector (f32) on each."""
    from seevcn_torch.data.synth_da import spinning_lidar_frame

    out = {}
    for beams in DA_BEAMS:
        t0 = time.time()
        f = spinning_lidar_frame(np.random.RandomState(beams), n_beams=beams)
        s_ = time.time() - t0
        pp, o = F.detect_stage(det, det_cfg, torch.from_numpy(f["points"]),
                               torch.from_numpy(f["valid"]), device=dev)
        if not torch.isfinite(o["batch_box_preds"]).all() or f["n_pts"] < 1000:
            raise AssertionError(f"the {beams}-beam DA frame: {f['n_pts']} points")
        out[beams] = {"s": s_, "points": int(f["n_pts"]), "cars": len(f["gt_boxes"]),
                      "kept": int(pp["pred_mask"].sum())}
    return out


def iou_pairs(dev) -> dict:
    """Phase 22 (f): ``boxes_iou_bev_aligned_pair`` on IOU_PAIRS jittered
    pairs, card vs CPU."""
    from seevcn_torch.ops.iou3d import boxes_iou_bev_aligned_pair

    rng = np.random.RandomState(22)
    a = np.concatenate([rng.uniform(-40, 40, (IOU_PAIRS, 2)), rng.uniform(-1, 1, (IOU_PAIRS, 1)),
                        rng.uniform(1, 5, (IOU_PAIRS, 3)),
                        rng.uniform(-np.pi, np.pi, (IOU_PAIRS, 1))], 1).astype(np.float32)
    b = (a + rng.uniform(-1, 1, a.shape) * [1, 1, 0.2, 0.3, 0.3, 0.2, 0.5]).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ref = boxes_iou_bev_aligned_pair(ta, tb)
    got = boxes_iou_bev_aligned_pair(ta.to(dev), tb.to(dev)).cpu()
    err = (got - ref).abs().max().item()
    if err > 1e-5 or not (ref > 0).float().mean() > 0.5:
        raise AssertionError(f"paired BEV IoU off the CPU by {err}")
    return {"pairs": IOU_PAIRS, "max_abs_diff": err, "mean_iou": ref.mean().item()}


def demo_jpeg(dev, card, new_pts, new_valid, det, det_cfg, g_pts, g_valid, g_gt) -> dict:
    """Phase 22: the demo and the JPEG inputs, the bf16 BEV backbone, the DA
    frames and the paired BEV IoU (each part's docstring says what it
    holds). Prints one line a part and returns the summary."""
    t_phase = time.time()
    parts, res = {}, {}
    t0 = time.time()
    res["jpeg"] = check_jpeg_fixtures(dev)
    j = res["jpeg"]
    print(f"phase 22 JPEG: {len(j['matched'])} fixtures equal cv2's arrays (sha256), modes "
          f"{', '.join(j['modes'])}; 900x1600 4:2:0 decode (host clock, median of 5): " +
          ", ".join(f"{k} {v:.2f} ms = {j['mp_per_s'][k]:.1f} MP/s"
                    for k, v in j["ms_900x1600"].items()) +
          f"; g++ build {j['build_s']:.1f} s; on the host of {card}")
    parts["jpeg"], t0 = time.time() - t0, time.time()
    with tempfile.TemporaryDirectory(prefix="demo_jpeg_") as base:
        res["generate_masks"] = masks_jpeg_vs_png(dev, os.path.join(base, "masks"))
        g = res["generate_masks"]
        print(f"phase 22 generate_masks (seeded Mask R-CNN, 900x1600, score "
              f">= {MASK_SCORE_THRESH}, {DEMO_MASK_IMAGES} images a route, a liveness "
              f"check): JPEG {g['jpg']['images_per_s']:.3f} images/s, PNG "
              f"{g['png']['images_per_s']:.3f} images/s on the same pixels, detections "
              f"{g['jpg']['detections']} / {g['png']['detections']}; one image read "
              f"(host clock, median of 7): JPEG {g['read_ms']['jpg']:.2f} ms, PNG "
              f"{g['read_ms']['png']:.2f} ms on {card}")
        parts["generate_masks"], t0 = time.time() - t0, time.time()
        res["demo"] = demo_cli(dev, os.path.join(base, "demo"))
        d = res["demo"]
        print(f"phase 22 demo ({DEMO_POINTS} points, {DEMO_CARS} cars, 720x1260 JPEG): "
              f"{d['instances']} instances completed into {d['completed_rows']} rows, "
              f"{d['dropped']} scan points dropped, a frame of {d['frame_rows']} rows "
              f"({d['rows_cut']} cut by the detector's pad), {d['detections']} detections; "
              f"demo_launches (K1) {d['demo_launches']}; first run {d['first_s']:.2f} s, "
              f"then {d['s']:.2f} s, traced {d['traced_s']:.2f} s; spans {d['spans']}, "
              f"{d['trace_kernels']} kernel names in the trace, K1's {d['k1_in_trace']}; PNG "
              f"{d['png']}; card vs CPU "
              f"{d['card_vs_cpu']} on {card}")
        e = d["exif_front"]
        print(f"phase 22 demo on the progressive EXIF-thumbnail front image: shape "
              f"{tuple(e['shape'])} (the byte scan's {tuple(e['byte_scan_shape'])}), K1 "
              f"{e['k1_launches']} launch, {e['s']:.2f} s; against the baseline image's "
              f"traced run: {e['apart']} (the SEE output and detector input exact, boxes "
              f"within {DEMO_BOX_TOL}, scores within {DEMO_SCORE_TOL}; the two baseline runs "
              f"apart: {e['baseline_runs_apart']}) on {card}")
        parts["demo"], t0 = time.time() - t0, time.time()
    res["bev_bf16"] = bev_bf16(dev, new_pts, new_valid, det, det_cfg, g_pts, g_valid, g_gt)
    b = res["bev_bf16"]
    print(f"phase 22 bf16 BEV (flagship SECOND-IoU, BACKBONE_2D.DTYPE bfloat16): "
          f"detect_stage {b['ms']['detect_stage_bf16']:.2f} ms (f32 "
          f"{b['ms']['detect_stage_f32']:.2f}), BEV backbone {b['ms']['bev_bf16']:.2f} ms "
          f"(f32 {b['ms']['bev_f32']:.2f}), {b['kept']} boxes kept, BEV features "
          f"{b['bev_gap_vs_f32']:.3g} of their largest off f32; BEV stage card vs CPU's "
          f"bf16 on the card's BEV map (max |diff|, mean |diff| as a share of the CPU's "
          f"bf16 off its f32, limit {NOISE_SHARE}; the card's bf16 and f32 stages) "
          f"{b['hold']}; BEV kernels by device time "
          f"{b['bev_top_kernels']}; tiny card vs CPU {b['tiny_vs_cpu']}; one train "
          f"step {b['train_step_s']:.2f} s, loss {b['train_loss']:.4f}; conv 256->128 3x3 at "
          f"200x176 alone: bf16 {b['conv_ms']['bf16']:.3f} ms (bound "
          f"{b['conv_bound_ms']['bf16']:.4f}), f32 {b['conv_ms']['f32']:.3f} ms (bound "
          f"{b['conv_bound_ms']['f32']:.4f}) on {card}")
    parts["bev_bf16"], t0 = time.time() - t0, time.time()
    res["synth_da"] = synth_da_frames(dev, det, det_cfg)
    print("phase 22 synth_da: " + "; ".join(
        f"{k} beams {v['s']:.2f} s a frame, {v['points']} points, {v['cars']} cars, "
        f"{v['kept']} boxes kept by the flagship" for k, v in res["synth_da"].items()))
    parts["synth_da"], t0 = time.time() - t0, time.time()
    res["iou_pairs"] = iou_pairs(dev)
    print(f"phase 22 boxes_iou_bev_aligned_pair: {IOU_PAIRS} pairs, card vs CPU max |diff| "
          f"{res['iou_pairs']['max_abs_diff']:.3g}")
    parts["iou_pairs"] = time.time() - t0
    res["part_s"], res["phase_s"] = parts, time.time() - t_phase
    print("phase 22 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return res


# --- phase 23: data parallelism on one card -------------------------------------

#: phase 23's bounds, set from the first readings on the card (PERF.md §5, with
#: the readings that led to them). The train steps are held with the proposals
#: pinned to the world-1 run's (``proposal_pins``): with random weights the
#: RPN's scores nearly tie, so the last rounding of any sum moves proposals in
#: or out of the NMS's 512 (256 of them a rank apart, unpinned) and with them
#: the RoI sample. The world-2 steps are held with the 3D backbone in f32: in
#: the flagship's bf16 a statistic summed in another order moves activations
#: across a bf16 rounding step, about 1e-3 of a loss term. The flagship's own
#: bf16 step, unpinned, is held loosely (bf16_*: read 1.26e-2 of a loss term
#: and 0.062 of the largest gradient), clear of that noise but not of a
#: gradient left unsummed (about half the largest) or a normalizer counted a
#: rank (a term 2x). NCCL at world 1 against --launcher none is the same
#: single-process step (the card's run-to-run rounding). Losses and running
#: statistics relative (the statistics to 1 + their largest); gradients as a
#: share of the largest gradient (``grads_apart``); step 2 starts from
#: weights that Adam's first step may have moved by lr where a gradient is
#: rounding noise, so its loss terms are held looser, as the CPU test holds
#: its second step, and its gradients are printed beside. The merged
#: predictions of the evals match box for box (anno_unmatched: read bit for
#: bit equal). The sharded completion against the 4-frame batch's: the same
#: instances, the rows by ``hold_see_frame_against_cpu``'s measure (nearest
#: row, at SEE_ROW_SHARE; read 1e-4) and at most completion_4f_stray scan
#: points kept apart (read 0 and 2): the VCN's batch of 128 or 64 instances
#: rounds apart in f32, which ``completion_batch_witness`` shows in f64.
DP_TOLS = {"cli_loss": 1e-3, "cli_stats": 1e-3, "cli_ap": 1e-4,
           "step1_loss": 1e-5, "step1_grad": 5e-3, "step2_loss": 1e-2, "stats": 5e-3,
           "bf16_loss": 0.1, "bf16_grad": 0.2, "anno_unmatched": 0.0,
           "completion_4f_stray": 16}
#: the eval's batch a rank: 8 frames at 3 pad a tail at world 1 and at world 2
DP_EVAL_BATCH = 3
#: the tiny detectors' world-2 steps against world 1 on the card, in f64, by
#: the rules of tests/test_torch_parallel.py: loss terms relative, gradients
#: as a share of their tensor's largest, the updated parameters where the
#: gradient is sure (absolute) and everywhere (in lr), the running statistics
#: relative to 1 + their largest
DP_TINY_TOLS = {"loss": 1e-12, "grad": 2e-6, "params_sure": 1e-8, "params_lr": 2.0,
                "buffers": 1e-12}
DP_TINY_RPN = {"second_multihead": DC.tiny_second_multihead_cfg,
               "second_focal": DC.tiny_second_focal_cfg,
               "pointpillar": DC.tiny_pointpillar_cfg,
               "centerpoint": DC.tiny_centerpoint_cfg}
DP_TINY_RCNN = {"pvrcnn": DC.tiny_pvrcnn_cfg, "pvrcnn_plusplus": DC.tiny_pvrcnn_plusplus_cfg,
                "voxel_rcnn": DC.tiny_voxel_rcnn_cfg, "pointrcnn": DC.tiny_pointrcnn_cfg,
                "parta2": DC.tiny_parta2_cfg}
#: the ten detectors other than the flagship, CaDDN in both its forms
DP_TINY_DETECTORS = [*DP_TINY_RPN, *DP_TINY_RCNN, "caddn_image", "caddn_resnet_tiny"]


#: the tiny detectors that shard their BEV map over the mp axis (JAX's
#: constrain_bev callers), and one that runs replicated over it
MP_TINY_DETECTORS = ["second_iou", "second_focal", "second_multihead"]
MP_TINY_REPLICATED = "pointpillar"


def dp_tiny_case(key: str, device: str = "cpu") -> dict:
    """``seevcn_torch.testing.step_case``'s case of a tiny detector on
    ``device``: the step inputs as the tiny-step checks make them
    (check_tiny_*_steps_against_cpu), two frames, the RoI sample and dropout
    left to the step's generator; ``second_iou`` is the tiny SECOND-IoU
    with cars near two of its proposals a frame (``pvrcnn_train_inputs``)."""
    if key == "second_iou":
        cfg = DC.tiny_detector_cfg()
        sd = seeded_state_dict(8, build_detector(cfg, device="cpu")[0], random_stats=True)
        return {"cfg": cfg, "sd": sd, "inputs": (*pvrcnn_train_inputs(cfg, sd), None),
                "extra": {}, "seed": 5, "device": device}
    if key.startswith("caddn"):
        form = key[len("caddn_"):]
        cfg = DC.tiny_caddn_cfg(form)
        images, p2, gt, depth, boxes2d = caddn_tiny_inputs(1)
        inputs = (images, p2, gt, None)
        extra = {"depth_maps": depth, **({"gt_boxes2d": boxes2d} if form == "resnet_tiny"
                                         else {})}
    else:
        cfg = {**DP_TINY_RPN, **DP_TINY_RCNN}[key]()
        extra = {}
    sd = seeded_state_dict(8, build_detector(cfg, device="cpu")[0], random_stats=True)
    if key in DP_TINY_RPN:
        inputs = (*single_stage_train_inputs(), None)
    elif key in DP_TINY_RCNN:
        if key == "pointrcnn":      # box-shaped proposals (check_tiny_point_part_steps_...)
            last = max(int(k.split(".")[2]) for k in sd
                       if k.startswith("point_head.box_layers."))
            for leaf in ("weight", "bias"):
                sd[f"point_head.box_layers.{last}.{leaf}"] *= 0.1
        inputs = (*pvrcnn_train_inputs(cfg, sd, relative=key in ("pointrcnn", "parta2")),
                  None)
    return {"cfg": cfg, "sd": sd, "inputs": inputs, "extra": extra, "seed": 5,
            "device": device}


def hold_tiny_dp_steps(cases: list, ref: list, ranks: list, fails: list,
                       keys=DP_TINY_DETECTORS, label: str = "world 2") -> dict:
    """Each tiny detector's step over the ranks (``ranks``: each rank's
    ``step_case`` results, in the order of ``keys``) against its world-1
    step ``ref`` at DP_TINY_TOLS; every rank's weights and statistics bit
    for bit rank 0's, and a foreground loss term above 0. -> the worst
    readings a detector."""
    out = {}
    for i, key in enumerate(keys):
        r, g = ref[i], ranks[0][i]
        same = all(torch.equal(v, other[i][name][n]) for other in ranks[1:]
                   for name in ("params", "buffers") for n, v in g[name].items())
        loss = max(abs(float(g["terms"][k]) - float(v)) / (abs(float(v)) + 1e-30)
                   for k, v in r["terms"].items())
        scale = {n: t.abs().max().item() + 1e-30 for n, t in r["grads"].items()}
        if BIAS_BEFORE_BN in scale:    # the conv bias that its batch norm cancels: noise
            scale[BIAS_BEFORE_BN] = scale[BIAS_BEFORE_BN.replace("bias", "weight")]
        grad = max((g["grads"][n] - t).abs().max().item() / scale[n]
                   for n, t in r["grads"].items())
        lr = build_lr_schedule(cases[i]["cfg"].OPTIMIZATION, 100)(0)
        sure_off = all_off = 0.0
        for n, t in r["params"].items():
            gr = r["grads"][n].abs()
            sure = (gr >= 0.05 * gr.max()) & (gr >= 1e-6)
            d = (g["params"][n] - t).abs()
            if sure.any():
                sure_off = max(sure_off, d[sure].max().item())
            all_off = max(all_off, d.max().item() / lr)
        bufs = max(((g["buffers"][n] - t).abs().max().item() / (1.0 + t.abs().max().item())
                    for n, t in r["buffers"].items()), default=0.0)
        fg = next(k for k in ("rcnn_loss_reg", "loc_loss", "rpn_loss_loc") if k in r["terms"])
        out[key] = {"loss": loss, "grad": grad, "params_sure": sure_off, "params_lr": all_off,
                    "buffers": bufs, "ranks_bit_equal": same,
                    "terms_equal": set(g["terms"]) == set(r["terms"]),
                    "foreground": float(r["terms"][fg])}
        bad = [k for k, v in DP_TINY_TOLS.items() if out[key][k] > v]
        if bad or not same or not out[key]["terms_equal"] or not out[key]["foreground"] > 0:
            fails.append(f"tiny {key} {label} vs world 1 on the card ({bad}): {out[key]}")
    return out


def proposal_pins(pinned=None, rank: int = 0, world: int = 1):
    """``pinned_calls`` of the detector's ``proposal_layer``: recording, or
    replaying ``pinned`` (a world-1 run's) with this rank's block of rows."""
    def rows(args, kwargs, res):
        n = args[0].shape[0]
        return {k: v[rank * n:(rank + 1) * n] for k, v in res.items()}

    return pinned_calls([(SECOND_MODULE, "proposal_layer", rows)], pinned)


def rois_apart(got: list, ref: list, rank: int = 0) -> int:
    """RoIs of ``got``'s proposal calls (this rank's rows) that no RoI of
    ``ref``'s same rows matches within 1e-3."""
    apart = 0
    for g, r in zip(got, ref):
        n = g["rois"].shape[0]
        for a, b in zip(g["rois"], r["rois"][rank * n:(rank + 1) * n]):
            apart += int(((a[:, None, :7] - b[None, :, :7]).abs().amax(-1) > 1e-3)
                         .all(1).sum())
    return apart


def dp_det_cfg(root: str | None = None, dtype: str | None = None):
    """The flagship SECOND-IoU (its 3D backbone in ``dtype`` where one is
    given), over the KITTI split at ``root`` (no augmentation, batch 4)
    where one is given."""
    cfg = DC.flagship_detector_cfg()
    if dtype is not None:
        cfg.MODEL.BACKBONE_3D.DTYPE = dtype
    if root is not None:
        dc = kitti_cfg(root)
        dc["DATA_PROCESSOR"] = list(dc.DATA_PROCESSOR) + list(cfg.DATA_CONFIG.DATA_PROCESSOR)
        cfg["DATA_CONFIG"] = dc
        cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 4
    return cfg


def flagship_weights(det_cfg) -> dict:
    """The flagship's seeded weights (seed 0)."""
    return seeded_state_dict(0, build_detector(det_cfg, device="cpu")[0])


def dp_flagship_steps(det_cfg, sd, frames, dev, world: int = 1, steps: int = 2,
                      pinned=None, mp: int = 1, exchanges: list | None = None) -> dict:
    """``steps`` flagship SECOND-IoU train steps from ``sd`` on ``frames``
    (points, valid, gt_boxes of the global batch, CPU tensors), the step's
    generator seeded 0 on ``dev``: ``train_step`` at world 1,
    ``shard_train_step`` on this rank's rows in a group of ``world`` over a
    mesh of ``mp`` ranks a dp row; the proposals recorded, or replayed from
    ``pinned`` (``proposal_pins``). -> per step the loss terms (the global
    batch's), the gradients before clipping (summed over the ranks), the ms
    (host clock to a synchronize) and, where ``exchanges`` collects
    ``timed_exchanges``' records, the ms of the step's halo and gather
    exchanges; the parameters and buffers after; the proposals; at world
    2 or more the gradient all-reduce of one step timed alone (ms)."""
    from seevcn_torch.parallel.mesh import make_mesh, shard_batch
    from seevcn_torch.train.train import all_reduce_grads, shard_train_step

    cap = int(det_cfg.DATA_CONFIG.DATA_PROCESSOR[0].MAX_NUMBER_OF_VOXELS["train"])
    model, _ = build_detector(det_cfg, sd, max_voxels=cap, device=dev)
    state = create_train_state(model, det_cfg.OPTIMIZATION, total_steps=1000)
    step, rank, mesh = train_step, 0, None
    if world > 1:
        mesh = make_mesh(device=dev, mp=mp)
        step, rank, world = shard_train_step(model, mesh)[0], mesh.dp_rank, mesh.dp
        frames = shard_batch(mesh, frames)
    pts, valid, gt = (t.to(dev) for t in frames)
    grads = {}
    update = state.optimizer.step

    def recorded(count):
        grads.update({n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})
        update(count)

    state.optimizer.step = recorded
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"steps": []}
    with proposal_pins(pinned, rank, world) as props:
        for _ in range(steps):
            _sync(dev)
            t0 = time.perf_counter()
            terms = step(state, pts, valid, gt, gen)
            _sync(dev)
            out["steps"].append({"ms": (time.perf_counter() - t0) * 1e3, "grads": dict(grads),
                                 "terms": {k: float(v) for k, v in terms.items()}})
            if exchanges is not None:
                out["steps"][-1]["exchange_ms"] = exchange_ms(exchanges)
    out["proposals"] = props
    out["params"] = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
    out["buffers"] = {n: b.detach().cpu() for n, b in model.named_buffers()
                      if not n.endswith("num_batches_tracked")}
    if mesh is not None:
        _sync(dev)
        t0 = time.perf_counter()
        all_reduce_grads(state.optimizer.params)
        _sync(dev)
        out["all_reduce_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def dp_eval(det_cfg, sd, dev, batch: int) -> dict:
    """``eval_one_epoch`` of the detector at ``sd`` over ``det_cfg``'s KITTI
    split at ``batch`` frames a rank (the group's ranks, or one): -> AP
    report, AP dict, recall counts, log lines, s."""
    from seevcn_torch.data.kitti.dataset import KittiDataset
    from seevcn_torch.train.eval import eval_one_epoch

    model, _ = build_detector(det_cfg, sd, device=dev)
    val = KittiDataset(det_cfg.DATA_CONFIG, ["Car"], False, max_points=40_000, max_boxes=64)
    logs = []
    t0 = time.time()
    with recorded_annos() as annos:
        report, ap, recall = eval_one_epoch(model.eval(), det_cfg, val, batch_size=batch,
                                            logger=logs.append)
    return {"report": report, "ap": ap, "recall": recall, "logs": logs, "annos": annos[0],
            "s": time.time() - t0}


@contextlib.contextmanager
def recorded_annos():
    """Every prediction list handed to ``KittiDataset.evaluation`` while
    open (each anno's frame_id, name, score, boxes_lidar), in order."""
    from seevcn_torch.data.kitti.dataset import KittiDataset

    seen, evaluation = [], KittiDataset.evaluation

    def recording(self, det_annos, *args, **kw):
        seen.append([{k: a[k] for k in ("frame_id", "name", "score", "boxes_lidar")}
                     for a in det_annos])
        return evaluation(self, det_annos, *args, **kw)

    KittiDataset.evaluation = recording
    try:
        yield seen
    finally:
        KittiDataset.evaluation = evaluation


def annos_apart(got: list, ref: list) -> dict:
    """Two merged prediction lists of one split: whether their frames come
    in the same order, the boxes both hold, and those of either that no box
    of the other's same frame matches (its name, the score within 1e-5, the
    box within 1e-4), with the largest |score - score| and |box - box| of
    the matched pairs."""
    boxes = unmatched = 0
    score_off = box_off = 0.0
    for g, r in zip(got, ref):
        for a, b in ((g, r), (r, g)):
            boxes += len(a["score"])
            if not len(a["score"]):
                continue
            if not len(b["score"]):
                unmatched += len(a["score"])
                continue
            d_box = np.abs(a["boxes_lidar"][:, None, :7] - b["boxes_lidar"][None, :, :7]).max(-1)
            d_score = np.abs(a["score"][:, None] - b["score"][None, :])
            close = (d_box <= 1e-4) & (d_score <= 1e-5) & (a["name"][:, None] == b["name"][None])
            unmatched += int((~close.any(1)).sum())
            if close.any():
                box_off, score_off = max(box_off, float(d_box[close].max())), \
                    max(score_off, float(d_score[close].max()))
    return {"frames_equal": [a["frame_id"] for a in got] == [a["frame_id"] for a in ref],
            "boxes": boxes, "unmatched": unmatched,
            "unmatched_share": unmatched / max(boxes, 1), "box_off": box_off,
            "score_off": score_off}


def hold_annos(got: list, ref: list, fails: list, label: str) -> dict:
    """``annos_apart`` of two merged prediction lists, held: the same frames
    in order, boxes to hold, and at most DP_TOLS["anno_unmatched"] of them
    unmatched."""
    out = annos_apart(got, ref)
    if not out["frames_equal"] or not out["boxes"] \
            or out["unmatched_share"] > DP_TOLS["anno_unmatched"]:
        fails.append(f"{label}: predictions apart {out}")
    return out


def dp_frame_recalls(det_cfg, sd, dev) -> list:
    """Each frame's recall counts alone (``eval_step`` at batch 1)."""
    from seevcn_torch.data.kitti.dataset import KittiDataset
    from seevcn_torch.train.eval import eval_step

    model, _ = build_detector(det_cfg, sd, device=dev)
    val = KittiDataset(det_cfg.DATA_CONFIG, ["Car"], False, max_points=40_000, max_boxes=64)
    out = []
    for i in range(len(val)):
        f = val[i]
        batch = {k: torch.from_numpy(f[k][None]).to(dev)
                 for k in ("points", "points_valid", "gt_boxes", "gt_mask")}
        out.append({k: int(v) for k, v in eval_step(model.eval(), det_cfg, batch)[1].items()})
    return out


def strided_pad_recall(per_frame: list, world: int, batch: int) -> dict:
    """The recall counts of ``eval_one_epoch`` at ``world`` ranks and
    ``batch`` frames a rank, by JAX's rule: rank r takes the frames
    range(r, n, world), each tail batch padded with its last frame, and
    every padded repeat is counted."""
    total = {k: 0 for k in per_frame[0]}
    for r in range(world):
        mine = list(range(r, len(per_frame), world))
        for s in range(0, len(mine), batch):
            idx = mine[s:s + batch]
            idx += [idx[-1]] * (batch - len(idx))
            for i in idx:
                for k in total:
                    total[k] += per_frame[i][k]
    return total


def dp_rank(rank: int, world: int, det_cfg, held_cfg, eval_cfg, frames, gt_frames,
            batch: int, pinned, tiny_cases, device: str = "cuda:0") -> dict:
    """One rank of phase 23 (b), on ``device`` (cuda:0: every rank on the one
    card) over gloo: ``held_cfg``'s steps with the proposals pinned to the
    world-1 run's, one step of ``det_cfg`` without, a step of each tiny
    detector of ``tiny_cases``, the sharded GT completion (K1 counted) and
    the eval at ``eval_cfg`` (``det_cfg``'s model over the KITTI split)."""
    from seevcn_torch.parallel import distributed as PD
    from seevcn_torch.parallel.mesh import make_mesh
    from seevcn_torch.see.sharded import make_sharded_completion
    from seevcn_torch.testing import step_case

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        K.build(K.KERNELS)
    PD.init_distributed("jax", device=dev, backend="gloo")
    try:
        sd = flagship_weights(det_cfg)
        out = {"group": (torch.distributed.get_rank(), torch.distributed.get_world_size(),
                         torch.distributed.get_backend()),
               "train": dp_flagship_steps(held_cfg, sd, frames, dev, world=world,
                                          pinned=pinned),
               "unpinned": dp_flagship_steps(det_cfg, sd, frames, dev, world=world, steps=1)}
        t0 = time.perf_counter()
        out["tiny_steps"] = [step_case(c, world) for c in tiny_cases]
        out["tiny_s"] = time.perf_counter() - t0
        vcn = VCNInference("VCN_VC", seeded_vcn_state_dict(0), device=dev)
        fn = make_sharded_completion(make_mesh(), vcn)
        fn(*gt_frames)                                     # warm-up
        K.reset_launches()
        _sync(dev)
        t0 = time.perf_counter()
        new_pts, new_valid, inst_ok = fn(*gt_frames)
        _sync(dev)
        out["completion"] = {"ms": (time.perf_counter() - t0) * 1e3,
                             "launches": K.LAUNCHES["min_sqdist_pruned"],
                             "new_pts": new_pts.cpu(), "new_valid": new_valid.cpu(),
                             "inst_ok": inst_ok.cpu()}
        out["eval"] = dp_eval(eval_cfg, sd, dev, batch)
    finally:
        PD.destroy_distributed()
    return out


def worst_of(got: dict, ref: dict, scale) -> tuple:
    """(the largest |got - ref| / scale(ref) over the keys, its key)."""
    return max((((got[k] - ref[k]).abs().max().item() if isinstance(ref[k], torch.Tensor)
                 else abs(got[k] - ref[k])) / scale(ref[k]), k) for k in ref)


def grads_apart(got: dict, ref: dict) -> tuple:
    """(the largest |got - ref| of any gradient element as a share of the
    largest |ref| of any, the tensor it is in): a gradient that is rounding
    noise around 0 (a bias whose batch norm downstream cancels it) has no
    scale of its own to be held to."""
    scale = max(r.abs().max().item() for r in ref.values()) + 1e-30
    return worst_of(got, ref, lambda r: scale)


def hold_dp_steps(got: dict, ref: dict, fails: list, label: str) -> dict:
    """The steps of ``got`` against ``ref`` (``dp_flagship_steps``) at
    DP_TOLS (a reading without a bound there is printed only): -> the worst
    readings."""
    rel = lambda r: abs(r) + 1e-30                                     # noqa: E731
    out = {}
    for i, s in enumerate(got["steps"]):
        r = ref["steps"][i]
        out[f"step{i + 1}_loss"] = worst_of(s["terms"], r["terms"], rel)
        out[f"step{i + 1}_grad"] = grads_apart(s["grads"], r["grads"])
    out["stats"] = worst_of(got["buffers"], ref["buffers"], lambda r: 1.0 + r.abs().max().item())
    for k, (v, name) in out.items():
        if k in DP_TOLS and v > DP_TOLS[k]:
            fails.append(f"{label}: {k} {v:.3g} ({name}) past {DP_TOLS[k]}")
    return {k: [v[0], v[1]] for k, v in out.items()}


def completion_apart(got: tuple, ref: tuple, n_scan: int, dev) -> dict:
    """Two GT completions of the same frames (new_pts, new_valid, inst_ok):
    whether the instances are the same; the completed rows' largest
    distance from the same row and the share past SEE_ROW_TOL
    (``rows_apart_*``); the share of the rows of the instances both kept
    farther than SEE_ROW_TOL from the nearest row of the same instance on
    the other side, both ways (``rows_nearest_share``, the measure of
    ``hold_see_frame_against_cpu``); and the scan points kept by one and not
    the other but for points within 1e-5 r^2 of r^2 of ``ref``'s cloud."""
    g_pts, g_valid, g_ok = (t.to(dev) for t in got)
    r_pts, r_valid, r_ok = (t.to(dev) for t in ref)
    apart = (g_pts[:, n_scan:] - r_pts[:, n_scan:]).norm(dim=-1)
    live = g_valid[:, n_scan:] | r_valid[:, n_scan:]
    both = (g_ok & r_ok).flatten()
    inst = lambda p: p[:, n_scan:].reshape(both.shape[0], -1, 3)[both].double()  # noqa: E731
    d = torch.cdist(inst(g_pts), inst(r_pts))
    near = torch.cat([d.amin(2), d.amin(1)])
    stray = 0
    for i in range(g_pts.shape[0]):
        d = MD.min_sqdist_plain(r_pts[i, :n_scan], r_pts[i, n_scan:], r_valid[i, n_scan:])
        tie = (d - RADIUS * RADIUS).abs() <= 1e-5 * RADIUS * RADIUS
        stray += int(((g_valid[i, :n_scan] != r_valid[i, :n_scan]) & ~tie).sum())
    return {"inst_equal": bool(torch.equal(g_ok, r_ok)),
            "rows_apart_max": float(apart.max()),
            "rows_apart_share": float((apart[live] > SEE_ROW_TOL).float().mean())
            if live.any() else 0.0,
            "rows_nearest_share": float((near > SEE_ROW_TOL).float().mean())
            if near.numel() else 0.0, "kept_stray": stray}


def completion_batch_witness(vcn, iso: torch.Tensor, inst_valid: torch.Tensor,
                             completed: torch.Tensor) -> dict:
    """Whether a frame's GT completion depends on the frames batched with
    it. ``iso`` (F, D, n, 3): F frames' isolated instances; ``completed``
    the card's completion of all F in one batch of F D instances (phase 9).
    The VCN and the chain after it (``forward_chain``) are run again at F D
    instances and in two batches of F D / 2 (a rank's), in f32 and in f64:
    -> for each pair, over the ``inst_valid`` instances, the share of
    completed rows farther than SEE_ROW_TOL from the same row and the
    largest such distance (``rows``), and the same for each row's nearest
    row of the same instance on the other side (``nearest``, order
    ignored)."""
    from seevcn_torch.models.vcn.inference import forward_chain

    flat = iso.flatten(0, 1)
    h = flat.shape[0] // 2
    model64 = copy.deepcopy(vcn.model).double()

    def run(model, x):
        return forward_chain(model, x, sel_k=vcn.sel_k, eps=vcn.cluster_eps)[3]

    with torch.no_grad():
        c = {"f32_full": run(vcn.model, flat),
             "f32_half": torch.cat([run(vcn.model, flat[:h]), run(vcn.model, flat[h:])]),
             "f64_full": run(model64, flat.double()),
             "f64_half": torch.cat([run(model64, flat[:h].double()),
                                    run(model64, flat[h:].double())])}
    live = inst_valid.flatten()

    def apart(a, b):
        a, b = a[live].double(), b[live].double()
        rows = (a - b).norm(dim=-1)
        d = torch.cdist(a, b)
        near = torch.cat([d.amin(2), d.amin(1)])
        return {"rows": [float((rows > SEE_ROW_TOL).float().mean()), float(rows.max())],
                "nearest": [float((near > SEE_ROW_TOL).float().mean()), float(near.max())]}

    return {"f32_full_is_phase9": bool(torch.equal(c["f32_full"],
                                                   completed.flatten(0, 1))),
            "f32_full_vs_half": apart(c["f32_full"], c["f32_half"]),
            "f64_full_vs_half": apart(c["f64_full"], c["f64_half"]),
            "f32_vs_f64_full": apart(c["f32_full"], c["f64_full"]),
            "f32_vs_f64_half": apart(c["f32_half"], c["f64_half"])}


def gloo_world2(dev, flag_cfg, det_cfg, frames, gt_frames, completed, fails: list,
                parts: dict) -> dict:
    """Phase 23 (b): two ranks spawned over gloo, both on ``dev``'s card (or
    the CPU, for a dry run), each running ``dp_rank``; the references here:
    ``dp_flagship_steps`` at world 1 on ``frames`` (``flag_cfg`` with its 3D
    backbone in f32, the proposals recorded; ``flag_cfg`` itself, one step
    unpinned), the tiny detectors' world-1 steps, the GT completion of each
    rank's block of ``gt_frames`` in this process, and ``completed`` (the
    4-frame batch's new_pts, new_valid and stats) with
    ``completion_batch_witness`` on its instances, and ``dp_eval`` at world
    1 with ``det_cfg`` (``flag_cfg``'s model over a KITTI split), whose
    predictions the ranks' merged lists must match and whose recall must
    follow JAX's strided-pad rule at either world. A failed check goes into
    ``fails``."""
    from seevcn_torch.see.gt_completion import complete_gt_frames
    from seevcn_torch.testing import spawn_ranks, step_case

    t0, res = time.time(), {}
    sd = flagship_weights(flag_cfg)
    held_cfg = copy.deepcopy(flag_cfg)
    held_cfg.MODEL.BACKBONE_3D.DTYPE = "float32"
    ref = dp_flagship_steps(held_cfg, sd, frames, dev)
    ref_own = dp_flagship_steps(flag_cfg, sd, frames, dev, steps=1)
    key = f"{SECOND_MODULE.__name__}.proposal_layer"
    parts["world1_steps"], t0 = time.time() - t0, time.time()
    device = "cuda:0" if dev.type == "cuda" else "cpu"
    tiny_cases = [dp_tiny_case(k, device) for k in DP_TINY_DETECTORS]
    tiny_ref = [step_case(c) for c in tiny_cases]
    parts["tiny_world1_steps"], t0 = time.time() - t0, time.time()
    ranks = spawn_ranks(dp_rank, 2, flag_cfg, held_cfg, det_cfg, frames, gt_frames,
                        DP_EVAL_BATCH, ref["proposals"], tiny_cases, device, threads=4,
                        timeout=600)
    parts["gloo_world2_spawned"], t0 = time.time() - t0, time.time()
    res["tiny_steps"] = hold_tiny_dp_steps(tiny_cases, tiny_ref, [r["tiny_steps"]
                                                                  for r in ranks], fails)
    res["tiny_s"] = [r["tiny_s"] for r in ranks]
    res["groups"] = [r["group"] for r in ranks]
    same = all(torch.equal(v, ranks[1]["train"][name][k])
               for name in ("params", "buffers") for k, v in ranks[0]["train"][name].items())
    if not same:
        fails.append("world 2: the ranks' weights or statistics differ after the steps")
    res["steps_vs_world1"] = hold_dp_steps(ranks[0]["train"], ref, fails, "world-2 steps")
    res["unpinned_step1"] = {
        "loss": worst_of(ranks[0]["unpinned"]["steps"][0]["terms"],
                         ref_own["steps"][0]["terms"], lambda r: abs(r) + 1e-30),
        "grad": grads_apart(ranks[0]["unpinned"]["steps"][0]["grads"],
                            ref_own["steps"][0]["grads"]),
        "rois_apart": [rois_apart(r["unpinned"]["proposals"][key], ref_own["proposals"][key],
                                  i) for i, r in enumerate(ranks)]}
    if res["unpinned_step1"]["loss"][0] > DP_TOLS["bf16_loss"] \
            or res["unpinned_step1"]["grad"][0] > DP_TOLS["bf16_grad"]:
        fails.append(f"the flagship's bf16 world-2 step, unpinned, vs world 1: "
                     f"{res['unpinned_step1']}")
    res["step_ms"] = {"world1": [s["ms"] for s in ref["steps"]],
                      "world2": [[s["ms"] for s in r["train"]["steps"]] for r in ranks]}
    res["all_reduce_ms"] = [r["train"]["all_reduce_ms"] for r in ranks]
    res["ranks_bit_equal"] = same
    vcn = VCNInference("VCN_VC", seeded_vcn_state_dict(0), device=dev)
    n, n_scan = gt_frames[0].shape[0] // 2, gt_frames[0].shape[1]
    c_pts, c_valid, c_stats = completed
    four = (c_pts, c_valid, c_stats["inst_valid"])
    res["completion"], res["completion_vs_4_frames"] = [], []
    for i, r in enumerate(ranks):
        c = r["completion"]
        got = (c["new_pts"], c["new_valid"], c["inst_ok"])
        block = [t[n * i:n * (i + 1)] for t in gt_frames]
        one = complete_gt_frames(vcn, *block, device=dev)
        held = completion_apart(got, (one[0], one[1], one[2]["inst_valid"]), n_scan, dev)
        held["launches"] = c["launches"]
        res["completion"].append(held)
        vs4 = completion_apart(got, tuple(t[n * i:n * (i + 1)] for t in four), n_scan, dev)
        res["completion_vs_4_frames"].append(vs4)
        if not held["inst_equal"] or held["rows_apart_share"] > SEE_ROW_SHARE \
                or held["kept_stray"] or c["launches"] < n:
            fails.append(f"rank {i}: sharded completion off the one-process completion of "
                         f"its frames: {held}")
        if not vs4["inst_equal"] or vs4["rows_nearest_share"] > SEE_ROW_SHARE \
                or vs4["kept_stray"] > DP_TOLS["completion_4f_stray"]:
            fails.append(f"rank {i}: sharded completion off the 4-frame batch's: {vs4}")
    witness = completion_batch_witness(vcn, c_stats["isolated"], c_stats["inst_valid"],
                                       c_stats["completed"])
    res["completion_batch_witness"] = witness
    if not witness["f32_full_is_phase9"] \
            or witness["f64_full_vs_half"]["rows"][0] > SEE_ROW_SHARE:
        fails.append(f"the GT completion depends on the frames batched with it: {witness}")
    res["completion_ms"] = [r["completion"]["ms"] for r in ranks]
    res["sharded_completion_launches"] = [r["completion"]["launches"] for r in ranks]
    parts["completion_checks"], t0 = time.time() - t0, time.time()
    w1 = dp_eval(det_cfg, sd, dev, DP_EVAL_BATCH)
    per_frame = dp_frame_recalls(det_cfg, sd, dev)
    expect = {w: strided_pad_recall(per_frame, w, DP_EVAL_BATCH) for w in (1, 2)}
    ev = [r["eval"] for r in ranks]
    ap_off = max((abs(e["ap"][c][m][d] - v) for e in ev for c in w1["ap"]
                  for m in w1["ap"][c] for d, v in w1["ap"][c][m].items()), default=0.0)
    res["eval"] = {"ap_off": ap_off, "recall_world1": w1["recall"],
                   "recall_world2": [e["recall"] for e in ev], "expected": expect,
                   "frames": [e["logs"][0] for e in ev], "s": [e["s"] for e in ev],
                   "world1_s": w1["s"],
                   "annos_vs_world1": [hold_annos(e["annos"], w1["annos"], fails,
                                                  f"eval_one_epoch rank {i} vs world 1")
                                       for i, e in enumerate(ev)]}
    if ap_off > DP_TOLS["cli_ap"] or w1["recall"] != expect[1] \
            or any(e["recall"] != expect[2] for e in ev) \
            or set(ev[0]["ap"]) != set(w1["ap"]) or not w1["recall"]["num_gt"]:
        fails.append(f"eval_one_epoch world 2 vs world 1: {res['eval']}")
    parts["eval_checks"] = time.time() - t0
    return res


def data_parallel(dev, card, gt_scenes, g_pts, g_valid, g_gt, g_stats) -> dict:
    """Phase 23: data parallelism on one card. (a) NCCL at world size 1 on
    cuda:0 (the ``jax`` launcher, its coordinator on a free local port):
    all_reduce, all_gather and merge_results_dist on CUDA tensors, then
    train_detector (one epoch, flagship SECOND-IoU, batch 4; the proposals
    pinned to the --launcher none run's) and test_detector with --launcher
    jax against --launcher none on an 8-frame KITTI split. (b) World size 2
    over gloo, both ranks on cuda:0, spawned here (``gloo_world2``). Two
    ranks share one card: their times are liveness numbers, not a
    speed-up. Every failed check is collected and raised at the end."""
    from seevcn_torch.cli import test_detector as TD
    from seevcn_torch.cli import train_detector as TR
    from seevcn_torch.parallel import collectives as COL
    from seevcn_torch.parallel import distributed as PD
    from seevcn_torch.testing import free_port

    t_phase = time.time()
    fails, res, parts = [], {}, {}
    with tempfile.TemporaryDirectory(prefix="dp_kitti_") as root:
        t0 = time.time()
        write_kitti_split(root, KITTI_FRAMES, seed=0, n_points=KITTI_POINTS, n_cars=KITTI_CARS)
        det_cfg = dp_det_cfg(root)
        det_yaml = write_yaml(os.path.join(root, "second_iou_kitti.yaml"), det_cfg)
        parts["split"], t0 = time.time() - t0, time.time()

        # (a) NCCL at world size 1
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"localhost:{free_port()}",
                          JAX_NUM_PROCESSES="1", JAX_PROCESS_ID="0")
        group = PD.init_distributed("jax", device="cuda:0")
        try:
            backend = torch.distributed.get_backend()
            t = torch.arange(4.0, device=dev)
            red = t.clone()
            torch.distributed.all_reduce(red)
            gathered = [torch.empty_like(t)]
            torch.distributed.all_gather(gathered, t)
            objects = [None]
            torch.distributed.all_gather_object(objects, {"frame": 0})
            merged = COL.merge_results_dist([{"frame": 0}, {"frame": 1}], total_size=1)
            avg = COL.average_reduce_value(2.5)
            ok = (group == (0, 1) and backend == "nccl" and torch.equal(red, t)
                  and torch.equal(gathered[0], t) and objects == [{"frame": 0}]
                  and merged == [{"frame": 0}] and avg == 2.5)
        finally:
            PD.destroy_distributed()
        res["nccl_collectives"] = {"group": group, "backend": backend, "ok": ok}
        if not ok:
            fails.append(f"NCCL world 1 collectives: {res['nccl_collectives']}")
        common = ["--cfg_file", det_yaml, "--epochs", "1", "--fix_random_seed",
                  "--max_ckpt_save_num", "1", "--device", "cuda"]
        with proposal_pins() as props:
            none = TR.main(common + ["--output_dir", os.path.join(root, "out_none")])
        os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{free_port()}"
        with proposal_pins(props):
            nccl = TR.main(common + ["--output_dir", os.path.join(root, "out_jax"),
                                     "--launcher", "jax"])
        sd_none, sd_nccl = (r["state"].model.state_dict() for r in (none, nccl))
        lr = build_lr_schedule(det_cfg.OPTIMIZATION, nccl["state"].step)
        lr_sum = sum(lr(k) for k in range(nccl["state"].step))
        params = {n for n, _ in none["state"].model.named_parameters()}
        w_off = max(((sd_nccl[k].float() - v.float()).abs().max().item(), k)
                    for k, v in sd_none.items() if k in params)
        s_off = max(((sd_nccl[k].float() - v.float()).abs().max().item()
                     / (1.0 + v.float().abs().max().item()), k)
                    for k, v in sd_none.items()
                    if k not in params and not k.endswith("num_batches_tracked"))
        loss_off = max(abs(a - b) / abs(b) for a, b in zip(nccl["losses"], none["losses"]))
        saved = torch.load(nccl["ckpts"][-1], weights_only=False)["model_state"]
        file_ok = all(torch.equal(saved[k].cpu(), v.cpu()) for k, v in sd_nccl.items()
                      if k in saved)
        res["train_detector"] = {"losses_none": none["losses"], "losses_nccl": nccl["losses"],
                                 "loss_off": loss_off, "weights_off": list(w_off),
                                 "weights_bound": 2 * lr_sum, "stats_off": list(s_off),
                                 "steps": nccl["state"].step, "file_equal": file_ok}
        if loss_off > DP_TOLS["cli_loss"] or w_off[0] > 2 * lr_sum \
                or s_off[0] > DP_TOLS["cli_stats"] or not file_ok:
            fails.append(f"train_detector --launcher jax (NCCL, world 1) vs none: "
                         f"{res['train_detector']}")
        test = ["--cfg_file", det_yaml, "--ckpt", none["ckpts"][-1], "--batch_size", "4",
                "--device", "cuda"]
        with recorded_annos() as annos:
            t_none = TD.main(test)
            os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{free_port()}"
            t_nccl = TD.main(test + ["--launcher", "jax"])
        ap_off = max(abs(t_nccl[1][c][m][d] - v) for c in t_none[1] for m in t_none[1][c]
                     for d, v in t_none[1][c][m].items()) if t_none[1] else 0.0
        res["test_detector"] = {"ap_off": ap_off, "recall_none": t_none[2],
                                "recall_nccl": t_nccl[2],
                                "annos": hold_annos(annos[1], annos[0], fails,
                                                    "test_detector --launcher jax vs none")}
        if ap_off > DP_TOLS["cli_ap"] or t_nccl[2] != t_none[2] or not t_none[2]["num_gt"]:
            fails.append(f"test_detector --launcher jax (NCCL, world 1) vs none: "
                         f"{res['test_detector']}")
        parts["nccl_world1"], t0 = time.time() - t0, time.time()

        # (b) world size 2 over gloo, both ranks on cuda:0
        frames = tuple(t.cpu() for t in (g_pts, g_valid, g_gt))
        gt_frames = tuple(torch.from_numpy(np.stack([sc[k] for sc in gt_scenes]))
                          for k in ("points", "valid", "gt_boxes"))
        gt_frames += (torch.ones(gt_frames[2].shape[:2], dtype=torch.bool),)
        res.update(gloo_world2(dev, dp_det_cfg(), det_cfg, frames, gt_frames,
                               (g_pts, g_valid, g_stats), fails, parts))
    res["part_s"], res["phase_s"] = parts, time.time() - t_phase
    print(f"phase 23 (a) NCCL world 1 (--launcher jax, cuda:0): collectives "
          f"{res['nccl_collectives']}; train_detector (flagship SECOND-IoU, 8 frames, batch 4, "
          f"one epoch, proposals pinned to --launcher none's) vs --launcher none: "
          f"{res['train_detector']}; test_detector: {res['test_detector']} on {card}")
    print(f"phase 23 (b) gloo world 2, both ranks on cuda:0 (groups {res['groups']}): "
          f"flagship steps (3D backbone f32) vs train_step at 4 frames, proposals pinned "
          f"(worst, bounds {DP_TOLS}) {res['steps_vs_world1']}; ranks bit-equal "
          f"{res['ranks_bit_equal']}; the flagship's bf16 step 1 unpinned (bounds "
          f"bf16_loss, bf16_grad): loss terms "
          f"{res['unpinned_step1']['loss']}, gradients {res['unpinned_step1']['grad']}, RoIs "
          f"apart from world 1's a rank {res['unpinned_step1']['rois_apart']}; step ms (3D "
          f"backbone f32) world 1 "
          f"{res['step_ms']['world1']}, world 2 (2 frames a rank) {res['step_ms']['world2']}, "
          f"gradient all-reduce alone {res['all_reduce_ms']} ms (two ranks sharing one card "
          f"over gloo: liveness, not a speed-up) on {card}")
    print(f"phase 23 (b) the ten other detectors' tiny steps (f64) at world 2 vs world 1 "
          f"on the card (worst, bounds {DP_TINY_TOLS}): {res['tiny_steps']}; "
          f"{res['tiny_s']} s a rank")
    print(f"phase 23 (b) sharded GT completion, 2 frames a rank at VCN_VC's full width, vs "
          f"the one-process completion of the same 2 frames: {res['completion']}; vs the "
          f"4-frame batch of phase 9 (bounds rows_nearest_share SEE_ROW_SHARE "
          f"{SEE_ROW_SHARE}, kept_stray completion_4f_stray): "
          f"{res['completion_vs_4_frames']}; the batch witness (VCN and chain at 128 "
          f"instances and at 2 x 64, f32 and f64; [share past {SEE_ROW_TOL} m, max m]): "
          f"{res['completion_batch_witness']}; ms a rank {res['completion_ms']}; "
          f"eval_one_epoch world 2 vs world 1 (batch {DP_EVAL_BATCH} a rank): {res['eval']}")
    print("phase 23 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    if fails:
        raise AssertionError("phase 23: " + "; ".join(fails))
    return res


# --- phase 24: the mp axis on one card -------------------------------------------

#: phase 24's bounds. ``bev``: the flagship's BEV backbone (training, batch
#: norms over both ranks' slabs) on W slabs against the whole map, the
#: largest |diff| over the largest |output| (f32, TF32 off; read 3.3e-6 at
#: its first run, the slabs' cuDNN convs summing in another order; set at
#: three times that). ``eval_box``:
#: the eval forward's batch_box_preds at mp 2 against unsharded, absolute
#: (JAX's test_train_step_dp_mp_mesh's 1e-3). The train steps are held by
#: DP_TOLS, the tiny ones by DP_TINY_TOLS.
MP_TOLS = {"bev": 1e-5, "eval_box": 1e-3}


@contextlib.contextmanager
def timed_exchanges(records: list):
    """Within the block, each all-reduce of ``parallel.spatial`` is timed into
    ``records`` as (kind, ms): CUDA events on the card (read when
    ``exchange_ms`` sums them), the host clock on the CPU; "halo" for a
    conv's halo exchange (forward or backward), "gather" for a gather of the
    slabs (``gather_w`` forward, ``scatter_w`` backward)."""
    from seevcn_torch.parallel import spatial as S

    real = S._exchange

    def timed(m, buf):
        kind = "gather" if sys._getframe(1).f_code.co_name == "_gather" else "halo"
        if not buf.is_cuda:
            t0 = time.perf_counter()
            out = real(m, buf)
            records.append((kind, lambda dt=(time.perf_counter() - t0) * 1e3: dt))
            return out
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real(m, buf)
        end.record()
        records.append((kind, lambda: start.elapsed_time(end)))
        return out

    S._exchange = timed
    try:
        yield records
    finally:
        S._exchange = real


def exchange_ms(records: list) -> dict:
    """The ms and count of each kind of the ``timed_exchanges`` records,
    which are then cleared."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = {}
    for kind, ms_of in records:
        ms, n = out.get(kind, (0.0, 0))
        out[kind] = (ms + ms_of(), n + 1)
    records.clear()
    return {k: {"ms": ms, "calls": n} for k, (ms, n) in out.items()}


def mp_rank(rank: int, world: int, mp: int, held_cfg, sd: dict, frames, pinned,
            bev, tiny_cases: list, device: str = "cuda:0", t_spawn: float = 0.0) -> dict:
    """One rank of phase 24 on ``device`` (cuda:0: every rank on the one
    card) over gloo, ``mp`` ranks a dp row: two flagship steps of
    ``held_cfg`` (3D backbone f32) with the proposals pinned to the world-1
    run's and the halo and gather exchanges timed, each tiny case's step;
    given the BEV map ``bev``, the BEV backbone (training) on this rank's
    slab and the eval forward under the mesh, with the width that the
    backbone took; the s of each part (``start``: from ``t_spawn``, the
    parent's clock before the spawn, to this function)."""
    from seevcn_torch.parallel import distributed as PD
    from seevcn_torch.parallel.mesh import make_mesh, set_active_mesh
    from seevcn_torch.parallel.spatial import gather_w, scatter_w
    from seevcn_torch.testing import step_case

    t0 = time.time()
    parts = {"start": t0 - t_spawn}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    PD.init_distributed("jax", device=dev, backend="gloo")
    try:
        out = {"group": (torch.distributed.get_rank(), torch.distributed.get_world_size(),
                         torch.distributed.get_backend()), "part_s": parts}
        parts["group"], t0 = time.time() - t0, time.time()
        with timed_exchanges([]) as records:
            out["train"] = dp_flagship_steps(held_cfg, sd, frames, dev, world=world,
                                             pinned=pinned, mp=mp, exchanges=records)
        parts["flagship"], t0 = time.time() - t0, time.time()
        out["tiny_steps"] = [step_case(dict(c, mp=mp), world) for c in tiny_cases]
        parts["tiny"], t0 = time.time() - t0, time.time()
        if bev is not None:
            model, _ = build_detector(held_cfg, sd, device=dev)
            mesh = make_mesh(device=dev, mp=mp)
            bb = copy.deepcopy(model.backbone_2d).train()
            widths = []
            model.backbone_2d.register_forward_pre_hook(
                lambda m, a: widths.append(a[0].shape[2]))
            prev = set_active_mesh(mesh)
            try:
                with torch.no_grad():
                    out["bev_out"] = gather_w(bb(scatter_w(bev.to(dev)), w_slabs=True)).cpu()
                    out["eval_preds"] = model.eval()(frames[0].to(dev), frames[1].to(dev))[
                        "batch_box_preds"].cpu()
            finally:
                set_active_mesh(prev)
            out["bev_w"] = widths
            parts["bev_eval"] = time.time() - t0
    finally:
        PD.destroy_distributed()
    return out


def ranks_apart(ranks: list) -> list:
    """The flagship weights and statistics after the steps that some rank
    holds otherwise than rank 0, bit for bit: (rank, name, largest
    |diff|), at most 5."""
    ref = ranks[0]["train"]
    return [(i, k, (v.float() - r["train"][name][k].float()).abs().max().item())
            for i, r in enumerate(ranks[1:], 1) for name in ("params", "buffers")
            for k, v in ref[name].items() if not torch.equal(v, r["train"][name][k])][:5]


def model_parallel(dev, card, g_pts, g_valid, g_gt) -> dict:
    """Phase 24: the mp axis on one card, ranks spawned over gloo and all on
    cuda:0 (NCCL refuses two ranks on one card). References here, at world
    1: two flagship SECOND-IoU steps (3D backbone f32, the proposals
    recorded) on the first 2 of phase 9's completed frames, its BEV
    backbone (training) on their BEV map and its eval forward, and the
    tiny detectors' steps (f64). (a) World 2, (dp 1, mp 2): the flagship's
    steps with the proposals pinned, its BEV backbone on W slabs, the eval
    forward, and PointPillar's tiny step (replicated over mp). (b) World 4,
    (dp 2, mp 2): the flagship's steps (a frame a dp row) and the tiny
    SECOND-IoU's, focal and multi-head SECONDNet's steps. Holds at MP_TOLS,
    DP_TOLS and DP_TINY_TOLS, every rank bit-equal; every failed check is
    collected and raised at the end. The ranks share one card: their times
    are liveness numbers, not a speed-up."""
    from seevcn_torch.testing import spawn_ranks, step_case

    t_phase = t0 = time.time()
    fails, res, parts = [], {}, {}
    frames = tuple(t[:2].cpu() for t in (g_pts, g_valid, g_gt))
    held_cfg = dp_det_cfg(dtype="float32")
    sd = flagship_weights(held_cfg)
    ref = dp_flagship_steps(held_cfg, sd, frames, dev)
    model, _ = build_detector(held_cfg, sd, device=dev)
    model.eval()
    pts, valid = frames[0].to(dev), frames[1].to(dev)
    with torch.no_grad():
        ref_preds = model(pts, valid)["batch_box_preds"].cpu()
        bev = height_compression(model.voxel_backbone(pts, valid)[1][
            "encoded_spconv_tensor"]).float()
        ref_bev = copy.deepcopy(model.backbone_2d).train()(bev).cpu()
    device = "cuda:0" if dev.type == "cuda" else "cpu"
    replicated = [dp_tiny_case(MP_TINY_REPLICATED, device)]
    sharded = [dp_tiny_case(k, device) for k in MP_TINY_DETECTORS]
    parts["world1_refs"], t0 = time.time() - t0, time.time()
    # the tiny world-1 steps while the ranks of (a) start up
    tiny_ref, errors = [], []

    def tiny_refs():
        try:
            tiny_ref.extend(step_case(c) for c in replicated + sharded)
        except Exception as e:            # raised again below, in this thread
            errors.append(e)

    refs = threading.Thread(target=tiny_refs)
    refs.start()
    a = spawn_ranks(mp_rank, 2, 2, held_cfg, sd, frames, ref["proposals"], bev.cpu(),
                    replicated, device, time.time(), threads=4, timeout=300)
    refs.join()
    if errors:
        raise errors[0]
    parts["world2_mp2_spawned"], t0 = time.time() - t0, time.time()
    b = spawn_ranks(mp_rank, 4, 2, held_cfg, sd, frames, ref["proposals"], None, sharded,
                    device, time.time(), threads=2, timeout=300)
    parts["world4_dp2_mp2_spawned"], t0 = time.time() - t0, time.time()

    bev_off = max((r["bev_out"] - ref_bev).abs().max().item() for r in a) \
        / (ref_bev.abs().max().item() + 1e-30)
    box_off = max((r["eval_preds"] - ref_preds).abs().max().item() for r in a)
    res["a"] = {"groups": [r["group"] for r in a], "bev_w": [r["bev_w"] for r in a],
                "full_w": int(bev.shape[2]), "bev_rel_off": bev_off, "eval_box_off": box_off,
                "steps_vs_world1": hold_dp_steps(a[0]["train"], ref, fails, "mp-2 steps"),
                "ranks_apart": ranks_apart(a),
                "tiny_steps": hold_tiny_dp_steps(replicated, tiny_ref[:1],
                                                 [r["tiny_steps"] for r in a], fails,
                                                 [MP_TINY_REPLICATED], "(dp 1, mp 2)")}
    res["b"] = {"groups": [r["group"] for r in b],
                "steps_vs_world1": hold_dp_steps(b[0]["train"], ref, fails,
                                                 "(dp 2, mp 2) steps"),
                "ranks_apart": ranks_apart(b),
                "tiny_steps": hold_tiny_dp_steps(sharded, tiny_ref[1:],
                                                 [r["tiny_steps"] for r in b], fails,
                                                 MP_TINY_DETECTORS, "(dp 2, mp 2)")}
    if bev_off > MP_TOLS["bev"]:
        fails.append(f"the BEV backbone on W slabs vs the whole map: {bev_off:.3g}")
    if box_off > MP_TOLS["eval_box"]:
        fails.append(f"the eval forward at mp 2 vs unsharded: batch_box_preds {box_off:.3g}")
    if any(w != [bev.shape[2] // 2] for w in res["a"]["bev_w"]):
        fails.append(f"the BEV backbone's widths at mp 2: {res['a']['bev_w']}")
    for label, ranks, r in (("(dp 1, mp 2)", a, res["a"]), ("(dp 2, mp 2)", b, res["b"])):
        if r["ranks_apart"]:
            fails.append(f"{label}: the ranks' weights or statistics differ after the steps: "
                         f"{r['ranks_apart']}")
        if not all(s["exchange_ms"].get("halo", {}).get("calls") for r in ranks
                   for s in r["train"]["steps"]):
            fails.append(f"{label}: a flagship step made no halo exchange")
    res["step_ms"] = {"world1": [s["ms"] for s in ref["steps"]],
                      "dp1_mp2": [[s["ms"] for s in r["train"]["steps"]] for r in a],
                      "dp2_mp2": [[s["ms"] for s in r["train"]["steps"]] for r in b]}
    res["exchange_ms_step2"] = {"dp1_mp2": [r["train"]["steps"][-1]["exchange_ms"] for r in a],
                                "dp2_mp2": [r["train"]["steps"][-1]["exchange_ms"] for r in b]}
    res["all_reduce_ms"] = {"dp1_mp2": [r["train"]["all_reduce_ms"] for r in a],
                            "dp2_mp2": [r["train"]["all_reduce_ms"] for r in b]}
    res["rank_s"] = {"dp1_mp2": [r["part_s"] for r in a], "dp2_mp2": [r["part_s"] for r in b]}
    parts["checks"] = time.time() - t0
    res["part_s"], res["phase_s"] = parts, time.time() - t_phase
    print(f"phase 24 (a) gloo world 2 (dp 1, mp 2), both ranks on cuda:0 (groups "
          f"{res['a']['groups']}): the flagship's BEV backbone (training) on W slabs of "
          f"{res['a']['bev_w']} of {res['a']['full_w']} columns vs the whole map, largest "
          f"|diff| / largest |output| {bev_off:.3g} (bound {MP_TOLS['bev']}); eval "
          f"batch_box_preds vs unsharded {box_off:.3g} (bound {MP_TOLS['eval_box']}); steps "
          f"(3D backbone f32, proposals pinned) vs world 1 (worst, bounds {DP_TOLS}) "
          f"{res['a']['steps_vs_world1']}; tensors apart between ranks "
          f"{res['a']['ranks_apart']}; "
          f"PointPillar's tiny step (replicated over mp, f64): {res['a']['tiny_steps']} "
          f"on {card}")
    print(f"phase 24 (b) gloo world 4 (dp 2, mp 2) on cuda:0: flagship steps vs world 1 "
          f"{res['b']['steps_vs_world1']}; tensors apart between ranks "
          f"{res['b']['ranks_apart']}; "
          f"the tiny sharded detectors' steps (f64, bounds {DP_TINY_TOLS}): "
          f"{res['b']['tiny_steps']} on {card}")
    print(f"phase 24 timings (ranks sharing one card over gloo: liveness, not a speed-up): "
          f"flagship step ms world 1 {res['step_ms']['world1']}, (dp 1, mp 2) "
          f"{res['step_ms']['dp1_mp2']}, (dp 2, mp 2) {res['step_ms']['dp2_mp2']}; step 2's "
          f"halo and gather exchanges (CUDA events, ms and calls a rank) "
          f"{res['exchange_ms_step2']}; the gradient all-reduce alone {res['all_reduce_ms']} "
          f"ms on {card}")
    print(f"phase 24 by rank and part, s: {res['rank_s']}")
    print("phase 24 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    if fails:
        raise AssertionError("phase 24: " + "; ".join(fails))
    return res


# --- phase 25: the repo's own SEE experiments through seevcn_torch.experiments -------

#: phase 25's depth at full width (22,000-point frames, 8 GT slots, azimuth
#: 0.25 deg, VCN at 1,024 points, SECOND-IoU at da_detector_cfg): source
#: train / val frames (64 beams), target val frames (16 beams), the VC data's
#: frames a beam count (3: with 1 a beam count the VC set holds 8 training
#: objects, fewer than one batch of 16), the detector's steps and batch, and
#: the maskpath frames
DA_TRAIN_FRAMES, DA_VAL_FRAMES, DA_TGT_FRAMES, DA_VC_FRAMES = 4, 2, 2, 3
DA_STEPS, DA_BATCH, MASKPATH_FRAMES = 10, 4, 2
#: a completed instance card vs CPU: its unique rows within DA_ROW_ATOL of the
#: other side's but for DA_STRAY_ROWS a side within DA_STRAY_M (a partial-mesh
#: k-NN pick at an f32 near tie; tests/test_torch_da_experiment.py)
DA_ROW_ATOL, DA_STRAY_ROWS, DA_STRAY_M = 5e-5, 2, 0.1
#: the runbook's five evals (scripts/da_run_tpu3.sh:77-81) under the names of
#: da2's table for the source completed by VCN_CN (its see2 rows): name,
#: detector, set
DA_EVALS = (("raw_tgt", "det_raw", "tgt_val"), ("see2_tgt", "det_see", "tgt_val.completed"),
            ("raw_src", "det_raw", "src_val"), ("see2_src", "det_see", "src_val.completed"),
            ("raw_tgtcomp2", "det_raw", "tgt_val.completed"))


def state_reloads(saved: dict, model) -> bool:
    """A state dict read back from a checkpoint equals ``model``'s, key for
    key and bit for bit (the loaders give a batch-norm counter the shape
    (1,), which is compared by value)."""
    live = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return saved.keys() == live.keys() and all(
        torch.equal(v.reshape(live[k].shape), live[k]) for k, v in saved.items())


def hold_da_frame_against_cpu(path: str, vcn_path: str, dev) -> dict:
    """Frame 0 of the set at ``path`` completed by the VCN_CN of ``vcn_path``
    (GT boxes to the VCN) on the card and on the CPU: the same instances
    completed, each instance's rows within DA_ROW_ATOL of the CPU's but
    for DA_STRAY_ROWS a side within DA_STRAY_M (``completed_rows_apart``),
    and the card's replacement equal to the plain full-cloud sweep of its
    own completion (points within 1e-5 r^2 of r^2 excepted)."""
    from seevcn_torch.experiments.da_experiment import load_set

    frame = [torch.from_numpy(x[:1]) for x in load_set(path)]
    sd = load_vcn_checkpoint(vcn_path, "VCN_CN")
    runs = {d.type: complete_gt_frames(VCNInference("VCN_CN", sd, device=d), *frame, device=d,
                                       vcn_boxes=True) for d in (dev, torch.device("cpu"))}
    (pts_d, valid_d, st_d), (_, valid_c, st_c) = runs[dev.type], runs["cpu"]
    if not torch.equal(st_d["inst_valid"].cpu(), st_c["inst_valid"]):
        raise AssertionError("DA frame card vs CPU: other instances completed")
    rows = completed_rows_apart(st_d["completed"].cpu().numpy(), st_c["completed"].numpy(),
                                DA_ROW_ATOL)
    p = frame[0].shape[1]
    flat = st_d["completed"][0].reshape(-1, 3)
    flat_valid = st_d["inst_valid"][0].repeat_interleave(st_d["completed"].shape[2])
    d = MD.min_sqdist_plain(pts_d[0, :p], flat, flat_valid)
    expect = frame[1][0].to(dev) & ~(d <= RADIUS * RADIUS)
    tie = (d - RADIUS * RADIUS).abs() <= 1e-5 * RADIUS * RADIUS
    mismatch = int(((expect != valid_d[0, :p]) & ~tie).sum())
    res = {**rows, "instances": int(st_c["inst_valid"].sum()),
           "kept_apart_cpu": int((valid_d.cpu() != valid_c).sum()),
           "replacement_mismatches": mismatch, "ties": int(tie.sum())}
    if rows["stray_rows_max"] > DA_STRAY_ROWS or rows["rows_apart_max"] > DA_STRAY_M \
            or mismatch or res["instances"] < 1:
        raise AssertionError(f"DA frame card vs CPU: {res}")
    return res


def da_voxels(path: str, cfg, dev) -> dict:
    """Each frame of the completed set at ``path`` voxelized at ``cfg``'s grid
    with no cap: its active voxels, which must stay under the train and test
    caps (the detector would drop the voxels past its cap)."""
    from seevcn_torch.experiments.da_experiment import load_set
    from seevcn_torch.ops.voxelize import voxelize

    pts, val = load_set(path)[:2]
    proc = cfg.DATA_CONFIG.DATA_PROCESSOR[0]
    caps = {k: int(v) for k, v in proc.MAX_NUMBER_OF_VOXELS.items()}
    active = [int(voxelize(torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev),
                           point_cloud_range=cfg.DATA_CONFIG.POINT_CLOUD_RANGE,
                           voxel_size=proc.VOXEL_SIZE, max_voxels=len(p)).mask.sum())
              for p, v in zip(pts, val)]
    if max(active) >= min(caps.values()):
        raise AssertionError(f"a completed DA frame fills {max(active)} voxels, caps {caps}")
    return {"rows": int(pts.shape[1]), "active": active, "caps": caps}


def da_train(DAX, name: str, train_set: str, out: str, flags: list, dev) -> dict:
    """``da_experiment train`` for DA_STEPS steps at DA_BATCH (bf16 backbone),
    each step's CUDA events recorded around ``train_step``: finite losses,
    every parameter moved from the seeded start, ``ckpt.pth`` reloaded bit
    for bit."""
    from seevcn_torch.utils.ckpt import detector_state_dict_from_torch, load_torch_checkpoint

    events, real = [], DAX.train_step

    def timed(*args, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if dev.type == "cuda" \
            else None
        if ev:
            ev[0].record()
        out_ = real(*args, **kw)
        if ev:
            ev[1].record()
            events.append(ev)
        return out_

    DAX.train_step = timed
    try:
        got = DAX.main(["train", "--train", train_set, "--out", out, "--steps", str(DA_STEPS),
                        "--batch", str(DA_BATCH), "--bf16", "--remat", "none",
                        "--log_every", "1", "--ckpt_every", str(DA_STEPS)] + flags)
    finally:
        DAX.train_step = real
    if dev.type == "cuda":
        torch.cuda.synchronize()
    model = got["state"].model
    start, _ = DAX.seeded_detector(DAX.da_detector_cfg(0), "cpu")
    start = dict(start.named_parameters())
    still = [n for n, p in model.named_parameters() if torch.equal(p.detach().cpu(), start[n])]
    ck = load_torch_checkpoint(os.path.join(out, "ckpt.pth"))
    reload_equal = state_reloads(detector_state_dict_from_torch(ck["model_state"]), model)
    res = {"losses": got["losses"], "step_ms_host": [s * 1e3 for s in got["step_s"]],
           "step_ms_events": [a.elapsed_time(b) for a, b in events],
           "still": still, "ckpt_it": int(ck["it"]), "reload_bit_equal": reload_equal}
    if len(got["losses"]) != DA_STEPS or not all(math.isfinite(v) for v in got["losses"]) \
            or still or not reload_equal or ck["it"] != DA_STEPS:
        raise AssertionError(f"DA training {name}: {res}")
    return res


def da_experiments(dev, card) -> dict:
    """Phase 25: the repo's own SEE experiments through the port's entry
    points (``seevcn_torch.experiments``), at full width and cut depth: the
    DA sets and VC data (``da_generate``), VCN_VC and VCN_CN one epoch each
    (``train_vcn_da``), the GT-path completion of the source sets by VCN_CN
    and of the target by VCN_VC (K1 once a frame, ``da_launches``), one
    completed frame card vs CPU, the completed frames' voxels against the
    caps, the raw and completed-source detectors (``train``), the runbook's
    five evals and the batch-1 / batch-3 identity (``eval``), the AP table
    (``da_table``), and the DET-vs-GT mask paths on MASKPATH_FRAMES frames
    with a seeded Mask R-CNN (``measure_maskpath_impact``, K1 twice a
    frame)."""
    from seevcn_torch.experiments import da_experiment as DAX
    from seevcn_torch.experiments import da_generate as DAG
    from seevcn_torch.experiments import da_table as DAT
    from seevcn_torch.experiments import measure_maskpath_impact as MPI
    from seevcn_torch.experiments import train_vcn_da as TVD

    flags = [] if dev.type == "cuda" else ["--cpu"]
    parts, res, t_phase = {}, {}, time.time()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix="da_experiments_") as base:
        da = os.path.join(base, "da")
        t0 = time.time()
        DAG.main(["--out", da, "--n_train", str(DA_TRAIN_FRAMES), "--n_val", str(DA_VAL_FRAMES),
                  "--n_tgt", str(DA_TGT_FRAMES), "--vc_frames", str(DA_VC_FRAMES)])
        n_frames = DA_TRAIN_FRAMES + DA_VAL_FRAMES + DA_TGT_FRAMES
        res["generate"] = {"s": time.time() - t0, "frames": n_frames + 3 * DA_VC_FRAMES,
                           "vc_objects": len(os.listdir(os.path.join(da, "vc_data")))}
        res["generate"]["s_per_frame"] = res["generate"]["s"] / res["generate"]["frames"]
        parts["generate"], t0 = time.time() - t0, time.time()

        vcn_path, res["vcn"] = {}, {}
        for model in ("VCN_VC", "VCN_CN"):
            out = os.path.join(base, f"vcn_{model}")
            trainer, state = TVD.main(["--epochs", "1", "--batch_size", "16", "--data",
                                       os.path.join(da, "vc_data"), "--out", out, "--model",
                                       model] + flags)
            # the held-out split (every 10th object) is under one batch of 16, so
            # fit's validation (every --val_freq 10 epochs) would write no
            # ckpt-best: the epoch's ckpt-last serves, and the split is validated
            # here in one batch
            vcn_path[model] = os.path.join(out, "ckpt-last.pth")
            equal = state_reloads(load_vcn_checkpoint(vcn_path[model], model), state.model)
            held = VCDataset(os.path.join(da, "vc_data"), n_points=1024, n_complete=2048)
            held.samples = held.samples[::10]
            cdl1 = float(trainer.validate(state, held, len(held))["CDL1"])
            res["vcn"][model] = {"val_cdl1": cdl1, "val_objects": len(held),
                                 "reload_bit_equal": equal}
            if not math.isfinite(cdl1) or not equal:
                raise AssertionError(f"train_vcn_da {model}: {res['vcn'][model]}")
        parts["train_vcn_da"], t0 = time.time() - t0, time.time()

        K.reset_launches()
        res["complete"] = {}
        for name, model in (("src_train", "VCN_CN"), ("src_val", "VCN_CN"),
                            ("tgt_val", "VCN_VC")):
            res["complete"][name] = DAX.main(["complete", "--set", os.path.join(da, f"{name}.npz"),
                                              "--vcn", vcn_path[model], "--model", model] + flags)
        sync()
        res["da_launches"] = K.LAUNCHES["min_sqdist_pruned"]
        if dev.type == "cuda" and res["da_launches"] != n_frames:
            raise AssertionError(f"K1 launched {res['da_launches']} times for {n_frames} "
                                 "completed DA frames")
        parts["complete"], t0 = time.time() - t0, time.time()
        res["card_vs_cpu"] = hold_da_frame_against_cpu(os.path.join(da, "src_train.npz"),
                                                       vcn_path["VCN_CN"], dev)
        res["voxels"] = da_voxels(os.path.join(da, "src_train.completed.npz"),
                                  DAX.da_detector_cfg(0), dev)
        parts["card_vs_cpu"], t0 = time.time() - t0, time.time()

        res["train"] = {name: da_train(DAX, name, os.path.join(da, f"{src}.npz"),
                                       os.path.join(da, name), flags, dev)
                        for name, src in (("det_raw", "src_train"),
                                          ("det_see", "src_train.completed"))}
        parts["train"], t0 = time.time() - t0, time.time()

        res["eval"] = {}
        for name, det, set_name in DA_EVALS:
            t1 = time.time()
            s_ = DAX.main(["eval", "--ckpt", os.path.join(da, det, "ckpt.pth"), "--set",
                           os.path.join(da, f"{set_name}.npz"), "--out_json",
                           os.path.join(da, f"ap_{name}.json")] + flags)
            res["eval"][name] = {k: s_[k] for k in ("ap_3d_07_r40", "ap_bev_07_r40", "n_frames",
                                                    "n_dets")}
            res["eval"][name]["s_per_frame"] = (time.time() - t1) / s_["n_frames"]
        parity = {b: DAX.main(["eval", "--ckpt", os.path.join(da, "det_see", "ckpt.pth"),
                               "--set", os.path.join(da, "tgt_val.completed.npz"),
                               "--score_thresh", "0.0", "--eval_batch", str(b)] + flags)
                  for b in (1, 3)}
        keys = ("n_dets", "ap_3d_07_r40", "ap_bev_07_r40")
        res["eval_batch_parity"] = {b: {k: parity[b][k] for k in keys} for b in parity}
        if any(parity[1][k] != parity[3][k] for k in keys):
            raise AssertionError(f"eval at batch 1 and 3 differ: {res['eval_batch_parity']}")
        res["table"] = DAT.main(["--protocol", "da2", da])
        parts["eval"], t0 = time.time() - t0, time.time()

        seg_cfg = SM.Seg2DConfig()
        seg_path = os.path.join(base, "seg2d.ckpt")
        save_seg2d_checkpoint(seg_path, init_seg2d(SM.MaskRCNN(seg_cfg),
                                                   torch.Generator().manual_seed(0)), seg_cfg)
        K.reset_launches()
        res["maskpath"] = MPI.main(["--ckpt", seg_path, "--frames", str(MASKPATH_FRAMES),
                                    "--vcn_ckpt", vcn_path["VCN_VC"]] + flags)
        sync()
        res["maskpath_launches"] = K.LAUNCHES["min_sqdist_pruned"]
        if dev.type == "cuda" and res["maskpath_launches"] != 2 * MASKPATH_FRAMES:
            raise AssertionError(f"K1 launched {res['maskpath_launches']} times in "
                                 f"{MASKPATH_FRAMES} maskpath frames")
        parts["maskpath"] = time.time() - t0
    res["part_s"], res["phase_s"] = parts, time.time() - t_phase

    comp = res["complete"]
    tr = res["train"]
    print(f"phase 25 da_generate: {res['generate']['frames']} frames (sets "
          f"{DA_TRAIN_FRAMES} + {DA_VAL_FRAMES} at 64 beams, {DA_TGT_FRAMES} at 16; VC "
          f"{DA_VC_FRAMES} a beam count, {res['generate']['vc_objects']} objects) in "
          f"{res['generate']['s']:.1f} s = {res['generate']['s_per_frame']:.2f} s a frame (host)")
    print("phase 25 train_vcn_da (1 epoch, batch 16): " + "; ".join(
        f"{m} CDL1 on the {v['val_objects']} held-out objects {v['val_cdl1']:.4f}, "
        f"ckpt-last reloads bit for bit "
        f"{v['reload_bit_equal']}" for m, v in res["vcn"].items()))
    print("phase 25 complete (GT path, source VCN_CN, target VCN_VC): " + "; ".join(
        f"{n} {c['frames']} frames {c['s'] / c['frames']:.3f} s a frame, in-box fraction of "
        f"added points {c['in_box']:.3f}" for n, c in comp.items())
        + f"; K1 launches (da_launches) {res['da_launches']} for {n_frames} frames")
    cv = res["card_vs_cpu"]
    print(f"phase 25 one completed source frame card vs CPU: {cv['instances']} instances, "
          f"stray rows of an instance at most {cv['stray_rows_max']} (bound {DA_STRAY_ROWS}), "
          f"rows apart at most {cv['rows_apart_max']:.3g} m (bound {DA_STRAY_M}), worst point "
          f"difference among the rest {cv['point_diff_max']:.3g} m; scan points kept apart "
          f"{cv['kept_apart_cpu']}; the card's replacement vs the plain sweep "
          f"{cv['replacement_mismatches']} mismatches ({cv['ties']} ties)")
    vx = res["voxels"]
    print(f"phase 25 completed source frames ({vx['rows']} rows): active voxels {vx['active']} "
          f"against the caps {vx['caps']}")
    for name, t in tr.items():
        ev = t["step_ms_events"]
        print(f"phase 25 train {name} ({DA_STEPS} steps, batch {DA_BATCH}, bf16): losses "
              + ", ".join(f"{v:.4f}" for v in t["losses"])
              + f"; step ms host first {t['step_ms_host'][0]:.1f}, then median "
              f"{statistics.median(t['step_ms_host'][1:]):.1f}"
              + (f"; CUDA events first {ev[0]:.1f}, then median {statistics.median(ev[1:]):.1f}"
                 if ev else "") + f"; ckpt.pth at it {t['ckpt_it']} reloads bit for bit")
    print(f"phase 25 eval (APs after {DA_STEPS} steps, not gated): " + "; ".join(
        f"{n} 3D {e['ap_3d_07_r40']:.2f} BEV {e['ap_bev_07_r40']:.2f} dets {e['n_dets']} "
        f"{e['s_per_frame']:.3f} s a frame" for n, e in res["eval"].items())
        + f"; --eval_batch 1 vs 3 (score 0.0): {res['eval_batch_parity']}")
    print("phase 25 AP table:\n" + "\n".join(res["table"]))
    print(f"phase 25 maskpath: {res['maskpath']}; K1 launches {res['maskpath_launches']} "
          f"for {MASKPATH_FRAMES} frames on {card}")
    print("phase 25 by part, s: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return res


def phase_alone(dev, card, phase: int) -> int:
    """``--phase 22`` / ``--phase 23`` / ``--phase 24`` / ``--phase 25``: that
    phase after the set-up it needs (the kernels built; for 23 and 24 VCN_VC
    at seeded weights and phase 9's 4 GT frames completed in one process; 22
    runs its JPEG fixtures and the demo only; 25 needs nothing more); no
    other phase runs and no result line is printed."""
    t0 = time.time()
    K.build(K.KERNELS)
    if phase == 25:
        da = da_experiments(dev, card)
        print(f"da_launches {da['da_launches']}, maskpath {da['maskpath_launches']}; phase 25 "
              f"{da['phase_s']:.1f} s, {time.time() - t0:.1f} s with its set-up")
        return 0
    if phase == 22:
        res = {"jpeg": check_jpeg_fixtures(dev)}
        with tempfile.TemporaryDirectory(prefix="demo_jpeg_") as base:
            res["demo"] = demo_cli(dev, os.path.join(base, "demo"))
        print(json.dumps({"jpeg": res["jpeg"], "demo_launches": res["demo"]["demo_launches"],
                          "demo_s": res["demo"]["s"], "exif_front": res["demo"]["exif_front"],
                          "card_vs_cpu": res["demo"]["card_vs_cpu"], "card": card}))
        print(f"phase 22 (JPEG fixtures and the demo) {time.time() - t0:.1f} s with its set-up")
        return 0
    vcn = VCNInference("VCN_VC", seeded_vcn_state_dict(0), device=dev)
    scenes = [make_scene(seed, 150_000, 32) for seed in range(4)]
    g_pts, g_valid, g_gt, g_stats, _, _ = check_gt_completion(vcn, scenes, dev)
    print(f"set-up {time.time() - t0:.1f} s", flush=True)
    if phase == 24:
        mpr = model_parallel(dev, card, g_pts, g_valid, g_gt)
        print(f"phase 24 {mpr['phase_s']:.1f} s, {time.time() - t0:.1f} s with its set-up")
        return 0
    dp = data_parallel(dev, card, scenes, g_pts, g_valid, g_gt, g_stats)
    print(f"sharded_completion_launches {dp['sharded_completion_launches']}; phase 23 "
          f"{dp['phase_s']:.1f} s, {time.time() - t0:.1f} s with its set-up")
    return 0


def main(argv=None) -> int:
    """Every phase, then the kernels line and the result line; with
    ``--phase 22``, 23, 24 or 25, that phase alone (``phase_alone``)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", type=int, choices=[22, 23, 24, 25], default=None,
                    help="run only this phase, after the set-up it needs")
    args = ap.parse_args(argv)
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
    if args.phase is not None:
        return phase_alone(dev, card, args.phase)
    t_start = time.time()

    # --- 1. build every kernel, one nvcc per source, all at once, and the
    # host JPEG decoder (g++) beside them ------------------------------------
    from seevcn_torch.data import jpeg as JPG

    t0 = time.time()
    jpeg_build = {}
    jpeg_thread = threading.Thread(target=lambda: jpeg_build.update(
        s=(JPG.build(), time.time() - t0)[1]))
    jpeg_thread.start()
    logs = K.build(K.KERNELS)
    jpeg_thread.join()
    if "s" not in jpeg_build:
        raise RuntimeError("the JPEG decoder did not build")
    print(f"build: {time.time() - t0:.1f} s for {list(K.KERNELS)}, the JPEG decoder "
          f"(g++, beside them) {jpeg_build['s']:.1f} s")
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

    # --- 11. Mask R-CNN training at the CLI's defaults ----------------------
    seg2d_train = train_seg2d(dev, card)

    # --- 12. HTC serving: the mask stage, the fused frame, the backend -------
    htc = serve_htc(dev, card, s, vcn, det, det_cfg, proj, l2c, image)

    # --- 13. HTC training: the CLI's HTC flags, then DCN through the API ----
    htc_train = train_seg2d(dev, card, steps=3, flags=HTC_FLAGS,
                            tiny_cfg=tiny_htc_cfg(dcn=True), cli_steps=2,
                            roi_px=HTC_ROI_PX, eval_scenes=2)
    htc_train["dcn_step"] = train_dcn_step(dev, card)

    # --- 14. PV-RCNN: on the completed frame, then training ------------------
    pvrcnn = serve_pvrcnn(dev, card, s, vcn, seg, proj, l2c, image)
    pvrcnn["train"] = train_pvrcnn(dev, card, g_pts, g_valid, g_gt)

    # --- 15. PV-RCNN++: on the completed frame, then training ----------------
    t15 = time.time()
    plusplus = serve_pvrcnn_plusplus(dev, card, s, vcn, seg, proj, l2c, image)
    kernels[0]["pvrcnn_plusplus_launches"] = {
        "see_and_detect": plusplus["launches"]["min_sqdist_pruned"],
        "run_frame": plusplus["fused_launches"]["min_sqdist_pruned"]}
    plusplus["train"] = train_pvrcnn(dev, card, g_pts, g_valid, g_gt, steps=TIMED_STEPS,
                                     cfg=DC.pvrcnn_plusplus_detector_cfg(),
                                     tiny_cfg=DC.tiny_pvrcnn_plusplus_cfg(),
                                     label="PV-RCNN++", tiny_grad_tol=PLUSPLUS_F32_GRAD)
    plusplus["phase_s"] = time.time() - t15
    print(f"phase 15 (PV-RCNN++) ran {plusplus['phase_s']:.0f} s; chip_smoke ran "
          f"{time.time() - t_start:.0f} s after start-up")

    # --- 16. single-stage detectors: PointPillar and SECONDNet ---------------
    t16 = time.time()
    singles = single_stage(dev, card, s, vcn, seg, proj, l2c, image, g_pts, g_valid, g_gt)
    for key in ("pointpillar", "second_multihead"):
        kernels[0][f"{key}_launches"] = {
            "see_and_detect": singles[key]["launches"]["min_sqdist_pruned"],
            "run_frame": singles[key]["fused_launches"]["min_sqdist_pruned"]}
    singles["phase_s"] = time.time() - t16
    print(f"phase 16 (PointPillar, SECONDNet) ran {singles['phase_s']:.0f} s; chip_smoke "
          f"ran {time.time() - t_start:.0f} s after start-up")

    # --- 17. CenterPoint and Voxel R-CNN ---------------------------------------
    t17 = time.time()
    centers = center_rcnn(dev, card, s, vcn, seg, proj, l2c, image, g_pts, g_valid, g_gt)
    for key in CENTER_RCNN:
        kernels[0][f"{key}_launches"] = {
            "see_and_detect": centers[key]["launches"]["min_sqdist_pruned"],
            "run_frame": centers[key]["fused_launches"]["min_sqdist_pruned"]}
    centers["phase_s"] = time.time() - t17
    print(f"phase 17 (CenterPoint, Voxel R-CNN) ran {centers['phase_s']:.0f} s; chip_smoke "
          f"ran {time.time() - t_start:.0f} s after start-up")

    # --- 18. PointRCNN and Part-A2 ----------------------------------------------
    t18 = time.time()
    points_parts = point_part(dev, card, s, vcn, seg, proj, l2c, image, g_pts, g_valid, g_gt)
    for key in POINT_PART:
        kernels[0][f"{key}_launches"] = {
            "see_and_detect": points_parts[key]["launches"]["min_sqdist_pruned"],
            "run_frame": points_parts[key]["fused_launches"]["min_sqdist_pruned"]}
    points_parts["phase_s"] = time.time() - t18
    print(f"phase 18 (PointRCNN, Part-A2) ran {points_parts['phase_s']:.0f} s; chip_smoke "
          f"ran {time.time() - t_start:.0f} s after start-up")

    # --- 19. CaDDN and the KITTI data path ----------------------------------------
    t19 = time.time()
    caddn = caddn_kitti(dev, card, vcn)
    kernels[0]["kitti_launches"] = caddn["kitti_data"]["gt_completion_launches"]
    caddn["phase_s"] = time.time() - t19
    print(f"phase 19 (CaDDN, KITTI data) ran {caddn['phase_s']:.0f} s; chip_smoke ran "
          f"{time.time() - t_start:.0f} s after start-up")

    # --- 20. the KITTI SEE-VCN workflow through the CLIs ------------------------------
    workflow = kitti_workflow(dev, card)
    kernels[0]["see_cli_launches"] = workflow["run_see"]["k1_launches"]
    print(f"phase 20 (KITTI workflow) ran {workflow['phase_s']:.0f} s; chip_smoke ran "
          f"{time.time() - t_start:.0f} s after start-up")

    # --- 21. the other domains: Waymo (source) -> nuScenes, Lyft, Baraja -------------
    domains = domain_workflow(dev, card)
    kernels[0]["domain_see_launches"] = domains["domain_see_launches"]
    print(f"phase 21 (Waymo -> nuScenes, Lyft, Baraja) ran {domains['phase_s']:.0f} s; "
          f"chip_smoke ran {time.time() - t_start:.0f} s after start-up")

    # --- 22. the demo, the JPEG inputs, bf16 BEV, the DA frames, paired IoU ----------
    demo = demo_jpeg(dev, card, new_pts, new_valid, det, det_cfg, g_pts, g_valid, g_gt)
    kernels[0]["demo_launches"] = demo["demo"]["demo_launches"]
    print(f"phase 22 (demo, JPEG, bf16 BEV) ran {demo['phase_s']:.0f} s; chip_smoke ran "
          f"{time.time() - t_start:.0f} s after start-up")

    # --- 23. data parallelism on one card: NCCL at world 1, gloo at world 2 ----------
    dp = data_parallel(dev, card, gt_scenes, g_pts, g_valid, g_gt, g_stats)
    kernels[0]["sharded_completion_launches"] = dp["sharded_completion_launches"]
    print(f"phase 23 (data parallelism) ran {dp['phase_s']:.0f} s; chip_smoke ran "
          f"{time.time() - t_start:.0f} s after start-up")

    # --- 24. the mp axis on one card: gloo at (dp 1, mp 2) and (dp 2, mp 2) ----------
    mpr = model_parallel(dev, card, g_pts, g_valid, g_gt)
    print(f"phase 24 (model parallelism) ran {mpr['phase_s']:.0f} s; chip_smoke ran "
          f"{time.time() - t_start:.0f} s after start-up")

    # --- 25. the repo's own SEE experiments: DA run and the mask-path measurement ----
    da = da_experiments(dev, card)
    kernels[0]["da_launches"] = {"complete": da["da_launches"],
                                 "maskpath": da["maskpath_launches"]}
    print(f"phase 25 (the DA experiment, maskpath) ran {da['phase_s']:.0f} s; chip_smoke ran "
          f"{time.time() - t_start:.0f} s after start-up")

    # --- summary lines ---------------------------------------------------------
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
        "seg2d_train": seg2d_train, "htc": htc, "htc_train": htc_train,
        "pvrcnn": pvrcnn, "pvrcnn_plusplus": plusplus,
        "pointpillar": singles["pointpillar"], "second_multihead": singles["second_multihead"],
        "second_focal": singles["second_focal"],
        "single_stage_checks": {k: singles[k] for k in ("tiny_vs_cpu", "tiny_steps_vs_cpu",
                                                        "atss", "phase_s")},
        "centerpoint": centers["centerpoint"], "voxel_rcnn": centers["voxel_rcnn"],
        "center_rcnn_checks": {k: centers[k] for k in ("tiny_vs_cpu", "tiny_steps_vs_cpu",
                                                       "part_s", "phase_s")},
        "pointrcnn": points_parts["pointrcnn"], "parta2": points_parts["parta2"],
        "point_part_checks": {k: points_parts[k] for k in (
            "tiny_vs_cpu", "tiny_steps_vs_cpu", "inverse_conv_vs_cpu", "part_s", "phase_s")},
        "caddn": {**caddn["caddn"], **{k: caddn[k] for k in (
            "tiny_vs_cpu", "tiny_steps_vs_cpu", "part_s", "phase_s")}},
        "kitti_data": caddn["kitti_data"], "kitti_workflow": workflow,
        "domain_workflow": domains, "demo_jpeg": demo, "data_parallel": dp,
        "model_parallel": mpr, "da_experiments": {k: da[k] for k in (
            "generate", "vcn", "complete", "da_launches", "card_vs_cpu", "voxels", "eval",
            "eval_batch_parity", "maskpath", "maskpath_launches", "part_s", "phase_s")},
        "da_train": {n: {k: v for k, v in t.items() if k != "still"}
                     for n, t in da["train"].items()}, "card": smi}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
