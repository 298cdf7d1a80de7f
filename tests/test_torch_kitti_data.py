"""The KITTI data and eval path of the port (seevcn_torch.geom.calibration,
the camera box conversions of seevcn_torch.geom.boxes, seevcn_torch.data:
augmentor, dataset, loader, png, kitti.{dataset,eval}, registry, and
seevcn_torch.train.eval) against the JAX package on the CPU.

Data: ``chip_smoke.write_kitti_split``'s synthetic split (make_scene's
clouds, KITTI's calibration, PNGs written by the port's writer) and
tests/test_data_layer.py's camera-item split (PNGs written by cv2), made in
pytest's temporary directories; frames and boxes from numpy seeds.

Tolerances: frames, items, PNGs, the GT-database paste, the loader's
batches and the AP report bit for bit; the augmentations, fed JAX's own
draws (threefry's numbers cannot be drawn by torch), within 1e-5 m (the
rotations are f32 products in each framework's matmul), validity and
masks equal; eval_one_epoch's AP dict and recall counts equal.
"""
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import KITTI_P2, KITTI_R0, KITTI_V2C, kitti_cfg, write_kitti_split
from seevcn_tpu.data import augmentor as JA
from seevcn_tpu.data import dataset as JDS
from seevcn_tpu.data import loader as JL
from seevcn_tpu.data.kitti import dataset as JK
from seevcn_tpu.data.kitti import eval as JE
from seevcn_tpu.geom import boxes as JB
from seevcn_tpu.geom import calibration as JC
from seevcn_torch.data import augmentor as TA
from seevcn_torch.data import dataset as TDS
from seevcn_torch.data import loader as TL
from seevcn_torch.data import registry as TR
from seevcn_torch.data.kitti import dataset as TK
from seevcn_torch.data.kitti import eval as TE
from seevcn_torch.data.png import read_png, write_png
from seevcn_torch.geom import boxes as TB
from seevcn_torch.geom import calibration as TC
from seevcn_torch.testing import assert_close, to_numpy, to_torch
from seevcn_torch.utils.config import Cfg


def _ds_cfg(root, **kw):
    """``chip_smoke.kitti_cfg`` (kitti_dataset.yaml's data config, no
    augmentation) over the synthetic split at the tiny detector's range."""
    return kitti_cfg(str(root), **{"POINT_CLOUD_RANGE": [0, -8, -2, 16, 8, 2], **kw})


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    infos = write_kitti_split(str(root), 3, seed=1, n_points=6000, n_cars=3)
    return root, infos


def _item_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


# --------------------------------------------------------------------------- #
# calibration, camera boxes, PNGs
# --------------------------------------------------------------------------- #

def test_calibration_and_camera_boxes_match_jax(split):
    """KittiCalibration from a calib file and from the infos; every lidar /
    rect / image map; JsonCalibration pinhole and fisheye; the camera box
    round trip, corners, image boxes and mask_boxes_outside_range."""
    root, infos = split
    path = str(root / "training" / "calib" / "000000.txt")
    rng = np.random.RandomState(0)
    pts = rng.uniform([1, -20, -3], [60, 20, 1], (500, 3))
    for src in (path, {"P2": KITTI_P2, "R0": KITTI_R0, "Tr_velo2cam": KITTI_V2C}):
        tc, jc = TC.KittiCalibration(src), JC.KittiCalibration(src)
        for fn in ("lidar_to_rect", "rect_to_lidar", "lidar_to_img"):
            got, ref = getattr(tc, fn)(pts), getattr(jc, fn)(pts)
            for g, r in zip(got if isinstance(got, tuple) else (got,),
                            ref if isinstance(ref, tuple) else (ref,)):
                np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(tc.img_to_rect(pts[:, 0], pts[:, 1], pts[:, 2]),
                                      jc.img_to_rect(pts[:, 0], pts[:, 1], pts[:, 2]))
    for dist in ([0.1, -0.05, 0.001, 0.002, 0.01], [0.1, -0.02, 0.003, -0.001]):
        spec = {"intrinsic": np.eye(3) * 500 + [[0, 0, 320], [0, 0, 240], [0, 0, -499]],
                "extrinsic": np.eye(4), "distortion": dist}
        for g, r in zip(TC.JsonCalibration(spec).lidar_to_img(pts[:, [1, 2, 0]]),
                        JC.JsonCalibration(spec).lidar_to_img(pts[:, [1, 2, 0]])):
            np.testing.assert_array_equal(g, r)
    calib = TC.KittiCalibration(path)
    boxes = infos[0]["annos"]["gt_boxes_lidar"]
    cam = TB.boxes3d_lidar_to_kitti_camera(boxes, calib)
    np.testing.assert_array_equal(cam, JB.boxes3d_lidar_to_kitti_camera(boxes, calib))
    back = TB.boxes3d_kitti_camera_to_lidar(cam, calib)
    np.testing.assert_array_equal(back, JB.boxes3d_kitti_camera_to_lidar(cam, calib))
    np.testing.assert_allclose(back, boxes, atol=1e-6)
    np.testing.assert_array_equal(TB.boxes3d_to_corners3d_kitti_camera(cam),
                                  JB.boxes3d_to_corners3d_kitti_camera(cam))
    np.testing.assert_array_equal(
        TB.boxes3d_kitti_camera_to_imageboxes(cam, calib, (375, 1242)),
        JB.boxes3d_kitti_camera_to_imageboxes(cam, calib, (375, 1242)))
    many = np.concatenate([boxes, boxes + [30, 0, 0, 0, 0, 0, 0], boxes - [0, 0, 3, 0, 0, 0, 0]])
    lim = [0, -40, -3, 50, 40, 1]
    np.testing.assert_array_equal(
        to_numpy(TB.mask_boxes_outside_range(to_torch(many.astype(np.float32)), lim)),
        np.asarray(JB.mask_boxes_outside_range(jnp.asarray(many, jnp.float32), lim)))


@pytest.mark.parametrize("case", ["filter0", "filter1", "filter2", "filter3", "filter4",
                                  "mixed_rgba", "cv2_written"])
def test_png_reader_matches_cv2(tmp_path, case):
    """read_png against cv2.imread, bit for bit: an RGB image and a 16-bit
    depth map with every row in one filter (or the five mixed, with an RGBA
    image), and files cv2 wrote itself (libpng's own filter choice)."""
    rng = np.random.RandomState(3)
    y, x = np.mgrid[0:41, 0:67]
    img = np.stack([x * 3, y * 5, x + y], -1) % 256 + rng.randint(0, 3, (41, 67, 3))
    img = img.clip(0, 255).astype(np.uint8)
    depth = ((x * 37 + y * 1000) % 65536).astype(np.uint16)
    ip, dp = str(tmp_path / "i.png"), str(tmp_path / "d.png")
    if case == "cv2_written":
        cv2.imwrite(ip, img[..., ::-1])
        cv2.imwrite(dp, depth)
    else:
        filters = [r % 5 for r in range(41)] if case == "mixed_rgba" else int(case[-1])
        write_png(ip, np.concatenate([img, img[..., :1]], -1) if case == "mixed_rgba" else img,
                  filters)
        write_png(dp, depth, filters)
    np.testing.assert_array_equal(read_png(ip)[..., :3], cv2.imread(ip)[..., ::-1])
    np.testing.assert_array_equal(read_png(dp), cv2.imread(dp, cv2.IMREAD_UNCHANGED))
    if case != "cv2_written":
        np.testing.assert_array_equal(read_png(ip)[..., :3], img)
        np.testing.assert_array_equal(read_png(dp), depth)
    cv2.imwrite(str(tmp_path / "gray8.png"), img[..., 0])
    np.testing.assert_array_equal(read_png(str(tmp_path / "gray8.png")), img[..., 0])
    cv2.imwrite(str(tmp_path / "rgb16.png"), depth[..., None].repeat(3, -1))
    with pytest.raises(ValueError, match="bit depth 16, colour type 2"):
        read_png(str(tmp_path / "rgb16.png"))


# --------------------------------------------------------------------------- #
# frames and the dataset
# --------------------------------------------------------------------------- #

def test_prepare_frame_matches_jax(split):
    """DatasetTemplate.prepare_frame bit for bit: the shift, the class
    filter, the range mask, the shuffle, a subsample (more points than
    max_points) and the training min-points filter."""
    root, infos = split
    pts = np.fromfile(str(root / "training" / "velodyne" / "000001.bin"),
                      np.float32).reshape(-1, 4)
    boxes = infos[1]["annos"]["gt_boxes_lidar"].astype(np.float32)
    names = np.array(["Car", "Van", "Car"])
    for training, kw in ((False, {}), (True, {"MIN_POINTS_OF_GT": 50,
                                              "SHIFT_COOR": [0.5, -0.25, 0.1]})):
        cfg = _ds_cfg(root, POINT_CLOUD_RANGE=[0, -40, -3, 70.4, 40, 1], **kw)
        a = TDS.DatasetTemplate(cfg, ["Car"], training, max_points=1024, max_boxes=4)
        b = JDS.DatasetTemplate(cfg, ["Car"], training, max_points=1024, max_boxes=4)
        for seed in (0, 7):
            _item_equal(a.prepare_frame(pts, boxes, names, seed),
                        b.prepare_frame(pts, boxes, names, seed))


@pytest.mark.parametrize("kind", ["KittiDataset", "SCKittiDataset"])
def test_kitti_dataset_matches_jax(split, kind):
    """The synthetic split through both KittiDatasets (SCKittiDataset on
    .pcd copies of the clouds): every item of every frame bit for bit, with
    FOV_POINTS_ONLY, images, depth maps and calib matrices; the port's
    gt_boxes2d, which JAX's dataset has not, the annos' image boxes."""
    from seevcn_torch.geom.pcd_io import write_pcd

    root, infos = split
    os.makedirs(root / "training" / "vcn", exist_ok=True)
    for info in infos:
        idx = info["point_cloud"]["lidar_idx"]
        pts = np.fromfile(str(root / "training" / "velodyne" / f"{idx}.bin"),
                          np.float32).reshape(-1, 4)
        write_pcd(str(root / "training" / "vcn" / f"{idx}.pcd"), pts[:, :3])
    cfg = _ds_cfg(root, GET_ITEM_LIST=["points", "images", "depth_maps", "calib_matricies",
                                       "gt_boxes2d"],
                  POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z"],
                                          "src_feature_list": ["x", "y", "z"]}
                  if kind == "SCKittiDataset" else _ds_cfg(root).POINT_FEATURE_ENCODING)
    a = getattr(TK, kind)(cfg, ["Car"], False, max_points=2048, max_boxes=8)
    b = getattr(JK, kind)(cfg, ["Car"], False, max_points=2048, max_boxes=8)
    assert len(a) == len(b) == 3
    for i in range(3):
        got, ref = a[i], b[i]
        boxes2d = got.pop("gt_boxes2d")
        _item_equal(got, ref)
        np.testing.assert_array_equal(boxes2d[:3], infos[i]["annos"]["bbox"].astype(np.float32))
        assert got["images"].shape == (384, 1280, 3) and (got["depth_maps"] > 0).sum() > 100
    assert isinstance(TR.build_dataset(Cfg({**cfg, "DATASET": kind}), ["Car"], False), getattr(
        TK, kind))
    with pytest.raises(KeyError, match="NoSuchDataset"):
        TR.build_dataset(Cfg({**cfg, "DATASET": "NoSuchDataset"}), ["Car"], False)


def test_camera_items_match_jax(tmp_path):
    """tests/test_data_layer.py's camera-item split (cv2-written PNGs, a
    point behind the camera, IMAGE_PAD_SHAPE 128 x 256) through both
    datasets: every item bit for bit."""
    root = tmp_path
    for sub in ("velodyne", "image_2", "depth_2"):
        os.makedirs(root / "training" / sub, exist_ok=True)
    np.array([[10, 0, 0, 0.5], [12, 1, 0, 0.5], [-5, 0, 0, 0.5]],
             np.float32).tofile(root / "training" / "velodyne" / "000001.bin")
    cv2.imwrite(str(root / "training" / "image_2" / "000001.png"),
                np.full((100, 200, 3), 128, np.uint8))
    cv2.imwrite(str(root / "training" / "depth_2" / "000001.png"),
                (np.full((100, 200), 7.25) * 256).astype(np.uint16))
    info = {"point_cloud": {"lidar_idx": "000001"},
            "image": {"image_shape": np.array([100, 200])},
            "calib": {"P2": np.array([[50, 0, 100, 0], [0, 50, 50, 0], [0, 0, 1, 0],
                                      [0, 0, 0, 1.0]]),
                      "R0_rect": np.eye(4),
                      "Tr_velo_to_cam": np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                                                  [0, 0, 0, 1.0]])},
            "annos": {"name": np.array(["Car"]),
                      "gt_boxes_lidar": np.array([[10, 0, 0, 4, 2, 1.5, 0.0]]),
                      "num_points_in_gt": np.array([2])}}
    with open(root / "infos_val.pkl", "wb") as f:
        pickle.dump([info], f)
    cfg = _ds_cfg(root, INFO_PATH={"train": [], "test": ["infos_val.pkl"]},
                  POINT_CLOUD_RANGE=[0, -40, -3, 70.4, 40, 1],
                  GET_ITEM_LIST=["points", "images", "depth_maps", "calib_matricies"],
                  IMAGE_PAD_SHAPE=(128, 256),
                  POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z", "intensity"]})
    got = TK.KittiDataset(cfg, ["Car"], False, str(root), max_points=16, max_boxes=4)[0]
    ref = JK.KittiDataset(cfg, ["Car"], False, str(root), max_points=16, max_boxes=4)[0]
    _item_equal(got, ref)
    assert int(got["points_valid"].sum()) == 2


def test_gt_database_sampler_matches_jax(split):
    """GTDatabaseSampler on the split's own database (Car:15, min 5 points)
    pasting into frame 2 over three calls: points, boxes and names bit for
    bit (the same default_rng(0) draws, the same aligned-BEV rejections)."""
    root, infos = split
    sampler_cfg = {"NAME": "gt_sampling", "DB_INFO_PATH": ["kitti_dbinfos_train.pkl"],
                   "PREPARE": {"filter_by_min_points": ["Car:5"]},
                   "SAMPLE_GROUPS": ["Car:15"], "NUM_POINT_FEATURES": 4}
    a = TA.GTDatabaseSampler(str(root), sampler_cfg, ["Car"])
    b = JA.GTDatabaseSampler(str(root), sampler_cfg, ["Car"])
    pts = np.fromfile(str(root / "training" / "velodyne" / "000002.bin"),
                      np.float32).reshape(-1, 4)
    # the frame's cars moved 30 m on, clear of the database's (the split's
    # cars stand at the same bearings), so that samples are pasted
    boxes = infos[2]["annos"]["gt_boxes_lidar"] + [30, 0, 0, 0, 0, 0, 0]
    names = infos[2]["annos"]["name"]
    pasted = 0
    for _ in range(3):
        got, ref = a(pts, boxes, names), b(pts, boxes, names)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        pasted += len(got[1]) - len(boxes)
    assert pasted > 0


# --------------------------------------------------------------------------- #
# augmentations with JAX's draws
# --------------------------------------------------------------------------- #

AUGS = {
    "object_scaling": ("random_object_scaling", (0.8, 0.95)),
    "world_flip": ("random_world_flip", ("x", "y")),
    "world_rotation": ("random_world_rotation", (-0.785, 0.785)),
    "world_scaling": ("random_world_scaling", (0.95, 1.05)),
    "world_translation": ("random_world_translation", ((0.5, 0.5, 0.2), ("x", "y", "z"))),
    "local_translation": ("random_local_translation", ((-0.5, 0.5), ("x", "y"))),
    "local_rotation": ("random_local_rotation", (-0.4, 0.4)),
    "local_scaling": ("random_local_scaling", (0.8, 1.2)),
    "world_frustum_dropout": ("random_world_frustum_dropout", ((0.1, 0.3), ("top", "left"))),
    "local_frustum_dropout": ("random_local_frustum_dropout",
                              ((0.2, 0.5), ("top", "bottom", "left", "right"))),
    "local_pyramid": ("random_local_pyramid_aug", (0.3, 0.6, 5, 0.9)),
}


def _frame(seed=0, m=6):
    """800 points, most in clusters about 5 valid boxes of which two
    overlap (so the per-box order matters), a padding box row last."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((m, 7), np.float32)
    boxes[:5] = [[5, 2, -1, 4, 1.8, 1.5, 0.3], [6.5, 2.5, -1, 4, 1.8, 1.5, -0.2],
                 [15, -6, -0.8, 3.9, 1.6, 1.5, 1.2], [25, 8, -0.6, 0.8, 0.6, 1.7, 0.1],
                 [30, -3, -0.6, 1.7, 0.6, 1.7, 2.5]]
    pts = rng.uniform([0, -20, -2.5], [40, 20, 0.5], (800, 3)).astype(np.float32)
    for i in range(5):
        c = boxes[i]
        local = rng.uniform(-0.5, 0.5, (120, 3)) * c[3:6]
        cs, sn = np.cos(c[6]), np.sin(c[6])
        pts[120 * i:120 * i + 120] = local @ np.array([[cs, sn, 0], [-sn, cs, 0],
                                                       [0, 0, 1]]) + c[:3]
    valid = np.arange(800) < 780
    return pts, valid, boxes, np.arange(m) < 5


def _jax_draws(rng, aug_list, m, p):
    """The draws of JAX's augment_frame for each augmentation, made with its
    own key splits (augmentor.py), in the port's ``draw_params`` layout."""
    rngs = jax.random.split(rng, len(aug_list) + 2)
    out = []
    for (name, params), r in zip(aug_list, rngs):
        if name in ("random_object_scaling", "random_local_rotation", "random_local_scaling"):
            if name == "random_object_scaling":
                out.append(jax.random.uniform(r, (m,), minval=params[0], maxval=params[1]))
            else:
                out.append(jnp.stack([jax.random.uniform(k, (), minval=params[0],
                                                         maxval=params[1])
                                      for k in jax.random.split(r, m)]))
        elif name == "random_world_flip":
            out.append([jax.random.bernoulli(k) for k in jax.random.split(r, len(params))])
        elif name in ("random_world_rotation", "random_world_scaling"):
            out.append(jax.random.uniform(r, (), minval=params[0], maxval=params[1]))
        elif name == "random_world_translation":
            out.append(jax.random.normal(r, (3,)))
        elif name == "random_local_translation":
            out.append(jnp.stack([jax.random.uniform(k, (3,), minval=params[0][0],
                                                     maxval=params[0][1])
                                  for k in jax.random.split(r, m)]))
        elif name == "random_world_frustum_dropout":
            out.append(jnp.stack([jax.random.uniform(k, (), minval=params[0][0],
                                                     maxval=params[0][1])
                                  for k in jax.random.split(r, len(params[1]))]))
        elif name == "random_local_frustum_dropout":
            keys = jax.random.split(r, m * len(params[1])).reshape(m, len(params[1]), 2)
            out.append(jnp.stack([jnp.stack([jax.random.uniform(
                keys[i, d], (), minval=params[0][0], maxval=params[0][1])
                for d in range(len(params[1]))]) for i in range(m)]))
        elif name == "random_local_pyramid_aug":
            k = jax.random.split(r, 8)
            out.append({"u_drop": jax.random.uniform(k[0], (m,)),
                        "drop_face": jax.random.randint(k[1], (m,), 0, 6),
                        "u_sparsify": jax.random.uniform(k[2], (m,)),
                        "sparsify_face": jax.random.randint(k[3], (m,), 0, 6),
                        "rank": jax.random.uniform(k[4], (m, p)),
                        "u_swap": jax.random.uniform(k[5], (m,)),
                        "partner": jax.random.permutation(k[6], m),
                        "swap_face": jax.random.randint(k[7], (m,), 0, 6)})
    return out


def _to_port(draws):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), draws)


def _hold(got, ref, name):
    pts, valid, boxes, mask = (to_numpy(t) for t in got)
    np.testing.assert_array_equal(valid, np.asarray(ref[1]), err_msg=f"{name} valid")
    np.testing.assert_array_equal(mask, np.asarray(ref[3]), err_msg=f"{name} gt_mask")
    assert_close(pts, np.asarray(ref[0]), atol=1e-5, name=f"{name} points")
    assert_close(boxes, np.asarray(ref[2]), atol=1e-5, name=f"{name} boxes")


@pytest.mark.parametrize("aug", list(AUGS))
def test_augmentation_matches_jax(aug):
    """Each augmentation alone on one frame for two keys: JAX's jitted
    augment_frame against the port's apply_augmentations fed JAX's draws;
    each key's result moved something."""
    aug_list = (AUGS[aug],)
    pts, valid, boxes, mask = _frame()
    # one compile a case: JAX's augment_frame and its draws in one jitted call
    run = jax.jit(lambda r, *a: (JA.augment_frame(r, *a, aug_list=aug_list),
                                 _jax_draws(r, aug_list, 6, 800)))
    moved = False
    for key in (0, 5):
        ref, draws = run(jax.random.PRNGKey(key), jnp.asarray(pts), jnp.asarray(valid),
                         jnp.asarray(boxes), jnp.asarray(mask))
        got = TA.apply_augmentations(to_torch(pts), to_torch(valid), to_torch(boxes),
                                     to_torch(mask), aug_list, _to_port(draws))
        _hold(got, ref, f"{aug} key {key}")
        moved |= not (np.array_equal(np.asarray(ref[0]), pts)
                      and np.array_equal(np.asarray(ref[1]), valid))
    assert moved


def test_augment_on_device_matches_jax(split):
    """DatasetTemplate.augment_on_device on a collated batch of the split's
    two training frames with kitti_dataset.yaml's device augmentations
    (world flip along x, rotation +-pi/4, scaling 0.95-1.05) and a local
    rotation, each frame fed the draws of JAX's per-frame key: the batch
    equal to JAX's, masked-out ground truth zero rows. The port's own
    ``generators`` run too, on the same shapes."""
    root, _ = split
    aug = {"DISABLE_AUG_LIST": ["placeholder"], "AUG_CONFIG_LIST": [
        {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]},
        {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]},
        {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
        {"NAME": "random_world_frustum_dropout", "INTENSITY_RANGE": [0.0, 0.05],
         "DIRECTION": ["left"]}]}
    cfg = _ds_cfg(root, DATA_AUGMENTOR=aug)
    a = TK.KittiDataset(cfg, ["Car"], True, max_points=2048, max_boxes=8)
    b = JK.KittiDataset(cfg, ["Car"], True, max_points=2048, max_boxes=8)
    keys = ("points", "points_valid", "gt_boxes", "gt_mask")
    batch = {k: np.stack([a[i][k] for i in (0, 1)]) for k in keys}
    rng = jax.random.PRNGKey(3)
    ref = jax.jit(b.augment_on_device)(rng, {k: jnp.asarray(v) for k, v in batch.items()})
    frame_keys = jax.random.split(rng, 2)
    draws = [_to_port(jax.jit(lambda r: _jax_draws(r, a.aug_list, 8, 2048))(k))
             for k in frame_keys]
    got = a.augment_on_device({k: to_torch(v) for k, v in batch.items()}, draws=draws)
    _hold([got[k] for k in keys], [ref[k] for k in keys], "augment_on_device")
    assert (to_numpy(got["gt_boxes"])[~to_numpy(got["gt_mask"])] == 0).all()
    assert (to_numpy(got["points_valid"]) != batch["points_valid"]).any()
    own = a.augment_on_device({k: to_torch(v) for k, v in batch.items()},
                              generators=[torch.Generator().manual_seed(s) for s in (0, 1)])
    assert own["points"].shape == (2, 2048, 3)


# --------------------------------------------------------------------------- #
# loader, eval
# --------------------------------------------------------------------------- #

class _Frames:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError("boom")
        return {"points": np.full((4, 3), i, np.float32), "points_valid": np.ones(4, bool),
                "gt_boxes": np.zeros((2, 8), np.float32), "gt_mask": np.zeros(2, bool)}


@pytest.mark.parametrize("case", ["coverage_and_seed", "worker_error"])
def test_loader_matches_jax(case):
    """BackgroundLoader: the same batches in the same order as JAX's for a
    seed (13 frames in 3 batches of 4, the tail dropped), tensors on the
    given device; a worker's error reaches the consumer."""
    if case == "worker_error":
        with pytest.raises(ValueError, match="boom"):
            list(TL.BackgroundLoader(_Frames(8, fail_at=5), 4, shuffle=False))
        return
    for seed in (0, 5):
        got = list(TL.BackgroundLoader(_Frames(13), 4, seed=seed, num_workers=3))
        ref = list(JL.BackgroundLoader(_Frames(13), 4, seed=seed, num_workers=3))
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            _item_equal(g, r)
        seen = np.concatenate([g["points"][:, 0, 0] for g in got]).astype(int)
        assert len(set(seen.tolist())) == 12
    on_dev = next(iter(TL.BackgroundLoader(_Frames(8), 4, seed=0, device="cpu")))
    first = next(iter(JL.BackgroundLoader(_Frames(8), 4, seed=0)))
    for k, v in first.items():
        assert isinstance(on_dev[k], torch.Tensor)
        np.testing.assert_array_equal(on_dev[k].numpy(), v)


def test_official_eval_matches_jax():
    """get_official_eval_result on tests/test_kitti_eval.py's frames (some
    missed, some false positives, AOS on): the report and the AP dict
    equal."""
    from test_kitti_eval import _make_frames

    for kw in ({}, {"miss_every": 3}):
        gt, dt = _make_frames(8, **kw)
        got = TE.get_official_eval_result(gt, dt, ("Car", "Pedestrian"), device="cpu")
        ref = JE.get_official_eval_result(gt, dt, ("Car", "Pedestrian"))
        assert got[0] == ref[0]
        assert got[1] == ref[1]


def test_eval_one_epoch_matches_jax(split):
    """eval_one_epoch of a tiny SECOND-IoU (seeded weights, the JAX model's
    through its importer) over the split's 3 frames at batch 2 (the tail
    padded): the same AP dict and recall counts as JAX's eval_one_epoch.
    With random weights this is the path's check, not the model's: the
    APs are near 0."""
    from chip_smoke import seeded_state_dict
    from seevcn_tpu.models.detectors.second import build_detector as jax_build
    from seevcn_tpu.train.eval import eval_one_epoch as jax_eval
    from seevcn_tpu.utils.ckpt_compat import detector_variables_from_torch
    from seevcn_torch.models.detectors import configs as DC
    from seevcn_torch.models.detectors.second import build_detector
    from seevcn_torch.train.eval import eval_one_epoch

    root, _ = split
    det_cfg = DC.tiny_detector_cfg()
    det_cfg.MODEL.POST_PROCESSING.SCORE_THRESH = 0.0
    sd = seeded_state_dict(0, build_detector(det_cfg, device="cpu")[0], random_stats=True)
    model, _ = build_detector(det_cfg, sd, device="cpu")
    variables = jax.tree.map(jnp.asarray, detector_variables_from_torch(sd, "SECONDNetIoU"))
    ds_cfg = _ds_cfg(root)
    logs = []
    got = eval_one_epoch(model, det_cfg, TK.KittiDataset(ds_cfg, ["Car"], False,
                                                         max_points=1024, max_boxes=8),
                         batch_size=2, logger=logs.append)
    ref = jax_eval(jax_build(det_cfg)[0], det_cfg, variables,
                   JK.KittiDataset(ds_cfg, ["Car"], False, max_points=1024, max_boxes=8),
                   batch_size=2, logger=lambda s: None)
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    # 3 cars a frame; the padded tail repeats frame 2, counted twice, as JAX's
    assert got[2]["num_gt"] == 12 and "Car AP_R40" in got[0]
    assert logs[0].startswith("eval: 3 frames")
