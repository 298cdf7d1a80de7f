"""The port's KITTI bootstrap (seevcn_torch.data.kitti.bootstrap) and its
CLI (seevcn_torch.cli.create_infos) against the JAX package on the CPU.

Data: a raw KITTI tree from ``chip_smoke.write_kitti_split(labels=True)``
(make_scene's clouds, KITTI's calibration, the port's PNGs, label_2 files
and ImageSets), copied once for each package, since the GT database is
written inside the tree. Tolerances: none against JAX; the infos and
dbinfos pkls are deep-equal (values, dtypes and shapes) and the database's
.bin files byte-equal. Against the writer's own annos, the boxes parsed back
from the label text to 1e-5 m and num_points_in_gt within
``chip_smoke.NUM_POINTS_SLACK``.
"""
import os
import pickle
import shutil

import numpy as np
import pytest

from chip_smoke import NUM_POINTS_SLACK, write_kitti_split
from seevcn_tpu.data.kitti import bootstrap as JB
from seevcn_torch.cli import create_infos as CLI
from seevcn_torch.data.kitti import bootstrap as TB


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("raw")
    infos = write_kitti_split(str(base / "src"), 3, seed=2, n_points=6000, n_cars=3,
                              labels=True)
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl", "kitti_dbinfos_train.pkl"):
        os.remove(base / "src" / name)
    shutil.rmtree(base / "src" / "gt_database")
    for who in ("jax", "port", "cli"):
        shutil.copytree(base / "src", base / who)
    return base, infos


def _deep_equal(a, b, where="root"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _deep_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _deep_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_label_parsing_and_image_shape_match_jax(trees):
    base, _ = trees
    label = str(base / "src" / "training" / "label_2" / "000001.txt")
    _deep_equal(TB.parse_label_file(label), JB.parse_label_file(label))
    for h, t, o in ((50, 0.1, 0), (30, 0.2, 1), (30, 0.45, 2), (20, 0.0, 0), (45, 0.6, 0)):
        box = [0, 10, 5, 10 + h - 1]
        assert TB.kitti_obj_level(box, t, o) == JB.kitti_obj_level(box, t, o)
    png = str(base / "src" / "training" / "image_2" / "000000.png")
    np.testing.assert_array_equal(TB.read_image_shape(png), JB.read_image_shape(png))
    assert TB.read_image_shape(png).tolist() == [375, 1242]
    jpg = base / "tiny.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + b"\x00" * 7
                    + b"\xff\xc0\x00\x11\x08\x01\x77\x04\xda\x03" + b"\x00" * 12)
    np.testing.assert_array_equal(TB.read_image_shape(str(jpg)), JB.read_image_shape(str(jpg)))


def test_geometry_matches_jax(trees):
    base, infos = trees
    rng = np.random.RandomState(3)
    pts = rng.uniform(-20, 40, (4000, 3)).astype(np.float32)
    boxes = infos[0]["annos"]["gt_boxes_lidar"].astype(np.float32)
    np.testing.assert_array_equal(TB.points_in_rotated_boxes_np(pts, boxes),
                                  JB.points_in_rotated_boxes_np(pts, boxes))
    calib = str(base / "src" / "training" / "calib" / "000000.txt")
    from seevcn_tpu.geom.calibration import KittiCalibration as JC
    from seevcn_torch.geom.calibration import KittiCalibration as TC

    np.testing.assert_array_equal(TB.fov_point_flag(pts, TC(calib), (375, 1242)),
                                  JB.fov_point_flag(pts, JC(calib), (375, 1242)))


def test_infos_and_gt_database_match_jax(trees):
    base, infos = trees
    got = TB.create_kitti_infos(str(base / "port"), with_test=False, num_workers=2,
                                logger=lambda *a: None)
    ref = JB.create_kitti_infos(str(base / "jax"), with_test=False, num_workers=2,
                                logger=lambda *a: None)
    assert sorted(got) == sorted(ref) == ["train", "trainval", "val"]
    for split in got:
        _deep_equal(_load(got[split]), _load(ref[split]), split)
    # the labels came from the writer's annos: the same boxes, to their text's
    # 9 digits, and counts but for points on a face (chip_smoke.NUM_POINTS_SLACK)
    for a, b in zip(_load(got["train"]), infos):
        np.testing.assert_allclose(a["annos"]["gt_boxes_lidar"], b["annos"]["gt_boxes_lidar"],
                                   atol=1e-5)
        assert np.abs(a["annos"]["num_points_in_gt"]
                      - b["annos"]["num_points_in_gt"]).max() <= NUM_POINTS_SLACK
    tdb = TB.create_groundtruth_database(str(base / "port"), info_path=got["train"],
                                         logger=lambda *a: None)
    jdb = JB.create_groundtruth_database(str(base / "jax"), info_path=ref["train"],
                                         logger=lambda *a: None)
    _deep_equal(_load(tdb), _load(jdb), "dbinfos")
    names = sorted(os.listdir(base / "port" / "gt_database"))
    assert names == sorted(os.listdir(base / "jax" / "gt_database")) and len(names) == 9
    for name in names:
        assert (base / "port" / "gt_database" / name).read_bytes() == \
            (base / "jax" / "gt_database" / name).read_bytes(), name


def test_create_infos_cli_kitti_branch(trees):
    base, _ = trees
    root = str(base / "cli")
    paths = CLI.main(["--dataset", "kitti", "--root", root, "--workers", "2",
                      "--classes", "Car"])
    assert sorted(paths) == ["dbinfos", "train", "trainval", "val"]
    _deep_equal(_load(paths["train"]), JB.get_infos(root, "train", num_workers=1), "cli")
    db = _load(paths["dbinfos"])
    assert list(db) == ["Car"] and len(db["Car"]) == 9
    assert len(os.listdir(os.path.join(root, "gt_database"))) == 9


@pytest.mark.parametrize("dataset", ["nuscenes", "lyft", "waymo"])
def test_create_infos_cli_other_datasets_raise(tmp_path, dataset):
    """The other datasets' branches on a root without their tree raise as
    the JAX package's do (their outputs: test_torch_domain_cli.py)."""
    from seevcn_tpu.cli.create_infos import main as jax_main

    for main in (CLI.main, jax_main):
        with pytest.raises(FileNotFoundError):
            main(["--dataset", dataset, "--root", str(tmp_path)])
