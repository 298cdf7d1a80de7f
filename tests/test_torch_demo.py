"""The port's demo (seevcn_torch.cli.demo, data.demo_dataset, run_see's demo
branch) against the JAX package's on the CPU.

Data: a demo tree from ``chip_smoke.write_demo_tree`` (one frame of
``make_scene``'s cloud at 6,000 points with four occluded cars, a JSON
calibration with the camera at the lidar, the committed 720 x 1260 JPEG
fixture as the front image, the hull of each car's projected points as its
COCO mask), VCN_VC at seeded weights and SECOND-IoU at seeded weights with
random statistics, both as the reference's ``.pth``. Both demos run the
detector at ``_tiny_detector_cfg`` (their ``_mini_detector_cfg`` patched)
to keep to one small JAX compile.

Tolerances: the adapter's projections, instances and image shapes equal
JAX's exactly (JAX reads the JPEG with cv2, the port its frame header),
also for a front image with an EXIF thumbnail, an arithmetic-coded one
and one cv2 cannot read. The
replaced frame is held with the SEE workflow's row bounds: the same
instances, completed row counts within SEE_ROW_SLACK, at most
SEE_ROW_SHARE of the rows farther than SEE_ROW_TOL m from the other
side's, the kept scan points equal but for points within 1e-5 r^2 of r^2.
The boxes and scores, on the same detector input, agree at f32 tolerance
(1e-4 m, 1e-5). run_see's demo branch writes the port demo's frame.
"""
import contextlib
import copy
import io
import os
import shutil

import cv2
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__ as G
from chip_smoke import (SEE_ROW_SHARE, SEE_ROW_SLACK, SEE_ROW_TOL, rows_apart,
                        seeded_state_dict, seeded_vcn_state_dict, write_demo_tree)
from seevcn_torch.cli import demo as TDEMO
from seevcn_torch import testing_jpeg as E
from seevcn_torch.cli import run_see as RS
from seevcn_torch.data.demo_dataset import DemoObjects
from seevcn_torch.data.kitti.bootstrap import read_image_shape
from seevcn_torch.geom.pcd_io import read_pcd
from seevcn_torch.models.detectors import configs as DC
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.ops.cuda.min_dist import min_sqdist_plain
from seevcn_torch.utils.ckpt import save_detector_checkpoint
from seevcn_tpu.cli import demo as JDEMO
from seevcn_tpu.cli import run_see as JRS
from seevcn_tpu.data.demo_dataset import DemoObjects as JDemoObjects

RADIUS = 0.1


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo")
    write_demo_tree(str(root), n_frames=1, seed=4, n_points=6000, n_cars=4)
    torch.save({"base_model": seeded_vcn_state_dict(0)}, root / "vcn.pth")
    model, _ = build_detector(DC.tiny_detector_cfg(), device="cpu")
    save_detector_checkpoint(str(root / "det.pth"), seeded_state_dict(0, model,
                                                                       random_stats=True))
    return root


@pytest.fixture(scope="module")
def demos(tree):
    """Each package's demo on the tree: (its return or what JAX's plots were
    handed, its printed lines)."""
    mp = pytest.MonkeyPatch()
    jax_tiny, port_tiny = G._tiny_detector_cfg(), DC.tiny_detector_cfg()
    mp.setattr(G, "_mini_detector_cfg", lambda: copy.deepcopy(jax_tiny))
    mp.setattr(DC, "mini_detector_cfg", lambda: copy.deepcopy(port_tiny))
    seen = {}

    def capture_bev(path, points, boxes=None, scores=None, gt_boxes=None, completed=None):
        seen.update(frame_points=points, boxes=boxes, scores=scores, completed_pts=completed)
        return path

    from seevcn_tpu.utils import viz as JV

    mp.setattr(JV, "save_bev", capture_bev)
    args = ["--root", str(tree), "--masks", f"front={tree / 'masks' / 'front.json'}",
            "--vcn_ckpt", str(tree / "vcn.pth"), "--det_ckpt", str(tree / "det.pth")]
    out = {}
    try:
        for name, run, extra in (("port", TDEMO.main, ["--device", "cpu"]),
                                 ("jax", JDEMO.main, [])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                got = run(args + ["--out", str(tree / f"out_{name}")] + extra)
            out[name] = (got if got is not None else dict(seen), buf.getvalue().splitlines())
    finally:
        mp.undo()
    return out


def test_map_pointcloud_to_image_matches_jax(tree):
    masks = {"front": str(tree / "masks" / "front.json")}
    t, j = DemoObjects(str(tree), masks=masks), JDemoObjects(str(tree), masks=masks)
    assert t.frames == j.frames == ["000000"] and len(t) == len(j) == 1
    assert t.get_image_shape(0) == tuple(j.get_image_shape(0)) == (720, 1260)
    assert DemoObjects(str(tree)).get_image_shape(0, "back") == (720, 1260)
    tm, jm = t.map_pointcloud_to_image(0), j.map_pointcloud_to_image(0)
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jm[k]), err_msg=k)
    assert 1000 < tm["fov_inds"].sum() < len(tm["fov_inds"])
    assert t.get_camera_instances(0) == j.get_camera_instances(0)
    assert len(t.get_camera_instances(0)) == 4
    np.testing.assert_array_equal(t.get_pointcloud(0), j.get_pointcloud(0))
    assert t.get_save_fname(0) == j.get_save_fname(0)


def _front_image(case: str) -> bytes:
    img = E.picture(90, 160, 5)
    if case == "thumbnail":   # an EXIF APP1 holding a 16 x 9 JPEG ahead of the frame
        thumb = cv2.imencode(".jpg", cv2.resize(img, (16, 9)))[1].tobytes()
        return E.with_segment(cv2.imencode(".jpg", img)[1].tobytes(),
                              E.exif_app1(1, thumbnail=thumb))
    if case == "arithmetic":
        comps, tables = E.blocks_from_image(img, ((2, 2), (1, 1), (1, 1)))
        return E.encode_arithmetic(comps, tables, 160, 90)
    return b"not an image " * 100


@pytest.mark.parametrize("case", ["thumbnail", "arithmetic", "garbage"])
def test_image_shape_is_cv2s(tree, tmp_path, case):
    """The image shape the demo crops its projection to is the array
    cv2.imread gives (JAX's get_image_shape): the frame header after an
    EXIF thumbnail's (where kitti/bootstrap's byte scan, JAX's own quirk,
    finds the thumbnail's 9 x 16), an arithmetic-coded file's, and the
    default shape for a file cv2 cannot read."""
    root = tmp_path / "demo"
    for sub in ("pcd", "calib"):
        shutil.copytree(tree / sub, root / sub)
    path = root / "image" / "front" / "000000.jpg"
    path.parent.mkdir(parents=True)
    path.write_bytes(_front_image(case))
    t, j = DemoObjects(str(root)), JDemoObjects(str(root))
    want = {"thumbnail": (90, 160), "arithmetic": (90, 160), "garbage": (720, 1260)}[case]
    assert t.get_image_shape(0) == tuple(j.get_image_shape(0)) == want
    if case == "thumbnail":
        assert read_image_shape(str(path)).tolist() == [9, 16]
    tm, jm = t.map_pointcloud_to_image(0), j.map_pointcloud_to_image(0)
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jm[k]), err_msg=k)


def _kept_apart(points, frame_t, n_t, frame_j, n_j):
    """Kept scan rows on one side only, but for points within 1e-5 r^2 of
    r^2 of either completed cloud (a tie of the replacement)."""
    kept_t, kept_j = ({tuple(r) for r in f[n:]} for f, n in ((frame_t, n_t), (frame_j, n_j)))
    ties = set()
    for done in (frame_t[:n_t], frame_j[:n_j]):
        d = min_sqdist_plain(torch.from_numpy(points[:, :3].copy()), torch.from_numpy(done))
        tie = ((d - RADIUS ** 2).abs() <= 1e-5 * RADIUS ** 2).numpy()
        ties |= {tuple(r) for r in points[tie, :3]}
    return len((kept_t ^ kept_j) - ties)


def test_demo_matches_jax(tree, demos):
    (t, t_lines), (j, j_lines) = demos["port"], demos["jax"]
    # the printed counts
    counts = [ln for ln in t_lines if ln.startswith(("completed", "detected"))]
    assert counts == [ln for ln in j_lines if ln.startswith(("completed", "detected"))]
    assert len(counts) == 2 and t["instances"] == 4
    assert t["rows_cut"] == 0 and not any("row input dropped" in ln for ln in t_lines)
    # the replaced frame, within the SEE workflow's row bounds
    n_t, n_j = len(t["completed_pts"]), len(j["completed_pts"])
    assert abs(n_t - n_j) <= SEE_ROW_SLACK and n_t > 100
    apart = rows_apart(t["completed_pts"], np.asarray(j["completed_pts"], np.float32), "cpu")
    assert (apart > SEE_ROW_TOL).mean() <= SEE_ROW_SHARE
    points = read_pcd(str(tree / "pcd" / "000000.pcd"))
    ft, fj = t["frame_points"], np.asarray(j["frame_points"])
    assert ft.dtype == fj.dtype == np.float32
    assert _kept_apart(points, ft, n_t, fj, n_j) == 0
    assert t["dropped"] == len(points) - (len(ft) - n_t) > 25
    # the detections on the same detector input, at f32 tolerance
    if n_t == n_j and apart.max() <= SEE_ROW_TOL:
        assert t["boxes"].shape == j["boxes"].shape and t["boxes"].dtype == j["boxes"].dtype
        np.testing.assert_allclose(t["boxes"], j["boxes"], atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(t["scores"], j["scores"], atol=1e-5)
    assert len(t["boxes"]) >= 1 and (t["scores"] > 0.3).all()
    # the files: an RGB PNG of the JAX figure's size and the HTML viewer
    from seevcn_torch.data.png import read_png

    assert read_png(t["png"]).shape == (1500, 1500, 3)
    assert os.path.getsize(t["html"]) > 1000


def test_demo_reports_the_rows_its_pad_cuts(tree, monkeypatch, capsys):
    """A frame longer than the detector's pad loses its last rows, as JAX's
    demo does, and the port says how many (no masks: the raw cloud)."""
    tiny = DC.tiny_detector_cfg()
    monkeypatch.setattr(DC, "mini_detector_cfg", lambda: copy.deepcopy(tiny))
    monkeypatch.setattr(TDEMO, "DET_ROWS", 5000)
    got = TDEMO.main(["--root", str(tree), "--det_ckpt", str(tree / "det.pth"),
                      "--out", str(tree / "out_cut"), "--device", "cpu"])
    n = len(read_pcd(str(tree / "pcd" / "000000.pcd")))
    assert got["completed_pts"] is None and got["rows_cut"] == n - 5000 > 0
    assert f"dropped the frame's last {n - 5000} points" in capsys.readouterr().out


def test_run_see_demo_branch_matches_jax(tree, demos, tmp_path):
    """build_data_obj's demo adapter equals JAX's; run_see's DET path on the
    demo tree at the demo's SEE settings writes the port demo's frame."""
    cfg = {"DATA": {"DATASET": "demo", "ROOT": str(tree),
                    "MASKS": {"front": str(tree / "masks" / "front.json")}},
           "PC_ISOLATION": {"MIN_LIDAR_PTS": 30, "EPS_SCALING": 4.0, "MIN_EPS": 0.3,
                            "MAX_EPS": 1.0},
           "SURFACE_COMPLETION": {"VRES": 0.4, "VCN": {
               "MODEL": "VCN_VC", "CKPT_PATH": str(tree / "vcn.pth"), "NORM_WITH_GT": False,
               "SEL_K_NEAREST": 30, "CLUSTER_EPS": 0.4, "BATCH_SIZE_LIMIT": 32}}}
    with open(tmp_path / "see.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    from seevcn_torch.utils.config import cfg_from_yaml_file

    c = cfg_from_yaml_file(str(tmp_path / "see.yaml"))
    t, j = RS.build_data_obj(c), JRS.build_data_obj(c)
    assert isinstance(t, DemoObjects) and t.camera_channels == j.camera_channels == ["front"]
    for k, v in t.map_pointcloud_to_image(0).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(j.map_pointcloud_to_image(0)[k]))
    out = RS.main(["--cfg_file", str(tmp_path / "see.yaml"), "--device", "cpu",
                   "--save_dir", str(tmp_path / "frames")])
    rec = out["frames"][0]
    assert rec["isolated"] == 4 and out["infos"] is None
    np.testing.assert_array_equal(read_pcd(rec["path"]), demos["port"][0]["frame_points"])
