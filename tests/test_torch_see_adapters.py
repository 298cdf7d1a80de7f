"""The port's SEE adapters for nuScenes, Waymo and Baraja
(seevcn_torch.data.see_adapters) and run_see on them
(seevcn_torch.cli.run_see) against the JAX package on the CPU.

Data: the JAX package's own SEE trees (``test_see_adapters.
_make_nuscenes_see_tree``: two samples, CAM_FRONT, a car blob each;
``_make_waymo_see_tree``: precomputed FRONT projections;
``_make_baraja_tree``: json calibration, equidistant fisheye or pinhole),
each written once and copied so that each package writes its own outputs;
VCN_VC at seeded weights (``chip_smoke.seeded_vcn_state_dict(0)``) in a
reference ``.pth``. The merge case is ``chip_smoke.write_nuscenes_tree`` at
a small size: one sample of 4 cars seen by CAM_FRONT and CAM_FRONT_LEFT, the
outer car across both, with VCN_VC at 128 points (seeded weights).

JAX's SEEVCN runs the TPU's within-radius route (the pruned Pallas kernel
in interpret mode), as in test_torch_see_pipeline.py, so that a scan point
at the 0.1 m radius falls on the same side in both.

Tolerances: the adapters' clouds, projections (pixels, fov_inds) and
instances exactly (host numpy, f64 chains cast to f32 at the end); the
completed clouds with test_torch_see_pipeline.py's bounds (the completed
rows as sorted row sets within 1e-3 m, the kept scan points exactly), but
for a near tie: where the completed rows differ, the port's completion of
the same instances in f64 (``chip_smoke.completed_f64``) must hold one
side's rows, and the two sides at most 2 rows apart. That happens on the
Baraja GT frame 1: the port's f32 k-NN union picks one row (0.17 m from
the rest) that JAX's f32 and the port's f64 leave out. update_infos' pkls
equal but for the completed point counts of such a frame.
"""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import NUS_CAMERAS, completed_f64, seeded_vcn_state_dict, write_nuscenes_tree
from seevcn_tpu.cli import run_see as JRS
from seevcn_tpu.data import see_adapters as JA
from seevcn_tpu.see import pipeline as JP
from seevcn_tpu.utils.config import Cfg as JCfg
from seevcn_torch.cli import run_see as TRS
from seevcn_torch.data import see_adapters as TA
from seevcn_torch.geom.pcd_io import read_pcd
from seevcn_torch.see import pipeline as TP
from seevcn_torch.utils.config import Cfg
from test_see_adapters import _make_baraja_tree, _make_nuscenes_see_tree, _make_waymo_see_tree
from test_torch_kitti_bootstrap import _deep_equal
from test_torch_see_pipeline import _pallas_within_radius, _same_frame, _same_rows

SEE = {"PC_ISOLATION": {"MIN_LIDAR_PTS": 30, "EPS_SCALING": 4.0, "MIN_EPS": 0.3, "MAX_EPS": 1.0},
       "SURFACE_COMPLETION": {"VRES": 0.4}}


@pytest.fixture(scope="module", autouse=True)
def pallas_route():
    mp = pytest.MonkeyPatch()
    mp.setattr(JP, "within_radius_mask", _pallas_within_radius)
    yield
    mp.undo()


def _data_block(domain: str, root, tag: str) -> dict:
    if domain == "nuscenes":
        return {"DATASET": "nuscenes", "DATA_DIR": str(root), "VERSION": "v1.0-mini",
                "CAMERA_CHANNELS": ["CAM_FRONT"], "CLASSES": ["car"], "LIDAR_NSWEEPS": 2,
                "TAG": tag, "SPLIT": "train",
                "INFO_PATHS": {"train": "nuscenes_infos_train.pkl"}}
    if domain == "waymo":
        return {"DATASET": "waymo", "DATA_DIR": str(root), "CAMERA_CHANNELS": ["FRONT"],
                "CLASSES": ["Car"], "TAG": tag, "SPLIT": "train", "SAMPLED_INTERVAL": 1}
    return {"DATASET": "custom", "DATA_DIR": str(root), "SPLIT": "test",
            "CAMERA_CHANNELS": ["front"], "CLASSES": ["Car"], "TAG": tag,
            "CAMERA_MODEL": "equidistant" if domain == "custom" else "pinhole"}


WRITERS = {"nuscenes": (_make_nuscenes_see_tree, 0), "waymo": (_make_waymo_see_tree, 1),
           "custom": (_make_baraja_tree, 2), "custom_pinhole": (_make_baraja_tree, 2)}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """-> {domain: (the port's root, JAX's root)}: each SEE tree written
    once and copied."""
    out = {}
    for domain, (write, seed) in WRITERS.items():
        base = tmp_path_factory.mktemp(domain)
        kw = {"model": "pinhole"} if domain == "custom_pinhole" else {}
        write(base / "j", np.random.RandomState(seed), **kw)
        shutil.copytree(base / "j", base / "t")
        out[domain] = (base / "t", base / "j")
    return out


@pytest.fixture(scope="module")
def vcn_pth(tmp_path_factory):
    path = tmp_path_factory.mktemp("vcn") / "VCN_VC.pth"
    torch.save({"base_model": seeded_vcn_state_dict(0)}, path)
    return path


def _adapters(domain, root, tag="T"):
    block = _data_block(domain, root, tag)
    name = block["DATASET"]
    return TA.SEE_ADAPTERS[name](Cfg(block)), JA.SEE_ADAPTERS[name](JCfg(block))


@pytest.mark.parametrize("domain", list(WRITERS))
def test_adapters_match_jax(trees, domain):
    t, j = _adapters(domain, trees[domain][0])
    assert len(t) == len(j) == 2 and t.frames == j.frames
    cam = t.camera_channels[0]
    for i in range(2):
        np.testing.assert_array_equal(t.get_pointcloud(i), j.get_pointcloud(i))
        if domain == "nuscenes":
            for nsweeps in (1, 2):
                got = t.get_pointcloud(i, nsweeps=nsweeps)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, j.get_pointcloud(i, nsweeps=nsweeps))
        else:
            np.testing.assert_array_equal(t.get_gt_boxes(i), j.get_gt_boxes(i))
        got, ref = t.map_pointcloud_to_image(i, cam), j.map_pointcloud_to_image(i, cam)
        assert list(got) == list(ref) and got["img_shape"] == ref["img_shape"]
        for k in ("pc_lidar", "pc_cam", "pts_img", "fov_inds"):
            if ref[k] is None:
                assert got[k] is None
            else:
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got["fov_inds"].sum() > 100
        assert t.get_camera_instances(i, cam) == j.get_camera_instances(i, cam)
        assert len(t.get_camera_instances(i, cam)) == 1
        assert t.get_save_fname(i) == j.get_save_fname(i)
        _deep_equal(t.get_infos(i), j.get_infos(i))
    if domain == "waymo":
        np.testing.assert_array_equal(t.get_pointcloud(0, disable_nlz_flag=True),
                                      j.get_pointcloud(0, disable_nlz_flag=True))
    if domain == "nuscenes":                       # the port's GT crop boxes: the infos'
        np.testing.assert_array_equal(t.get_gt_boxes(1), t.get_infos(1)["gt_boxes"])
        assert not hasattr(j, "get_gt_boxes")


def _see_yaml(root, domain, tag, vcn_pth) -> str:
    cfg = {"DATA": _data_block(domain, root, tag), **SEE,
           "SURFACE_COMPLETION": {"VRES": 0.4, "VCN": {
               "MODEL": "VCN_VC", "CKPT_PATH": str(vcn_pth), "NORM_WITH_GT": False,
               "SEL_K_NEAREST": 30, "CLUSTER_EPS": 0.4, "BATCH_SIZE_LIMIT": 8}}}
    path = os.path.join(str(root), f"see_{tag}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _outputs(domain, root, tag):
    """-> ({frame name: completed cloud}, {updated pkl name: infos})."""
    if domain == "nuscenes":
        pcds = os.path.join(root, "samples", f"vcn_{tag}")
        pkls = {"nus": os.path.join(root, f"infos_{tag}", "nuscenes_infos_train.pkl")}
    elif domain == "waymo":
        pcds = os.path.join(root, f"vcn_{tag}", "segment-777")
        pkls = {"seq": os.path.join(pcds, "segment-777.pkl"),
                "all": os.path.join(root, f"infos_{tag}", "waymo_infos_train.pkl")}
    else:
        pcds = os.path.join(root, "test", f"vcn_{tag}")
        pkls = {"baraja": os.path.join(root, f"infos_{tag}", "baraja_infos_test.pkl")}
    clouds = {n: read_pcd(os.path.join(pcds, n)) for n in sorted(os.listdir(pcds))
              if n.endswith(".pcd")}
    infos = {k: pickle.load(open(p, "rb")) for k, p in pkls.items()}
    return clouds, infos


def _same_rows_bool(a, b, atol=1e-3) -> bool:
    try:
        _same_rows(a, b, atol)
    except AssertionError:
        return False
    return True


def _same_completed_frame(see, idx: int, path: str, got, ref, dropped: int) -> bool:
    """A frame of the port's run_see against JAX's: the kept scan points
    exactly, the completed rows as row sets within 1e-3 m, or at a near tie
    (the port's f64 completion of the frame's instances holds one side's
    rows; at most 2 rows apart). -> whether the rows were a near tie."""
    n_scan = len(see.data_obj.get_pointcloud(idx))
    n_t = len(got) - (n_scan - dropped)
    n_j = len(ref) - (n_scan - dropped)
    assert n_t > 0 and n_j > 0 and got.dtype == ref.dtype
    np.testing.assert_array_equal(got[n_t:], ref[n_j:])
    if n_t == n_j and _same_rows_bool(got[:n_t], ref[:n_j]):
        return False
    if path == "gt":
        inst, labels = see.isolate_gt_pts(see.data_obj.get_pointcloud(idx),
                                          see.data_obj.get_gt_boxes(idx))
    else:
        inst, labels = see.isolate_det_pts(see.get_det_instances(idx)), None
        inst = [x for x in inst if x.shape[0] > see.min_lidar_pts]
    witness = completed_f64(see, inst, labels)
    assert abs(n_t - n_j) <= 2
    assert _same_rows_bool(witness, got[:n_t]) or _same_rows_bool(witness, ref[:n_j])
    return True


@pytest.mark.parametrize("domain,path", [("nuscenes", "det"), ("nuscenes", "gt"),
                                         ("waymo", "det"), ("waymo", "gt"),
                                         ("custom", "det"), ("custom", "gt")])
def test_run_see_matches_jax(trees, vcn_pth, domain, path):
    """run_see on the CPU against JAX's run_see: the completed .pcds and
    update_infos' pkls. nuScenes' DET run goes through 2 worker threads.
    JAX's nuScenes adapter has no GT boxes, so its --path gt raises; the
    port's GT frames are held against JAX's SEEVCN on the same boxes."""
    troot, jroot = trees[domain]
    tag = f"{path}cli"
    extra = ["--workers", "2"] if (domain, path) == ("nuscenes", "det") else []
    got = TRS.main(["--cfg_file", _see_yaml(troot, domain, tag, vcn_pth), "--path", path,
                    "--device", "cpu"] + extra)
    assert sorted(got["frames"]) == [0, 1]
    t_clouds, t_infos = _outputs(domain, str(troot), tag)
    cfg_t = Cfg(yaml.safe_load(open(_see_yaml(troot, domain, tag, vcn_pth))))
    t_obj = TA.SEE_ADAPTERS[cfg_t.DATA.DATASET](cfg_t.DATA)
    tsee = TP.SEEVCN(cfg_t, data_obj=t_obj, device="cpu")
    if (domain, path) == ("nuscenes", "gt"):
        with pytest.raises(AttributeError, match="get_gt_boxes"):
            JRS.main(["--cfg_file", _see_yaml(jroot, domain, tag, vcn_pth), "--path", path])
        jsee = JP.SEEVCN(JCfg(yaml.safe_load(open(_see_yaml(jroot, domain, tag, vcn_pth)))))
        refs = [jsee.process_gt_frame(t_obj.get_pointcloud(i), t_obj.get_gt_boxes(i))
                for i in range(2)]
        assert len(t_clouds) == 2
        for i, (name, cloud) in enumerate(sorted(t_clouds.items())):
            rec = got["frames"][i]
            assert not _same_completed_frame(tsee, i, path, cloud, refs[i], rec["dropped"])
            assert rec["completed"] == 1 and rec["dropped"] > 0
        return
    JRS.main(["--cfg_file", _see_yaml(jroot, domain, tag, vcn_pth), "--path", path])
    j_clouds, j_infos = _outputs(domain, str(jroot), tag)
    assert sorted(t_clouds) == sorted(j_clouds) and len(t_clouds) == 2
    ties = []
    for i, name in enumerate(sorted(t_clouds)):
        rec = got["frames"][i]
        assert rec["completed"] == 1 and rec["dropped"] > 0
        if _same_completed_frame(tsee, i, path, t_clouds[name], j_clouds[name], rec["dropped"]):
            ties.append(i)
    assert ties == ([1] if (domain, path) == ("custom", "gt") else [])
    if domain == "nuscenes" and ties:              # the completed point counts move
        for a, b in zip(t_infos["nus"], j_infos["nus"]):
            a.pop("num_completed_lidar_pts"), b.pop("num_completed_lidar_pts")
    _deep_equal(t_infos, j_infos)
    main_pkl = {"nuscenes": "nuscenes_infos_train.pkl", "waymo": "waymo_infos_train.pkl",
                "custom": "baraja_infos_test.pkl"}[domain]
    assert got["infos"] == os.path.join(str(troot), f"infos_{tag}", main_pkl)


@pytest.fixture(scope="module")
def small_vcns(tmp_path_factory):
    """(JAX's VCN_VC, the port's) at 128 points, seeded weights through a
    reference .pth."""
    from seevcn_tpu.models.vcn.inference import VCNInference as JVCN
    from seevcn_tpu.utils.ckpt_compat import load_vcn_checkpoint
    from seevcn_torch.models.vcn.inference import VCNInference as TVCN

    sd = seeded_vcn_state_dict(1, num_coarse=128)
    path = tmp_path_factory.mktemp("vcn128") / "VCN_VC.pth"
    torch.save({"base_model": sd}, path)
    return (JVCN("VCN_VC", load_vcn_checkpoint(str(path), "VCN_VC"), norm_with_gt=False,
                 batch_size=4, num_points=128),
            TVCN("VCN_VC", sd, num_points=128, batch_size=4, device="cpu"))


def test_multi_camera_merge_matches_jax(tmp_path, small_vcns):
    """A car on the edge of CAM_FRONT and CAM_FRONT_LEFT is isolated in
    both; the merge joins the two (K1 on the card, a pair tested each), and
    the frame equals JAX's."""
    write_nuscenes_tree(str(tmp_path), 1, seed=5, n_points=3000, n_cars=4,
                        cameras=[c for c in NUS_CAMERAS if c[0] in ("CAM_FRONT",
                                                                     "CAM_FRONT_LEFT")])
    block = {"DATA_DIR": str(tmp_path), "VERSION": "v1.0-trainval", "CLASSES": ["car"],
             "CAMERA_CHANNELS": ["CAM_FRONT", "CAM_FRONT_LEFT"], "LIDAR_NSWEEPS": 2,
             "SHRINK_MASK_PERCENTAGE": 3.0, "TAG": "m"}
    t = TP.SEEVCN(SEE, data_obj=TA.NuscenesObjects(Cfg(block)), device="cpu")
    j = JP.SEEVCN(SEE, data_obj=JA.NuscenesObjects(JCfg(block)))
    j.vcn, t.vcn = small_vcns
    tproj, jproj = t.get_det_instances(0), j.get_det_instances(0)
    assert [len(p["lidar_xyz"]) for p in tproj] == [len(p["lidar_xyz"]) for p in jproj]
    assert len(tproj[1]["lidar_xyz"]) >= 1                 # CAM_FRONT_LEFT sees a car
    tinst, jinst = t.isolate_det_pts(tproj), j.isolate_det_pts(jproj)
    for a, b in zip(tinst, jinst):
        np.testing.assert_array_equal(a, b)
    merged_t, merged_j = (s.merge_multi_camera_detections(tinst) for s in (t, j))
    assert len(merged_t) == len(merged_j) < len(tinst)
    for a, b in zip(merged_t, merged_j):
        np.testing.assert_array_equal(a, b)
    assert t.last_stats["merged"] >= 1 and t.last_stats["merge_checks"] >= 1
    got, ref = t.process_det_frame(0), j.process_det_frame(0)
    stats = t.last_stats
    n = len(got) - (len(t.data_obj.get_pointcloud(0)) - stats["dropped"])
    _same_frame(got, ref, n)
    assert stats["merged"] >= 1 and stats["completed"] == len(merged_t)
