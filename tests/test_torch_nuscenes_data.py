"""The port's nuScenes and Lyft data path (seevcn_torch.data.
{nuscenes_bootstrap,lyft_bootstrap} and the NuScenes / Lyft datasets of
seevcn_torch.data.generic) against the JAX package on the CPU.

Data: the raw trees of the JAX package's own tests
(``test_bootstrap._make_raw_nuscenes``: two scenes, three samples, a car
each, 300-point sweeps; ``test_lyft._make_raw_lyft``: the Lyft layout
without point counts), written twice so that each package writes its own
outputs; quaternions from a numpy seed.

Tolerances: none. Both packages compute in numpy f64 on the host, so the
infos equal JAX's dict for dict (arrays bit for bit, strings and tokens
equal), the GT databases file for file and byte for byte, and the dataset
items (sweep choice, timestamp channel, CBGS resampling) bit for bit.
"""
import os
import pickle
import shutil

import numpy as np
import pytest

from seevcn_tpu.data import generic as JG
from seevcn_tpu.data import lyft_bootstrap as JLB
from seevcn_tpu.data import nuscenes_bootstrap as JNB
from seevcn_tpu.geom.pcd_io import write_pcd
from seevcn_tpu.utils.config import Cfg as JCfg
from seevcn_torch.data import generic as TG
from seevcn_torch.data import lyft_bootstrap as TLB
from seevcn_torch.data import nuscenes_bootstrap as TNB
from seevcn_torch.data.registry import build_dataset
from seevcn_torch.utils.config import Cfg
from test_bootstrap import _make_raw_nuscenes
from test_lyft import _make_raw_lyft
from test_torch_kitti_bootstrap import _deep_equal, _load


def _dir_bytes(path) -> dict:
    return {n: open(os.path.join(path, n), "rb").read() for n in sorted(os.listdir(path))}


@pytest.fixture(scope="module")
def nus(tmp_path_factory):
    """-> {"t": port root, "j": JAX root}: the raw nuScenes tree, its infos
    at max_sweeps 10 and its GT database, each written by its package."""
    base = tmp_path_factory.mktemp("nus")
    _make_raw_nuscenes(base / "j")
    shutil.copytree(base / "j", base / "t")
    out = {}
    for key, mod in (("t", TNB), ("j", JNB)):
        root = str(base / key)
        paths = mod.create_nuscenes_infos(root, version="v1.0-mini", max_sweeps=10,
                                          val_scene_names=["scene-0002"])
        paths["dbinfos"] = mod.create_nuscenes_groundtruth_database(
            root, paths["train"], used_classes=["car"], max_sweeps=10)
        out[key] = (root, paths)
    return out


@pytest.fixture(scope="module")
def lyft(tmp_path_factory):
    base = tmp_path_factory.mktemp("lyft")
    _make_raw_lyft(base / "j")
    shutil.copytree(base / "j", base / "t")
    out = {}
    for key, mod in (("t", TLB), ("j", JLB)):
        root = str(base / key)
        paths = mod.create_lyft_infos(root, version="trainval", max_sweeps=10)
        paths["dbinfos"] = mod.create_lyft_groundtruth_database(root, "trainval",
                                                                paths["train"])
        out[key] = (root, paths)
    return out


def test_quaternion_helpers_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        q, p = rng.randn(4), rng.randn(4)
        t = rng.uniform(-50, 50, 3)
        np.testing.assert_array_equal(TNB.quat_to_rotmat(q), JNB.quat_to_rotmat(q))
        np.testing.assert_array_equal(TNB.quat_multiply(q, p), JNB.quat_multiply(q, p))
        np.testing.assert_array_equal(TNB.quat_inverse(q), JNB.quat_inverse(q))
        assert TNB.quaternion_yaw(q) == JNB.quaternion_yaw(q)
        for inverse in (False, True):
            got = TNB.transform_matrix(t, q, inverse=inverse)
            assert got.dtype == np.float64
            np.testing.assert_array_equal(got, JNB.transform_matrix(t, q, inverse=inverse))
    # a rotation and its inverse transform compose to the identity
    tm = TNB.transform_matrix(t, q) @ TNB.transform_matrix(t, q, inverse=True)
    np.testing.assert_allclose(tm, np.eye(4), atol=1e-12)


def test_nuscenes_tables_match_jax(nus):
    root = nus["t"][0]
    t, j = TNB.NuScenesTables(root, "v1.0-mini"), JNB.NuScenesTables(root, "v1.0-mini")
    assert [s["token"] for s in t.sample] == [s["token"] for s in j.sample]
    for s in t.sample:
        assert t.channels_of(s["token"]) == j.channels_of(s["token"])
        assert t.anns_of(s["token"]) == j.anns_of(s["token"])
        for tok in t.anns_of(s["token"]):
            ann = t.get("sample_annotation", tok)
            np.testing.assert_array_equal(t.box_velocity(ann), j.box_velocity(ann))
            assert t.category_name(ann) == j.category_name(ann) == "vehicle.car"
        cs = t.get("calibrated_sensor", "cs_lidar")
        pose = t.get("ego_pose", t.channels_of(s["token"])["LIDAR_TOP"]["ego_pose_token"])
        _deep_equal(TNB._boxes_in_sensor_frame(t, t.anns_of(s["token"]), cs, pose),
                    JNB._boxes_in_sensor_frame(j, j.anns_of(s["token"]), cs, pose))


def test_nuscenes_infos_match_jax(nus):
    (troot, tp), (jroot, jp) = nus["t"], nus["j"]
    for split in ("train", "val"):
        got, ref = _load(tp[split]), _load(jp[split])
        assert len(got) == (2 if split == "train" else 1)
        _deep_equal(got, ref, split)
    info = _load(tp["train"])[1]
    assert len(info["sweeps"]) == 9 and info["sweeps"][0]["sample_data_token"] == "sd0"
    np.testing.assert_allclose(info["sweeps"][0]["transform_matrix"][:3, 3], [-10.0, 0, 0],
                               atol=1e-9)
    np.testing.assert_allclose(info["gt_boxes"][0, 7:9], [20.0, 0.0], atol=1e-6)


def test_nuscenes_gt_database_matches_jax(nus):
    (troot, tp), (jroot, jp) = nus["t"], nus["j"]
    _deep_equal(_load(tp["dbinfos"]), _load(jp["dbinfos"]))
    db = "gt_database_10sweeps_withvelo"
    got, ref = _dir_bytes(os.path.join(troot, db)), _dir_bytes(os.path.join(jroot, db))
    assert got == ref and len(got) == 2


def test_lyft_infos_and_database_match_jax(lyft):
    (troot, tp), (jroot, jp) = lyft["t"], lyft["j"]
    for split in ("train", "val"):
        _deep_equal(_load(tp[split]), _load(jp[split]), split)
    _deep_equal(_load(tp["dbinfos"]), _load(jp["dbinfos"]))
    db = os.path.join("trainval", "gt_database")
    got, ref = _dir_bytes(os.path.join(troot, db)), _dir_bytes(os.path.join(jroot, db))
    assert got == ref and len(got) == 2
    # the test version writes lyft_infos_test.pkl only
    shutil.copytree(os.path.join(troot, "trainval"), os.path.join(troot, "test"))
    shutil.copy(os.path.join(troot, "ImageSets", "train.txt"),
                os.path.join(troot, "ImageSets", "test.txt"))
    got = TLB.create_lyft_infos(troot, version="test", max_sweeps=2,
                                save_path=os.path.join(troot, "t_out"))
    ref = JLB.create_lyft_infos(troot, version="test", max_sweeps=2,
                                save_path=os.path.join(troot, "j_out"))
    assert list(got) == list(ref) == ["test"]
    _deep_equal(_load(got["test"]), _load(ref["test"]))


FEATURES = {False: ["x", "y", "z", "intensity"],
            True: ["x", "y", "z", "intensity", "timestamp"]}


def _data_cfg(name, root, info, max_sweeps, timestamp, **kw):
    return {"DATASET": name, "DATA_PATH": root, "MAX_SWEEPS": max_sweeps,
            "POINT_CLOUD_RANGE": [-40, -40, -3, 40, 40, 3],
            "INFO_PATH": {"train": [info], "test": [info]},
            "POINT_FEATURE_ENCODING": {"used_feature_list": FEATURES[timestamp],
                                       "src_feature_list": FEATURES[timestamp]}, **kw}


def _items_equal(a, b, n: int):
    for i in range(n):
        got, ref = a[i], b[i]
        assert sorted(got) == sorted(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                assert got[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            else:
                assert got[k] == ref[k], k
        np.testing.assert_array_equal(a.get_lidar(a.infos[i]), b.get_lidar(b.infos[i]))


@pytest.mark.parametrize("domain", ["nuscenes", "lyft"])
@pytest.mark.parametrize("max_sweeps,timestamp", [(1, False), (1, True), (10, False),
                                                  (10, True)])
def test_dataset_items_match_jax(nus, lyft, domain, max_sweeps, timestamp):
    if domain == "nuscenes":
        root, paths = nus["t"]
        name, info = "NuScenesDataset", os.path.basename(paths["train"])
    else:
        root, paths = lyft["t"]
        root, name, info = os.path.join(root, "trainval"), "LyftDataset", "lyft_infos_train.pkl"
    cfg = _data_cfg(name, root, info, max_sweeps, timestamp)
    for training in (True, False):
        t = getattr(TG, name)(Cfg(cfg), ["car"], training, max_points=2048, max_boxes=4)
        j = getattr(JG, name)(JCfg(cfg), ["car"], training, max_points=2048, max_boxes=4)
        assert len(t) == len(j) == 2
        _items_equal(t, j, 2)
        t.set_epoch(3)
        j.set_epoch(3)
        _items_equal(t, j, 2)
    assert t[0]["frame_id"] == "samp0"                 # the info's token
    pts = t.get_lidar(t.infos[1])
    assert pts.shape[1] == 4 + timestamp
    if max_sweeps == 10:
        assert len(pts) > 300 and (not timestamp or (pts[:, 4] > 0).any())
    assert isinstance(build_dataset(Cfg(cfg), ["car"], False), getattr(TG, name))


@pytest.mark.parametrize("name", ["SCNuScenesDataset", "SCLyftDataset"])
def test_completed_clouds_match_jax(tmp_path, name):
    rng = np.random.RandomState(4)
    os.makedirs(tmp_path / "vcn", exist_ok=True)
    infos = []
    for k in range(2):
        write_pcd(str(tmp_path / "vcn" / f"tok{k}.pcd"),
                  rng.uniform(-20, 20, (500, 3)).astype(np.float32))
        infos.append({"token": f"tok{k}", "lidar_path": "none.bin",
                      "gt_boxes": np.array([[5, 0, 0, 4.2, 2.0, 1.6, 0.2]], np.float32),
                      "gt_names": np.array(["car"])})
    infos[1]["completed_lidar_path"] = "vcn/tok1.pcd"
    with open(tmp_path / "infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    cfg = _data_cfg(name, str(tmp_path), "infos.pkl", 1, False)
    cfg["POINT_FEATURE_ENCODING"] = {"used_feature_list": ["x", "y", "z"]}
    t = getattr(TG, name)(Cfg(cfg), ["car"], False, max_points=512, max_boxes=4)
    j = getattr(JG, name)(JCfg(cfg), ["car"], False, max_points=512, max_boxes=4)
    _items_equal(t, j, 2)
    assert t[0]["points_valid"].sum() == 500


def test_cbgs_resampling_matches_jax(tmp_path):
    """BALANCED_RESAMPLING on a 9:1 car / truck split with a third class
    absent: the same infos, in the same order, at two seeds."""
    os.makedirs(tmp_path / "samples", exist_ok=True)
    np.zeros((10, 5), np.float32).tofile(tmp_path / "samples" / "p.bin")
    infos = [{"token": f"t{i}", "lidar_path": "samples/p.bin",
              "gt_boxes": np.array([[5, 0, 0, 4, 2, 1.6, 0]] * (1 + i % 2), np.float32),
              "gt_names": np.array(["car" if i < 18 else "truck"] * (1 + i % 2))}
             for i in range(20)]
    with open(tmp_path / "infos_train.pkl", "wb") as f:
        pickle.dump(infos, f)
    classes = ["car", "truck", "bus"]
    for seed in (0, 5):
        cfg = _data_cfg("NuScenesDataset", str(tmp_path), "infos_train.pkl", 1, False,
                        BALANCED_RESAMPLING=True, RESAMPLING_SEED=seed)
        t = TG.NuScenesDataset(Cfg(cfg), classes, True, max_points=16, max_boxes=2)
        j = JG.NuScenesDataset(JCfg(cfg), classes, True, max_points=16, max_boxes=2)
        assert [i["token"] for i in t.infos] == [i["token"] for i in j.infos]
        names = [str(i["gt_names"][0]) for i in t.infos]
        assert names.count("truck") > 0.5 * names.count("car")    # from 2 of 20
