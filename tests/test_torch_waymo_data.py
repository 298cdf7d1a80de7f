"""The port's Waymo data path (seevcn_torch.data.waymo_bootstrap, the Waymo
datasets of seevcn_torch.data.generic and seevcn_torch.utils.shm_cache)
against the JAX package on the CPU.

Data: the JAX package's own fake decoded frames
(``test_bootstrap._fake_waymo_frames``: 400 points, a Vehicle and an
unknown label each), processed by each package into its own tree; TFRecord
payloads and shared arrays from a numpy seed. Shared-memory segments carry
this process's id in their names, so that parallel test processes cannot
meet, and every test deletes what it made.

Tolerances: none. The TFRecords, the processed .npy files and the GT
database equal JAX's byte for byte, the infos dict for dict, the dataset
items bit for bit; a shared array written by either package reads back in
the other bit for bit (the same segment names and header).
"""
import os
import pickle
import shutil

import numpy as np
import pytest

from seevcn_tpu.data import generic as JG
from seevcn_tpu.data import waymo_bootstrap as JWB
from seevcn_tpu.geom.pcd_io import write_pcd
from seevcn_tpu.utils import shm_cache as JS
from seevcn_tpu.utils.config import Cfg as JCfg
from seevcn_torch.data import generic as TG
from seevcn_torch.data import waymo_bootstrap as TWB
from seevcn_torch.utils import shm_cache as TS
from seevcn_torch.utils.config import Cfg
from test_bootstrap import _fake_waymo_frames
from test_torch_kitti_bootstrap import _deep_equal, _load

SEQ = "segment-123"


def _tree_bytes(path) -> dict:
    out = {}
    for d, _, files in os.walk(path):
        for n in files:
            p = os.path.join(d, n)
            out[os.path.relpath(p, path)] = open(p, "rb").read()
    return out


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """-> {"t": (root, infos), "j": ...}: each package's processed tree
    (waymo_processed_data/<seq>/NNNN.npy + <seq>.pkl) and its GT database."""
    base = tmp_path_factory.mktemp("waymo")
    out = {}
    for key, mod in (("t", TWB), ("j", JWB)):
        root = base / key
        infos = mod.process_single_sequence(f"{SEQ}_with_camera_labels.tfrecord",
                                            str(root / "waymo_processed_data"),
                                            frames=_fake_waymo_frames())
        db = mod.create_waymo_groundtruth_database(str(root / "waymo_processed_data"),
                                                   save_path=str(root), sampled_interval=1)
        out[key] = (root, infos, db)
    return out


def test_tfrecord_round_trip_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    payloads = [b"", b"frame", rng.bytes(1000), rng.randn(64).astype(np.float32).tobytes()]
    TWB.write_tfrecord(str(tmp_path / "t.tfrecord"), payloads)
    JWB.write_tfrecord(str(tmp_path / "j.tfrecord"), payloads)
    assert (tmp_path / "t.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()
    assert list(TWB.read_tfrecord(str(tmp_path / "j.tfrecord"))) == payloads
    assert list(JWB.read_tfrecord(str(tmp_path / "t.tfrecord"))) == payloads
    with open(tmp_path / "cut.tfrecord", "wb") as f:
        f.write((tmp_path / "t.tfrecord").read_bytes()[:-30])
    for mod in (TWB, JWB):
        with pytest.raises(EOFError):
            list(mod.read_tfrecord(str(tmp_path / "cut.tfrecord")))


def test_labels_match_jax():
    labels = _fake_waymo_frames(1)[0]["labels"]
    _deep_equal(TWB.generate_labels(labels), JWB.generate_labels(labels))
    _deep_equal(TWB.generate_labels([]), JWB.generate_labels([]))


def test_process_single_sequence_matches_jax(processed, tmp_path):
    (troot, tinfos, _), (jroot, jinfos, _) = processed["t"], processed["j"]
    _deep_equal(tinfos, jinfos)
    assert [i["frame_id"] for i in tinfos] == [f"{SEQ}_{k:03d}" for k in range(4)]
    tree = os.path.join("waymo_processed_data", SEQ)
    got, ref = _tree_bytes(troot / tree), _tree_bytes(jroot / tree)
    assert sorted(got) == sorted(ref) == [f"{k:04d}.npy" for k in range(4)] + [f"{SEQ}.pkl"]
    assert got == ref
    # resumed: an existing .pkl short-circuits, frames or none
    _deep_equal(TWB.process_single_sequence(f"{SEQ}.tfrecord",
                                            str(troot / "waymo_processed_data")), tinfos)
    # sampled_interval 2 in a fresh tree: frames 0 and 2
    half = TWB.process_single_sequence(f"{SEQ}.tfrecord", str(tmp_path / "t"),
                                       sampled_interval=2, frames=_fake_waymo_frames())
    _deep_equal(half, JWB.process_single_sequence(f"{SEQ}.tfrecord", str(tmp_path / "j"),
                                                  sampled_interval=2,
                                                  frames=_fake_waymo_frames()))
    assert [i["point_cloud"]["sample_idx"] for i in half] == [0, 2]


def test_raw_tfrecords_need_the_sdk(processed, tmp_path):
    """Without waymo_open_dataset both packages raise ImportError on a
    segment that has no processed .pkl; a processed tree resumes."""
    raw = tmp_path / "raw_data"
    raw.mkdir()
    TWB.write_tfrecord(str(raw / "segment-9.tfrecord"), [b"not a frame"])
    for mod in (TWB, JWB):
        with pytest.raises(ImportError, match="waymo_open_dataset"):
            mod.decode_frame_with_sdk(b"")
        with pytest.raises(ImportError, match="waymo_open_dataset"):
            mod.create_waymo_infos(str(raw), str(tmp_path / "out"), num_workers=2)
    troot = processed["t"][0]
    shutil.copytree(troot / "waymo_processed_data", tmp_path / "resumed")
    TWB.write_tfrecord(str(raw / "segment-9.tfrecord"), [])
    (raw / f"{SEQ}_with_camera_labels.tfrecord").write_bytes(b"")
    got = TWB.create_waymo_infos(str(raw), str(tmp_path / "resumed"), num_workers=2)
    ref = JWB.create_waymo_infos(str(raw), str(tmp_path / "resumed"), num_workers=2)
    _deep_equal(got, ref)
    assert len(got) == 4                          # segment-9 holds no record


def test_gt_database_matches_jax(processed):
    (troot, _, tdb), (jroot, _, jdb) = processed["t"], processed["j"]
    _deep_equal(_load(tdb), _load(jdb))
    assert os.path.basename(tdb) == \
        "waymo_processed_data_waymo_dbinfos_train_sampled_1.pkl"
    db = "waymo_processed_data_gt_database_train_sampled_1"
    got, ref = _tree_bytes(troot / db), _tree_bytes(jroot / db)
    assert got == ref and len(got) == 4


def _shm_name(tag: str) -> str:
    return f"t{os.getpid()}_{tag}"


def test_shm_cache_across_packages():
    rng = np.random.RandomState(1)
    arr = rng.randn(100, 6).astype(np.float32)
    short, long = _shm_name("a"), _shm_name("waymo_processed_data/segment-1234567890__17")
    try:
        for make, attach in ((TS, JS), (JS, TS)):
            for name, a in ((short, arr), (f"shm://{long}", arr[:10].astype(np.float64))):
                view = make.sa_create(name, a)
                assert TS.sa_exists(name) and JS.sa_exists(name)
                got = attach.sa_attach(name)
                assert got.dtype == a.dtype
                np.testing.assert_array_equal(got, a)
                got[0, 0] = 7.0                  # one segment behind both views
                assert view[0, 0] == 7.0
                attach.sa_delete(name)
                assert not make.sa_exists(name)
        assert TS._seg_name(long) == JS._seg_name(long) and len(TS._seg_name(long)) == 23
    finally:
        for name in (short, long):
            TS.sa_delete(name)


def _waymo_cfg(root, info, shm, **kw):
    return {"DATASET": "WaymoDataset", "DATA_PATH": str(root), "USE_SHARED_MEMORY": shm,
            "POINT_CLOUD_RANGE": [-40, -40, -3, 40, 40, 3],
            "INFO_PATH": {"train": [info], "test": [info]},
            "POINT_FEATURE_ENCODING": {"used_feature_list": ["x", "y", "z"],
                                       "src_feature_list": ["x", "y", "z", "intensity"]},
            **kw}


@pytest.mark.parametrize("shm", [False, True])
def test_waymo_dataset_matches_jax(processed, tmp_path, shm):
    """Items of the processed tree through both datasets; with
    USE_SHARED_MEMORY the first read fills the cache (a segment a frame,
    named <seq>__<sample>), the second comes from it, and the test deletes
    the segments."""
    src = processed["t"][0] / "waymo_processed_data" / SEQ
    seq = _shm_name(SEQ)                          # the segments' names
    shutil.copytree(src, tmp_path / "waymo_processed_data" / seq)
    infos = pickle.loads(pickle.dumps(processed["t"][1]))
    for info in infos:
        info["point_cloud"]["lidar_sequence"] = seq
    with open(tmp_path / "infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    tags = [f"{seq}__{k}" for k in range(4)]
    try:
        for training in (True, False):
            cfg = _waymo_cfg(tmp_path, "infos.pkl", shm)
            t = TG.WaymoDataset(Cfg(cfg), ["Vehicle"], training, max_points=512, max_boxes=4)
            j = JG.WaymoDataset(JCfg(cfg), ["Vehicle"], training, max_points=512, max_boxes=4)
            assert len(t) == len(j) == 4
            for k in range(4):
                got, ref = t[k], j[k]
                assert sorted(got) == sorted(ref) and got["frame_id"] == ref["frame_id"] == str(k)
                for key in ref:
                    if isinstance(ref[key], np.ndarray):
                        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
                assert int(got["gt_mask"].sum()) == 1 and got["points_valid"].sum() == 400
            assert all(TS.sa_exists(tag) for tag in tags) == shm
        if shm:                                   # the cache serves without the files
            shutil.rmtree(tmp_path / "waymo_processed_data")
            np.testing.assert_array_equal(t.get_lidar(infos[2]), j.get_lidar(infos[2]))
        cfg = _waymo_cfg(tmp_path, "infos.pkl", shm, SAMPLED_INTERVAL={"train": 2, "test": 3})
        assert len(TG.WaymoDataset(Cfg(cfg), ["Vehicle"], True)) == 2
        assert len(TG.WaymoDataset(Cfg(cfg), ["Vehicle"], False)) == 2
    finally:
        for tag in tags:
            TS.sa_delete(tag)
    assert not any(TS.sa_exists(tag) for tag in tags)


def test_sc_waymo_dataset_matches_jax(processed, tmp_path):
    rng = np.random.RandomState(2)
    infos = pickle.loads(pickle.dumps(processed["t"][1][:2]))
    for k, info in enumerate(infos):
        pc = info["point_cloud"]
        os.makedirs(tmp_path / "vcn" / pc["lidar_sequence"], exist_ok=True)
        write_pcd(str(tmp_path / "vcn" / pc["lidar_sequence"] / f"{pc['sample_idx']:04d}.pcd"),
                  rng.uniform(-20, 20, (300 + k, 3)).astype(np.float32))
    infos[1]["completed_lidar_path"] = os.path.join("vcn", SEQ, "0001.pcd")
    with open(tmp_path / "infos.pkl", "wb") as f:
        pickle.dump(infos, f)
    cfg = _waymo_cfg(tmp_path, "infos.pkl", False, DATASET="SCWaymoDataset",
                     POINT_FEATURE_ENCODING={"used_feature_list": ["x", "y", "z"]})
    t = TG.SCWaymoDataset(Cfg(cfg), ["Vehicle"], False, max_points=512, max_boxes=4)
    j = JG.SCWaymoDataset(JCfg(cfg), ["Vehicle"], False, max_points=512, max_boxes=4)
    for k in range(2):
        np.testing.assert_array_equal(t.get_lidar(t.infos[k]), j.get_lidar(j.infos[k]))
        np.testing.assert_array_equal(t[k]["points"], j[k]["points"])
        assert t[k]["points_valid"].sum() == 300 + k
