"""The nuScenes, Lyft and Waymo branches of the port's create_infos CLI
(seevcn_torch.cli.create_infos) and run_see's adapter dispatch
(seevcn_torch.cli.run_see.build_data_obj) against the JAX package's on the
CPU.

Data: the raw trees of the JAX package's tests
(``test_bootstrap._make_raw_nuscenes``, ``test_lyft._make_raw_lyft``,
``test_bootstrap._fake_waymo_frames`` processed into a tree), each written
once and copied so that each CLI writes its own outputs; a raw Waymo
TFRecord from ``write_tfrecord``.

Tolerances: none. The infos, GT databases and their files equal JAX's
(host numpy); Waymo's raw TFRecords raise JAX's ImportError without the
waymo_open_dataset SDK, and a processed tree resumes without it.
"""
import os
import shutil

import pytest

from seevcn_tpu.cli.create_infos import main as jax_main
from seevcn_tpu.data.waymo_bootstrap import process_single_sequence
from seevcn_torch.cli import create_infos as CLI
from seevcn_torch.cli import run_see as RS
from seevcn_torch.data import see_adapters as TA
from seevcn_torch.data.waymo_bootstrap import write_tfrecord
from seevcn_torch.utils.config import Cfg
from test_bootstrap import _fake_waymo_frames, _make_raw_nuscenes
from test_lyft import _make_raw_lyft
from test_torch_kitti_bootstrap import _deep_equal, _load
from test_torch_waymo_data import _tree_bytes


def _twice(tmp_path, write):
    write(tmp_path / "j")
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    return str(tmp_path / "t"), str(tmp_path / "j")


def test_create_infos_nuscenes_matches_jax(tmp_path):
    troot, jroot = _twice(tmp_path, _make_raw_nuscenes)
    with open(tmp_path / "val.txt", "w") as f:
        f.write("scene-0002\n")
    flags = ["--dataset", "nuscenes", "--version", "v1.0-mini", "--max_sweeps", "3",
             "--val_scenes", str(tmp_path / "val.txt"), "--classes", "car"]
    paths = CLI.main(flags + ["--root", troot])
    jax_main(flags + ["--root", jroot])
    assert sorted(paths) == ["dbinfos", "train", "val"]
    for key in paths:
        rel = os.path.relpath(paths[key], troot)
        _deep_equal(_load(paths[key]), _load(os.path.join(jroot, rel)), key)
    assert len(_load(paths["train"])) == 2 and len(_load(paths["val"])) == 1
    db = "gt_database_3sweeps_withvelo"
    assert _tree_bytes(os.path.join(troot, db)) == _tree_bytes(os.path.join(jroot, db))


def test_create_infos_lyft_matches_jax(tmp_path):
    troot, jroot = _twice(tmp_path, _make_raw_lyft)
    flags = ["--dataset", "lyft", "--version", "trainval", "--max_sweeps", "2"]
    paths = CLI.main(flags + ["--root", troot])
    jax_main(flags + ["--root", jroot])
    assert sorted(paths) == ["dbinfos", "train", "val"]
    for key in paths:
        rel = os.path.relpath(paths[key], troot)
        _deep_equal(_load(paths[key]), _load(os.path.join(jroot, rel)), key)
    db = os.path.join("trainval", "gt_database")
    got = _tree_bytes(os.path.join(troot, db))
    assert got == _tree_bytes(os.path.join(jroot, db)) and len(got) == 2


def test_create_infos_waymo_matches_jax(tmp_path):
    """A raw TFRecord without a processed .pkl: both raise ImportError (no
    SDK). The same tree with the segment processed (from decoded frames):
    both resume it and write the same GT database."""
    for key in ("t", "j"):
        raw = tmp_path / key / "raw_data"
        raw.mkdir(parents=True)
        write_tfrecord(str(raw / "segment-123_with_camera_labels.tfrecord"), [b"frame"])
    flags = ["--dataset", "waymo", "--db_sampled_interval", "1", "--workers", "2"]
    for main, key in ((CLI.main, "t"), (jax_main, "j")):
        with pytest.raises(ImportError, match="waymo_open_dataset"):
            main(flags + ["--root", str(tmp_path / key)])
        shutil.rmtree(tmp_path / key / "waymo_processed_data")
        process_single_sequence("segment-123.tfrecord",
                                str(tmp_path / key / "waymo_processed_data"),
                                frames=_fake_waymo_frames())
    paths = CLI.main(flags + ["--root", str(tmp_path / "t")])
    jax_main(flags + ["--root", str(tmp_path / "j")])
    assert len(paths["infos"]) == 4
    rel = os.path.relpath(paths["dbinfos"], str(tmp_path / "t"))
    _deep_equal(_load(paths["dbinfos"]), _load(str(tmp_path / "j" / rel)))
    db = "waymo_processed_data_gt_database_train_sampled_1"
    got = _tree_bytes(str(tmp_path / "t" / db))
    assert got == _tree_bytes(str(tmp_path / "j" / db)) and len(got) == 4


@pytest.mark.parametrize("name,cls", [("nuscenes", TA.NuscenesObjects),
                                      ("waymo", TA.WaymoObjects),
                                      ("custom", TA.CustomObjects),
                                      ("baraja", TA.CustomObjects)])
def test_run_see_builds_the_adapters(tmp_path, name, cls):
    """run_see dispatches through SEE_ADAPTERS, as JAX's build_data_obj does;
    each adapter reads its tree (the nuScenes one walks each scene from its
    first sample; the others are empty here)."""
    data = {"DATASET": name, "DATA_DIR": str(tmp_path)}
    if name == "nuscenes":
        _make_raw_nuscenes(tmp_path)
        data["VERSION"] = "v1.0-mini"
    elif name == "waymo":
        (tmp_path / "waymo_processed_data").mkdir()
    obj = RS.build_data_obj(Cfg({"DATA": data}))
    assert type(obj) is cls and obj.dataset_name == cls.dataset_name
    assert len(obj) == (2 if name == "nuscenes" else 0)
