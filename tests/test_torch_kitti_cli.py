"""The port's KITTI workflow CLIs (seevcn_torch.cli: run_see, generate_masks,
train_detector, test_detector) on the CPU, the last three against the JAX
package's on the same inputs.

Data: a synthetic KITTI split from ``chip_smoke.write_kitti_split`` (four
frames of 6,000 points, three cars each, KITTI's calibration, the port's
PNGs), its mask file from each car's projected box
(``chip_smoke.car_box_detections``), VCN_VC at seeded weights in a
reference ``.pth``; the detector is SECOND-IoU at ``tiny_detector_cfg``
over kitti_dataset.yaml's data config at the tiny range, batch 2, with the
random world flip.

Tolerances: run_see's .pcds equal the port's own SEEVCN frame by frame;
generate_masks' JSON is JAX's ``main``'s byte for byte on the same PNGs
and detections; test_detector's AP is JAX's evaluation of the same .pth
within 1e-4 and its recall counts equal. With ``--launcher jax`` over two
spawned gloo ranks at the same global batch and initial weights,
train_detector's epoch loss (the mean of its two steps) is ``--launcher
none``'s within 1e-4 (relative) and its checkpoint's weights within 2 lr a
step (its running statistics within 1e-4): Adam's first step moves an
element whose gradient is f32 rounding noise by lr either way, and the
second step starts from there, as tests/test_torch_train_step.py holds
its second step; the ranks' weights are bit for bit equal; test_detector over the two
ranks gives ``--launcher none``'s AP within 1e-4 and its recall counts.
"""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import (car_box_detections, kitti_cfg, plain_tree, seeded_vcn_state_dict,
                        write_kitti_split)
from seevcn_torch.cli import generate_masks as GM
from seevcn_torch.cli import run_see as RS
from seevcn_torch.cli import test_detector as TD
from seevcn_torch.cli import train_detector as TR
from seevcn_torch.data.kitti.dataset import SCKittiDataset
from seevcn_torch.data.kitti.see_adapter import KittiObjects
from seevcn_torch.geom.pcd_io import read_pcd
from seevcn_torch.models.detectors.configs import tiny_detector_cfg, tiny_pointpillar_cfg
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.see.pipeline import SEEVCN
from seevcn_torch.testing import cli_worker, free_port, spawn_ranks
from seevcn_torch.train.optim import build_lr_schedule
from seevcn_torch.utils.ckpt import save_detector_checkpoint
from seevcn_torch.utils.config import Cfg, cfg_from_yaml_file

TINY_RANGE = [0, -8, -2, 16, 8, 2]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_cli")
    infos = write_kitti_split(str(root), 4, seed=3, n_points=6000, n_cars=3)
    GM.detections_to_coco(car_box_detections(infos), str(root / "masks_image_2.json"))
    torch.save({"base_model": seeded_vcn_state_dict(0)}, root / "vcn.pth")
    see = {"DATA": {"DATASET": "kitti", "DATA_DIR": str(root),
                    "INFO_PATHS": ["kitti_infos_val.pkl"],
                    "MASK_PATHS": {"image_2": "masks_image_2.json"},
                    "CAMERA_CHANNELS": ["image_2"], "TAG": "t", "CLASSES": ["Car"],
                    "SHRINK_MASK_PERCENTAGE": 3.0},
           "PC_ISOLATION": {"MIN_LIDAR_PTS": 30, "EPS_SCALING": 4.0, "MIN_EPS": 0.3,
                            "MAX_EPS": 1.0},
           "SURFACE_COMPLETION": {"VRES": 0.4, "VCN": {
               "MODEL": "VCN_VC", "CKPT_PATH": str(root / "vcn.pth"), "NORM_WITH_GT": False,
               "SEL_K_NEAREST": 30, "CLUSTER_EPS": 0.4, "BATCH_SIZE_LIMIT": 8}}}
    with open(root / "see.yaml", "w") as f:
        yaml.safe_dump(see, f)
    cfg = tiny_detector_cfg()
    dc = kitti_cfg(str(root), POINT_CLOUD_RANGE=TINY_RANGE)
    dc["DATA_PROCESSOR"] = list(dc.DATA_PROCESSOR) + list(cfg.DATA_CONFIG.DATA_PROCESSOR)
    dc["DATA_AUGMENTOR"] = {"DISABLE_AUG_LIST": [], "AUG_CONFIG_LIST": [
        {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x"]}]}
    cfg["DATA_CONFIG"] = dc
    cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU = 2
    with open(root / "tiny.yaml", "w") as f:
        yaml.safe_dump(plain_tree(cfg), f)
    return root, infos


def test_run_see_writes_the_pipelines_frames(split, capsys):
    root, infos = split
    cfg_file = str(root / "see.yaml")
    out = RS.main(["--cfg_file", cfg_file, "--device", "cpu"])
    assert sorted(out["frames"]) == [0, 1, 2, 3]
    printed = capsys.readouterr().out
    assert "instances isolated" in printed and "scan points dropped" in printed
    cfg = cfg_from_yaml_file(cfg_file)
    see = SEEVCN(cfg, data_obj=KittiObjects(cfg.DATA), device="cpu")
    for i, info in enumerate(infos):
        idx = info["point_cloud"]["lidar_idx"]
        pcd = read_pcd(str(root / "training" / "vcn_t" / f"{idx}.pcd"))
        np.testing.assert_array_equal(pcd, see.process_det_frame(i))
        rec = out["frames"][i]
        assert (rec["isolated"], rec["completed"], rec["dropped"]) == (
            see.last_stats["isolated"], see.last_stats["completed"], see.last_stats["dropped"])
        assert rec["completed"] > 0 and rec["dropped"] > 0
    # resume by file: a second run, in worker threads, skips every frame
    again = RS.main(["--cfg_file", cfg_file, "--device", "cpu", "--workers", "2"])
    assert again["frames"] == {} and again["infos"] == out["infos"]
    # the updated infos drive SCKittiDataset
    ds = SCKittiDataset(Cfg({"DATASET": "SCKittiDataset", "DATA_PATH": str(root),
                             "POINT_CLOUD_RANGE": [0, -40, -3, 70.4, 40, 1],
                             "DATA_PROCESSOR": [], "PROCESSED_DATA_TAG": "vcn_t",
                             "INFO_PATH": {"train": [], "test": [out["infos"]]}}),
                        ["Car"], training=False, max_points=8000, max_boxes=4)
    assert len(ds) == 4
    item = ds[0]
    raw = np.fromfile(root / "training" / "velodyne" / "000000.bin", np.float32).reshape(-1, 4)
    assert 1000 < item["points_valid"].sum() != len(raw)


@pytest.mark.parametrize("name,match", [("demo", None), ("lidar_only", "lidar_only")])
def test_run_see_unported_adapters_raise(name, match, tmp_path):
    """The demo adapter builds now (its frames: test_torch_demo.py); a name
    no package has raises as JAX's build_data_obj does (the other adapters:
    test_torch_see_adapters.py)."""
    if match is None:
        from seevcn_torch.data.demo_dataset import DemoObjects

        obj = RS.build_data_obj(Cfg({"DATA": {"DATASET": name, "ROOT": str(tmp_path)}}))
        assert isinstance(obj, DemoObjects) and len(obj) == 0
        assert obj.camera_channels == ["front"] and obj.masks == {}
        return
    with pytest.raises(NotImplementedError, match=match):
        RS.build_data_obj(Cfg({"DATA": {"DATASET": name}}))


def _backend(image_bgr):
    """An import: backend: two detections from the image's own pixels, so
    that a wrong channel order or read changes the JSON."""
    h, w = image_bgr.shape[:2]
    blue = image_bgr[..., 0] > 200
    band = np.zeros((h, w), bool)
    band[h // 3:h // 2, int(image_bgr[0, 0, 2]) % (w // 2):w - 10] = True
    return [{"mask": blue, "bbox": [0, 0, w, h], "score": 0.9, "category_id": 3},
            {"mask": band, "bbox": [1.5, 2.0, 30.0, 40.0], "score": 0.8}]


def test_generate_masks_matches_jax_byte_for_byte(split, tmp_path):
    from seevcn_tpu.cli import generate_masks as JGM

    root, _ = split
    image_dir = str(root / "training" / "image_2")
    args = ["--image_dir", image_dir, "--backend", f"import:{__name__}:_backend"]
    got = GM.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    JGM.main(args + ["--out", str(tmp_path / "jax.json")])
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert got["images"] == 4 and got["detections"] == [2] * 4
    with open(tmp_path / "port.json") as f:
        assert len(json.load(f)["annotations"]) == 8
    assert GM.parse_args(["--image_dir", image_dir, "--out", "x.json"]).backend == "jax"
    with pytest.raises(SystemExit, match="torchvision"):
        GM.main(["--image_dir", image_dir, "--out", str(tmp_path / "x.json"),
                 "--backend", "torchvision"])
    # JPEGs: the port's decoder reads what cv2 reads, so the JSON is JAX's
    # byte for byte again; a truncated file raises
    import cv2

    (tmp_path / "jpg").mkdir()
    for i, png in enumerate(sorted(os.listdir(image_dir))):
        cv2.imwrite(str(tmp_path / "jpg" / f"{i:06d}.jpg"), cv2.imread(os.path.join(image_dir, png)))
    args = ["--image_dir", str(tmp_path / "jpg"), "--backend", f"import:{__name__}:_backend"]
    got = GM.main(args + ["--out", str(tmp_path / "port_jpg.json"), "--device", "cpu"])
    JGM.main(args + ["--out", str(tmp_path / "jax_jpg.json")])
    assert (tmp_path / "port_jpg.json").read_bytes() == (tmp_path / "jax_jpg.json").read_bytes()
    assert got["images"] == 4
    blob = (tmp_path / "jpg" / "000000.jpg").read_bytes()
    (tmp_path / "jpg" / "000000.jpg").write_bytes(blob[:len(blob) // 2])
    with pytest.raises(ValueError, match="premature end"):
        GM.main(args + ["--out", str(tmp_path / "y.json"), "--device", "cpu"])


@pytest.fixture(scope="module")
def trained(split, tmp_path_factory):
    """One epoch, then a resume for a second, rotating to one checkpoint."""
    root, _ = split
    out = str(tmp_path_factory.mktemp("runs"))
    common = ["--cfg_file", str(root / "tiny.yaml"), "--max_points", "4096",
              "--output_dir", out, "--device", "cpu", "--max_ckpt_save_num", "1"]
    first = TR.main(common + ["--epochs", "1"])
    state0 = {k: v.detach().clone() for k, v in first["state"].model.state_dict().items()}
    second = TR.main(common + ["--epochs", "2"])
    return first, state0, second


def test_train_detector_resumes_and_rotates(trained):
    from seevcn_tpu.utils.ckpt_compat import load_detector_checkpoint as jax_load

    first, state0, second = trained
    assert first["start_epoch"] == 0 and first["resumed"] is None
    assert [os.path.basename(p) for p in first["ckpts"]] == ["checkpoint_epoch_0.pth"]
    assert first["state"].step == 2 and all(np.isfinite(first["losses"]))
    res = second["resumed"]
    assert res["epoch"] == 0 and res["step"] == 2 and second["start_epoch"] == 1
    assert res["path"] == first["ckpts"][0]
    for k, v in state0.items():                        # the resume read epoch 0 exactly
        assert torch.equal(res["state_dict"][k], v), k
    assert [os.path.basename(p) for p in second["ckpts"]] == ["checkpoint_epoch_1.pth"]
    assert second["state"].step == 4
    saved = torch.load(second["ckpts"][0], weights_only=False)
    assert (saved["epoch"], saved["it"]) == (1, 4)
    variables = jax_load(second["ckpts"][0], "SECONDNetIoU")
    kernel = variables["params"]["dense_head"]["conv_cls"]["kernel"]
    np.testing.assert_array_equal(
        np.asarray(kernel)[0, 0],
        second["state"].model.state_dict()["dense_head.conv_cls.weight"][:, :, 0, 0].numpy().T)
    # --launcher slurm reads SLURM_PROCID first, as JAX's does
    with pytest.raises(KeyError, match="SLURM_PROCID"):
        TR.main(["--cfg_file", "unused.yaml", "--launcher", "slurm"])


@pytest.mark.parametrize("make", [tiny_detector_cfg, tiny_pointpillar_cfg],
                         ids=["second_iou", "pointpillar"])
def test_load_weights_round_trips(tmp_path, make):
    """train_detector's reader takes the port's .pth back into a fresh model
    bit for bit: through the reference reader (SECOND-IoU's modules), or as
    saved for a detector with modules that reader does not keep
    (PointPillar's VFE)."""
    cfg = make()
    torch.manual_seed(0)
    model, _ = build_detector(cfg, device="cpu")
    save_detector_checkpoint(str(tmp_path / "m.pth"), model, epoch=2, it=7)
    torch.manual_seed(1)
    fresh, _ = build_detector(cfg, device="cpu")
    ckpt = TR.load_weights(fresh, str(tmp_path / "m.pth"))
    assert (ckpt["epoch"], ckpt["it"]) == (2, 7)
    got = fresh.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def tested(split, trained):
    """test_detector on the CPU on ``trained``'s last checkpoint at batch 2:
    its argv (without --device) and (AP report, AP dict, recall counts)."""
    root, _ = split
    argv = ["--cfg_file", str(root / "tiny.yaml"), "--ckpt", trained[2]["ckpts"][0],
            "--max_points", "4096", "--batch_size", "2"]
    return argv, TD.main(argv + ["--device", "cpu"])


def test_test_detector_matches_jax(split, trained, tested):
    from seevcn_tpu.cli import test_detector as JTD
    from seevcn_tpu.utils.config import cfg_from_yaml_file as jax_cfg

    root, _ = split
    ckpt = trained[2]["ckpts"][0]
    argv, (report, ap, recall) = tested
    jreport, jap, jrecall = JTD.evaluate_ckpt(jax_cfg(str(root / "tiny.yaml")), ckpt,
                                              JTD.parse_args(argv))
    assert "Car" in report and recall == jrecall and recall["num_gt"] > 0
    assert set(ap) == set(jap)
    for c in ap:
        for m in ap[c]:
            np.testing.assert_allclose([ap[c][m][d] for d in sorted(ap[c][m])],
                                       [jap[c][m][d] for d in sorted(jap[c][m])], atol=1e-4)
    # DATA_CONFIG_TAR: the target's data config, the source's voxelizer inherited
    cfg = cfg_from_yaml_file(str(root / "tiny.yaml"))
    tar = dict(plain_tree(cfg.DATA_CONFIG), TARGET=True, CLASS_NAMES=["Car"])
    tar["DATA_PROCESSOR"] = [p for p in tar["DATA_PROCESSOR"]
                             if p["NAME"] != "transform_points_to_voxels"]
    with open(root / "tiny_da.yaml", "w") as f:
        yaml.safe_dump({**plain_tree(cfg), "DATA_CONFIG_TAR": tar}, f)
    ecfg = TD.eval_config(cfg_from_yaml_file(str(root / "tiny_da.yaml")))
    assert ecfg.DATA_CONFIG.TARGET and [p.NAME for p in ecfg.DATA_CONFIG.DATA_PROCESSOR] == \
        ["shuffle_points", "transform_points_to_voxels"]
    report_tar, ap_tar, recall_tar = TD.main(["--cfg_file", str(root / "tiny_da.yaml")]
                                             + argv[2:] + ["--device", "cpu", "--max_frames",
                                                           "3", "--batch_size", "1"])
    assert "Car" in report_tar and 0 < recall_tar["num_gt"] < recall["num_gt"]


@pytest.fixture(scope="module")
def launched(split, trained, tmp_path_factory):
    """train_detector (one epoch at the global batch of 2, the initial
    weights from --fix_random_seed) with --launcher none here, then with
    --launcher jax over two spawned ranks (one frame a rank), which also run
    test_detector on ``trained``'s last checkpoint."""
    root, _ = split

    def train(tag):
        return ["--cfg_file", str(root / "tiny.yaml"), "--max_points", "4096",
                "--output_dir", str(tmp_path_factory.mktemp(tag)), "--device", "cpu",
                "--epochs", "1", "--batch_size", "2", "--fix_random_seed"]

    single = TR.main(train("runs_w1"))
    single_sd = {k: v.detach().clone() for k, v in single["state"].model.state_dict().items()}
    test = ["--cfg_file", str(root / "tiny.yaml"), "--ckpt", trained[2]["ckpts"][0],
            "--max_points", "4096", "--batch_size", "2", "--device", "cpu"]
    return (single, single_sd), spawn_ranks(cli_worker, 2, train("runs_w2"), test, free_port())


def test_launcher_jax_at_world_2_reproduces_launcher_none(split, trained, launched, tested):
    root, _ = split
    (first, state0), launched = launched
    got = launched[0]["train"]
    assert got["step"] == first["state"].step == 2
    np.testing.assert_allclose(got["losses"], first["losses"], rtol=1e-4)
    assert [os.path.basename(p) for p in got["ckpts"]] == ["checkpoint_epoch_0.pth"]
    saved = torch.load(got["ckpts"][0], weights_only=False)["model_state"]
    cfg = cfg_from_yaml_file(str(root / "tiny.yaml"))
    lr = build_lr_schedule(cfg.OPTIMIZATION, 2)
    params = {n for n, _ in first["state"].model.named_parameters()}
    for k, v in state0.items():
        assert torch.equal(got["state_dict"][k], launched[1]["train"]["state_dict"][k]), k
        if k.endswith("num_batches_tracked"):
            continue
        tol = 2 * (lr(0) + lr(1)) if k in params else 1e-4
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), atol=tol,
                                   rtol=0 if k in params else 1e-4, err_msg=k)
    # the saved file is the weights the ranks hold
    model, _ = build_detector(tiny_detector_cfg(), device="cpu")
    TR.load_weights(model, got["ckpts"][0])
    for k, v in model.state_dict().items():
        assert torch.equal(v, got["state_dict"][k]), k
    assert set(saved) >= {k for k in state0 if not k.endswith("num_batches_tracked")}

    report, ap, recall = tested[1]
    for rank in launched:
        w_report, w_ap, w_recall = rank["test"]
        assert w_recall == recall and recall["num_gt"] > 0 and "Car" in w_report
        assert set(w_ap) == set(ap)
        for c in ap:
            for m in ap[c]:
                np.testing.assert_allclose([w_ap[c][m][d] for d in sorted(ap[c][m])],
                                           [ap[c][m][d] for d in sorted(ap[c][m])], atol=1e-4)
