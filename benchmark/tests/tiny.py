"""A copy of the benchmark's files at a size the CPU runs in seconds: the
tiny detector configs of the port's own tests, VCN at 128 points, 16-beam
patterns over a 16 m grid, pools of 4 frames. The harness's code is the
real one; only its files (BENCHMARK.json, configs, traffic, workloads,
metrics) are the copy's."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TINY_RANGE = [0, -8, -2, 16, 8, 2]


def _tiny_detector(det: dict, voxel) -> dict:
    det = copy.deepcopy(det)
    det["DATA_CONFIG"]["POINT_CLOUD_RANGE"] = TINY_RANGE
    vox = det["DATA_CONFIG"]["DATA_PROCESSOR"][0]
    vox["VOXEL_SIZE"] = voxel
    vox["MAX_NUMBER_OF_VOXELS"] = {"train": 512, "test": 512}
    b2 = det["MODEL"]["BACKBONE_2D"]
    b2["LAYER_NUMS"], b2["NUM_FILTERS"], b2["NUM_UPSAMPLE_FILTERS"] = [1, 1], [16, 32], [16, 16]
    roi = det["MODEL"].get("ROI_HEAD")
    if roi:
        roi["SHARED_FC"], roi["IOU_FC"] = [32, 32], [32, 32]
        roi["NMS_CONFIG"]["TRAIN"]["NMS_PRE_MAXSIZE"] = 128
        roi["NMS_CONFIG"]["TRAIN"]["NMS_POST_MAXSIZE"] = 32
        roi["NMS_CONFIG"]["TEST"]["NMS_PRE_MAXSIZE"] = 64
        roi["NMS_CONFIG"]["TEST"]["NMS_POST_MAXSIZE"] = 16
        roi["TARGET_CONFIG"]["ROI_PER_IMAGE"] = 16
    post = det["MODEL"]["POST_PROCESSING"]
    post["NMS_CONFIG"]["NMS_PRE_MAXSIZE"], post["NMS_CONFIG"]["NMS_POST_MAXSIZE"] = 128, 16
    if "MAX_OBJ_PER_SAMPLE" in post:
        post["MAX_OBJ_PER_SAMPLE"] = 64
    return det


def make_tiny_copy(dst: Path) -> Path:
    """-> the copy's benchmark directory (its BENCHMARK.json beside it)."""
    bench = dst / "benchmark"
    for sub in ("configs", "traffic", "workloads", "metrics", "roofline"):
        shutil.copytree(BENCH / sub, bench / sub, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, voxel in (("second_iou", [0.5, 0.5, 0.1]), ("second_iou_f32", [0.5, 0.5, 0.1])):
        p = bench / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["detector"] = _tiny_detector(c["detector"], voxel)
        if "see" in c:
            for v in ("det_vcn", "gt_vcn"):
                c["see"][v]["num_points"] = 128
            c["see"]["max_instance_pts"] = 256
        c["train_total_steps"] = 50
        p.write_text(json.dumps(c))
    for name in ("waymo_top64", "kitti_hdl64"):
        p = bench / "traffic" / "patterns" / f"{name}.json"
        pat = json.loads(p.read_text())
        pat["beams"], pat["columns_per_turn"] = 16, 720
        p.write_text(json.dumps(pat))
    for name in ("waymo_completed", "waymo_gt", "kitti_det"):
        p = bench / "traffic" / f"{name}.json"
        mix = json.loads(p.read_text())
        mix["pool"] = 4
        mix["cars"].update(mean=2, max=4, x_m=[4.0, 14.0], y_abs_m=6.0)
        mix["structures"]["count"] = [1, 2]
        mix["capacity"] = 16 * 180 + (4 * 1024 if mix["complete"] else 0)
        mix["min_car_hits"] = 3
        p.write_text(json.dumps(mix))
    for p in (bench / "workloads").glob("*.json"):
        w = json.loads(p.read_text())
        w.update(warmup_steps=0, warmup_frames=1, warmup_calls=0, check_frames=2, check_calls=1,
                 frames_per_call=2)
        if w.get("roi_rows"):
            w["roi_rows"] = 32
        p.write_text(json.dumps(w))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench
