"""Each lidar pattern's frames repeat for a seed and differ between seeds;
the test reports their points, voxels and cars at the cells' full size."""
import json
from pathlib import Path

import pytest
import torch

from benchmark.roofline import detector as DF
from benchmark.traffic.raycast import make_pool

BENCH = Path(__file__).resolve().parents[1]
CONFIG = json.loads((BENCH / "configs" / "second_iou.json").read_text())["detector"]
PCR = CONFIG["DATA_CONFIG"]["POINT_CLOUD_RANGE"]


@pytest.mark.parametrize("traffic", ["waymo_completed", "kitti_det", "waymo_gt"])
def test_frames_repeat_for_a_seed(traffic):
    seed = 2**31 + 101
    a = make_pool(traffic, seed, PCR, "cpu")
    b = make_pool(traffic, seed, PCR, "cpu")
    c = make_pool(traffic, seed + 1, PCR, "cpu")
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
    assert not torch.equal(a["points"], c["points"])
    n = a["points"].shape[0]
    vox = [DF.backbone3d(a["points"][i], a["valid"][i], CONFIG, train=True)["voxels"]
           for i in range(min(n, 4))]
    print(f"{traffic}: points {a['counts']['points']}, cars {a['counts']['cars']}, "
          f"voxels (first 4) {vox}, detections {a['counts']['detections']}")
    assert all(v > 0 for v in a["counts"]["points"])
    assert sum(a["counts"]["truncated"]) == 0
    pts = a["points"][a["valid"]]
    lo, hi = torch.tensor(PCR[:3]), torch.tensor(PCR[3:])
    assert bool(((pts >= lo) & (pts <= hi)).all())
