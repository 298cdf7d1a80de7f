"""The harness finds cells, configurations, traffic and metrics by name,
runs a cell end to end on the CPU at the tiny size, and a cell and a metric
added as files run without an edit of any file that is there."""
import json
import math

from benchmark.harness.main import cell_spec, run_cell


def test_added_cell_and_metric_are_picked_up(tiny_bench):
    root = tiny_bench.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "second_iou_f32.train.copy", "config": "second_iou_f32",
                              "traffic": "waymo_completed", "chips": 1, "why": "a copy"})
    (tiny_bench / "workloads" / "second_iou_f32.train.copy.json").write_text(
        (tiny_bench / "workloads" / "second_iou_f32.train.json").read_text())
    for m in spec["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("second_iou_f32.train.copy")
    spec["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["second_iou_f32.train.copy"]})
    (tiny_bench / "metrics" / "steps_per_s.json").write_text(
        json.dumps({"reader": "window_rate", "count": "calls"}))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run_cell(cell_spec("second_iou_f32.train.copy", tiny_bench), 5, 0.5, False, device="cpu")
    assert set(r["metrics"]) == {"train_samples_per_s", "steps_per_s", "setup_s"}
    assert r["metrics"]["steps_per_s"]["value"] * 4 == \
        r["metrics"]["train_samples_per_s"]["value"]
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def test_see_gt_cell_reports_its_metrics(tiny_bench):
    r = run_cell(cell_spec("second_iou.see_gt", tiny_bench), 2**31 + 11, 0.5, False, device="cpu")
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in r["metrics"].values())
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["correct"], r["checks"]
