"""The port's devkit-free nuScenes, Lyft and Waymo metrics
(seevcn_torch.data.{nuscenes,lyft,waymo}_eval) and the evaluations of the
generic datasets (seevcn_torch.data.generic) against the JAX package on
the CPU.

Data: seeded frames of two classes (numpy RandomState), detections made
from the ground truth in five ways: perfect, shifted (centre, size and
heading noise), duplicated (a lower-scored copy of each), missed (half the
objects dropped, false positives added) and empty (frames without ground
truth, without detections, or without either). The datasets read infos
pkls written here; their predictions go through generate_prediction_dicts.

Tolerances: the metrics to 1e-6 (the Waymo IoU is f32 in both packages,
on the CPU). JAX's waymo_eval raises TypeError on a frame without a
detection of a class (its match masks are float empty arrays); the port
holds there, and its result equals JAX's on the same ground truth moved
into a frame with detections, 500 m from all of them, which the matching
cannot tell apart. The evaluations on fewer frames than the split are the
port's pinned departure: they equal JAX's evaluation of a split of just the
predicted frames, where JAX's on the whole split scores other frames.
"""
import pickle

import numpy as np
import pytest

from seevcn_tpu.data import generic as JG
from seevcn_tpu.data import lyft_eval as JL
from seevcn_tpu.data import nuscenes_eval as JN
from seevcn_tpu.data import waymo_eval as JW
from seevcn_tpu.utils.config import Cfg as JCfg
from seevcn_torch.data import generic as TG
from seevcn_torch.data import lyft_eval as TL
from seevcn_torch.data import nuscenes_eval as TN
from seevcn_torch.data import waymo_eval as TW
from seevcn_torch.utils.config import Cfg

KINDS = ("perfect", "shifted", "duplicated", "missed", "empty")
CLASSES = {"nuscenes": ("car", "pedestrian"), "lyft": ("car", "pedestrian"),
           "waymo": ("Vehicle", "Pedestrian")}
DIMS = {0: (4.2, 1.9, 1.6), 1: (0.8, 0.7, 1.8)}


def _frames(kind: str, classes, seed: int = 0, n_frames: int = 5):
    """-> (gt annos, det annos) a frame: boxes (x y z dx dy dz heading),
    names, num_points_in_gt; scores."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    for f in range(n_frames):
        n = rng.randint(2, 5)
        cls = np.array([0, 1] + list(rng.randint(0, 2, n - 2)))
        b = np.zeros((n, 7))
        b[:, 0] = rng.uniform(5, 60, n)
        b[:, 1] = rng.uniform(-20, 20, n)
        b[:, 2] = rng.uniform(-1, 0.5, n)
        b[:, 3:6] = [DIMS[c] for c in cls]
        b[:, 3:6] *= rng.uniform(0.9, 1.1, (n, 3))
        b[:, 6] = rng.uniform(-np.pi, np.pi, n)
        npts = rng.randint(1, 60, n)
        d, dc = b.copy(), cls.copy()
        if kind == "shifted":
            d[:, :2] += rng.uniform(-0.6, 0.6, (n, 2))
            d[:, 3:6] *= rng.uniform(0.85, 1.15, (n, 3))
            d[:, 6] += rng.uniform(-0.6, 0.6, n)
        elif kind == "duplicated":
            d = np.concatenate([d, d + rng.uniform(-0.2, 0.2, d.shape)])
            dc = np.concatenate([dc, dc])
        elif kind == "missed":
            keep = np.arange(n) % 2 == 0
            keep[:2] = True                      # one of each class stays
            fp = b[:2].copy()
            fp[:, 0] += 30.0
            d, dc = np.concatenate([d[keep], fp]), np.concatenate([dc[keep], cls[:2]])
        scores = rng.uniform(0.05, 1.0, len(d))
        if kind == "empty" and f % 3 == 1:       # ground truth, no detection
            d, dc, scores = d[:0], dc[:0], scores[:0]
        if kind == "empty" and f % 3 == 2:       # detections, no ground truth
            b, cls, npts = b[:0], cls[:0], npts[:0]
        gts.append({"name": np.array([classes[c] for c in cls], dtype="<U16"),
                    "gt_boxes_lidar": b, "num_points_in_gt": npts})
        dets.append({"name": np.array([classes[c] for c in dc], dtype="<U16"),
                     "boxes_lidar": d, "score": scores})
    if kind == "empty":                          # and a frame with neither
        gts.append({"name": np.array([], "<U16"), "gt_boxes_lidar": np.zeros((0, 7)),
                    "num_points_in_gt": np.zeros(0, int)})
        dets.append({"name": np.array([], "<U16"), "boxes_lidar": np.zeros((0, 7)),
                     "score": np.zeros(0)})
    return gts, dets


def _same_results(got: dict, ref: dict, tol: float = 1e-6):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= tol, (k, got[k], ref[k])


def _moved_out_of_empty_frames(gts, dets):
    """The ground truth of the frames without detections moved into the
    first frame with detections, 500 m beyond every box there: the frames
    the JAX Waymo metric can score, with the same matches."""
    host = next(f for f, d in enumerate(dets) if len(d["name"]))
    gts = [dict(g) for g in gts]
    for f, d in enumerate(dets):
        if f != host and not len(d["name"]) and len(gts[f]["name"]):
            moved = gts[f]["gt_boxes_lidar"].copy()
            moved[:, 0] += 500.0
            g = gts[host]
            g["name"] = np.concatenate([g["name"], gts[f]["name"]])
            g["gt_boxes_lidar"] = np.concatenate([g["gt_boxes_lidar"], moved])
            g["num_points_in_gt"] = np.concatenate([g["num_points_in_gt"],
                                                    gts[f]["num_points_in_gt"]])
            gts[f] = {"name": np.array([], "<U16"), "gt_boxes_lidar": np.zeros((0, 7)),
                      "num_points_in_gt": np.zeros(0, int)}
    keep = [f for f, d in enumerate(dets) if len(d["name"])]
    return [gts[f] for f in keep], [dets[f] for f in keep]


@pytest.mark.parametrize("kind", KINDS)
def test_nuscenes_eval_matches_jax(kind):
    gts, dets = _frames(kind, CLASSES["nuscenes"], seed=1)
    got, ref = (m(dets, gts, list(CLASSES["nuscenes"])) for m in (TN.nuscenes_eval,
                                                                     JN.nuscenes_eval))
    assert got[0] == ref[0]
    _same_results(got[1], ref[1])
    if kind == "perfect":
        assert got[1]["mAP"] > 0.95 and got[1]["NDS"] > 0.95


@pytest.mark.parametrize("kind", KINDS)
def test_lyft_eval_matches_jax(kind):
    gts, dets = _frames(kind, CLASSES["lyft"], seed=2)
    got, ref = (m(dets, gts, list(CLASSES["lyft"]), iou_thresholds=[0.3, 0.5, 0.7])
                for m in (TL.lyft_eval, JL.lyft_eval))
    assert got[0] == ref[0]
    _same_results(got[1], ref[1])
    # the default EVAL_LYFT_IOU_LIST, 0.5 .. 0.95
    _same_results(TL.lyft_eval(dets, gts, ["car"])[1], JL.lyft_eval(dets, gts, ["car"])[1])
    for a, b in zip(gts[0]["gt_boxes_lidar"], dets[0]["boxes_lidar"]):
        assert abs(TL.iou_3d(a, b) - JL.iou_3d(a, b)) <= 1e-12


@pytest.mark.parametrize("kind", KINDS)
def test_waymo_eval_matches_jax(kind):
    classes = list(CLASSES["waymo"])
    gts, dets = _frames(kind, classes, seed=3)
    got = TW.waymo_eval(dets, gts, classes, device="cpu")
    if kind == "empty":
        with pytest.raises(TypeError):
            JW.waymo_eval(dets, gts, classes)
        m_gts, m_dets = _moved_out_of_empty_frames(gts, dets)
        ref = JW.waymo_eval(m_dets, m_gts, classes)
    else:
        ref = JW.waymo_eval(dets, gts, classes)
    assert got[0] == ref[0]
    _same_results(got[1], ref[1])
    assert TW.near_threshold_pairs(dets, gts, classes, device="cpu") == []
    if kind == "perfect":
        assert min(got[1].values()) > 0.95


def test_waymo_overlap_matrix_matches_jax():
    gts, dets = _frames("shifted", CLASSES["waymo"], seed=4)
    got = TW._overlap_matrix(gts[0]["gt_boxes_lidar"], dets[0]["boxes_lidar"], device="cpu")
    ref = JW._overlap_matrix(gts[0]["gt_boxes_lidar"], dets[0]["boxes_lidar"])
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert (got > 0.3).sum() >= 2


# ---------------------------------------------------------------------------
# the datasets' evaluations
# ---------------------------------------------------------------------------

def _infos(domain: str, gts) -> list:
    out = []
    for f, g in enumerate(gts):
        boxes = np.asarray(g["gt_boxes_lidar"], np.float32)
        if domain == "custom":
            out.append({"point_cloud": {"lidar_idx": f"{f:06d}"},
                        "annos": {"name": g["name"], "gt_boxes_lidar": boxes,
                                  "num_points_in_gt": g["num_points_in_gt"]}})
        elif domain == "waymo":
            out.append({"point_cloud": {"lidar_sequence": "segment-9", "sample_idx": f},
                        "frame_id": f"segment-9_{f:03d}",
                        "annos": {"name": g["name"], "gt_boxes_lidar": boxes,
                                  "num_points_in_gt": g["num_points_in_gt"],
                                  "difficulty": np.where(g["num_points_in_gt"] <= 5, 2, 1)}})
        else:                                    # nuscenes / lyft: a token, no lidar_idx
            out.append({"token": f"tok{f}", "lidar_path": f"samples/{f}.bin",
                        "gt_boxes": boxes, "gt_names": g["name"],
                        "num_lidar_pts": g["num_points_in_gt"]})
    return out


DATASETS = {  # case id: (domain, dataset class name, EVAL_METRIC, class names)
    "custom": ("custom", "CustomDataset", None, ["Car", "Pedestrian"]),
    "nuscenes-kitti": ("nuscenes", "NuScenesDataset", "kitti", ["car", "pedestrian"]),
    "nuscenes": ("nuscenes", "NuScenesDataset", "nuscenes", ["car", "pedestrian"]),
    "lyft-kitti": ("lyft", "LyftDataset", "kitti", ["car", "pedestrian"]),
    "lyft": ("lyft", "LyftDataset", "lyft", ["car", "pedestrian"]),
    "waymo-kitti": ("waymo", "WaymoDataset", "kitti", ["Vehicle", "Pedestrian"]),
    "waymo": ("waymo", "WaymoDataset", "waymo", ["Vehicle", "Pedestrian"]),
}


def _datasets(tmp_path, case: str, n_frames: int = 5):
    """-> (the port's dataset, JAX's, the prediction dicts a frame, class
    names) over seeded 'shifted' frames."""
    domain, name, metric, classes = DATASETS[case]
    gts, dets = _frames("shifted", classes, seed=7, n_frames=n_frames)
    path = tmp_path / f"{case}_infos.pkl"
    with open(path, "wb") as f:
        pickle.dump(_infos(domain, gts), f)
    cfg = {"DATASET": name, "DATA_PATH": str(tmp_path),
           "POINT_CLOUD_RANGE": [-75.2, -75.2, -2, 75.2, 75.2, 4],
           "POINT_FEATURE_ENCODING": {"used_feature_list": ["x", "y", "z"],
                                      "src_feature_list": ["x", "y", "z", "intensity"]},
           "DATA_PROCESSOR": [], "INFO_PATH": {"train": [], "test": [path.name]},
           "EVAL_LYFT_IOU_LIST": [0.3, 0.5, 0.7]}
    if metric:
        cfg["EVAL_METRIC"] = metric
    t = getattr(TG, name)(Cfg(cfg), classes, False, max_points=64, max_boxes=8)
    j = getattr(JG, name)(JCfg(cfg), classes, False, max_points=64, max_boxes=8)
    preds = [{"pred_boxes": d["boxes_lidar"].astype(np.float32),
              "pred_scores": d["score"].astype(np.float32),
              "pred_labels": np.array([classes.index(c) + 1 for c in d["name"]], np.int64)}
             for d in dets]
    return t, j, preds, classes


def _same_eval(got, ref):
    if isinstance(ref[1].get(next(iter(ref[1]))), dict):       # the KITTI protocol
        assert got[0] == ref[0]
        assert sorted(got[1]) == sorted(ref[1])
        for c in ref[1]:
            assert sorted(got[1][c]) == sorted(ref[1][c])
            for m in ref[1][c]:
                _same_results(got[1][c][m], ref[1][c][m])
    else:
        assert got[0] == ref[0]
        _same_results(got[1], ref[1])


@pytest.mark.parametrize("case", list(DATASETS))
def test_dataset_evaluation_matches_jax(tmp_path, case):
    t, j, preds, classes = _datasets(tmp_path, case)
    if case == "waymo-kitti":
        # JAX keeps the name Vehicle, which the KITTI protocol cannot score;
        # the port maps it to Car as the reference does: JAX's evaluation of
        # the same frames named Car is the port's
        frames = list(range(len(preds)))
        with pytest.raises(KeyError, match="Vehicle"):
            j.evaluation(j.generate_prediction_dicts(frames, preds, classes), classes)
        for info in j.infos:
            info["annos"]["name"] = np.where(info["annos"]["name"] == "Vehicle", "Car",
                                             info["annos"]["name"])
        got = t.evaluation(t.generate_prediction_dicts(frames, preds, classes), classes,
                           device="cpu")
        jc = ["Car", "Pedestrian"]
        _same_eval(got, j.evaluation(j.generate_prediction_dicts(frames, preds, jc), jc))
        return
    frames = list(range(len(preds)))
    t_annos = t.generate_prediction_dicts(frames, preds, classes, device="cpu")
    j_annos = j.generate_prediction_dicts(frames, preds, classes)
    for a, b in zip(t_annos, j_annos):
        assert sorted(a) == sorted(b) and a["frame_id"] == b["frame_id"]
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    got, ref = t.evaluation(t_annos, classes, device="cpu"), j.evaluation(j_annos, classes)
    _same_eval(got, ref)
    if DATASETS[case][2] in (None, "kitti"):
        assert any(v > 0 for c in got[1].values() for m in c.values() for v in m.values())
    else:
        assert max(got[1].values()) > 0


def test_frame_ids_of_items_and_predictions(tmp_path):
    """__getitem__'s frame_id is JAX's (the token on nuScenes); the
    predictions' frame_id, which the evaluation keys on, is the index."""
    t, j, preds, classes = _datasets(tmp_path, "nuscenes")
    annos = t.generate_prediction_dicts([0, 1], preds[:2], classes)
    assert [a["frame_id"] for a in annos] == [t.prediction_frame_id(i) for i in (0, 1)] \
        == ["0", "1"]
    assert [a["frame_id"] for a in j.generate_prediction_dicts([0, 1], preds[:2], classes)] \
        == ["0", "1"]
    for k in range(2):
        assert t.infos[k]["token"] == f"tok{k}"
        assert str(t.infos[k].get("point_cloud", {}).get(
            "lidar_idx", t.infos[k].get("token", k))) == f"tok{k}"
    with pytest.raises(KeyError):
        t.evaluation([{k: v for k, v in annos[0].items() if k != "frame_id"}], classes,
                     device="cpu")


@pytest.mark.parametrize("case", ["custom", "nuscenes", "lyft", "waymo"])
def test_fewer_frames_departure(tmp_path, case):
    """Predictions of frames 1 and 3 of 5: the port scores them against
    their own ground truth, as JAX scores a split of just those frames;
    JAX's evaluation of the whole split pairs them with frames 0 and 1
    (or raises)."""
    t, j, preds, classes = _datasets(tmp_path, case)
    sub = [1, 3]
    t_annos = t.generate_prediction_dicts(sub, [preds[i] for i in sub], classes)
    j_annos = j.generate_prediction_dicts(sub, [preds[i] for i in sub], classes)
    got = t.evaluation(t_annos, classes, device="cpu")
    j_sub = _datasets(tmp_path, case)[1]
    j_sub.infos = [j_sub.infos[i] for i in sub]
    _same_eval(got, j_sub.evaluation(j_annos, classes))
    try:
        wrong = j.evaluation(j_annos, classes)
    except (IndexError, ValueError, TypeError):
        return
    with pytest.raises(AssertionError):
        _same_eval(got, wrong)
