"""The single-stage detectors in the port (PointPillar; SECONDNet with
VoxelResBackBone8x or VoxelBackBone8xFocal and AnchorHeadSingle or
AnchorHeadMulti) and the rest of post-processing, against the JAX package on
the CPU.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init (``jax.eval_shape``, no init compile), carried into the port by
``single_stage_state_dict_from_flax``. Inputs: numpy from a seed
(chip_smoke.blob_points: 600 points a frame, 220 valid). Every JAX model
call is jitted.

Tolerances: f32 features, logits and boxes within 1e-5 of the tensor's
largest |value| (only the order of sums differs); the scatter and the pillar
maxima bit for bit; kept sets, labels and masks after NMS equal, the kept
boxes and scores within 1e-5 of the largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import blob_points
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.models.modules import backbone2d as JB2
from seevcn_tpu.models.modules import map_to_bev as JMB
from seevcn_tpu.models.modules import vfe as JV
from seevcn_tpu.utils.ckpt_compat import multi_dense_head_from_torch
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector, post_processing
from seevcn_torch.models.modules import map_to_bev as MB
from seevcn_torch.models.modules import vfe as V
from seevcn_torch.models.modules.backbone2d import BaseBEVBackbone
from seevcn_torch.see.frame import detect_stage
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy, to_torch
from seevcn_torch.utils import ckpt
from seevcn_torch.utils import weights as W
from seevcn_torch.utils.config import Cfg

CONFIGS = {"pointpillar": C.tiny_pointpillar_cfg,
           "second_multihead": C.tiny_second_multihead_cfg,
           "second_focal": C.tiny_second_focal_cfg}


def _frames(seeds=(1, 2)):
    frames = [blob_points(s, 600) for s in seeds]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def _rel(got, ref, name, tol=1e-5):
    ref = to_numpy(ref)
    assert_close(got, ref, atol=tol * float(np.abs(ref).max()) + 1e-12, name=name)


_BUILT = {}


def _built(name):
    """(JAX model, seeded flax variables, the port's model loaded with
    them), once per config."""
    if name not in _BUILT:
        cfg = CONFIGS[name]()
        jm, _ = jax_build(cfg)
        pts, valid = _frames()
        shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                     p, v, train=False),
                                jnp.asarray(pts), jnp.asarray(valid))
        variables = seeded_flax_variables(shapes, seed=0)
        model, _ = build_detector(cfg, W.single_stage_state_dict_from_flax(variables),
                                  device="cpu")
        _BUILT[name] = (cfg, jm, variables, model)
    return _BUILT[name]


# --- pillar_scatter and the pillar VFE ------------------------------------


def test_pillar_scatter_matches_jax():
    """Bit for bit: unique valid cells over two frames, masked rows whose
    coords point at live cells (they add zeros)."""
    rng = np.random.RandomState(0)
    nx, ny, b, n = 12, 10, 2, 60
    cells = rng.choice(b * ny * nx, n, replace=False)
    coords = np.stack([cells // (ny * nx), np.zeros(n, int), cells // nx % ny,
                       cells % nx], 1).astype(np.int32)
    mask = rng.rand(n) < 0.7
    coords[~mask] = coords[0]
    feats = rng.randn(n, 5).astype(np.float32)
    ref = JMB.pillar_scatter(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask),
                             b, (nx, ny))
    got = MB.pillar_scatter(to_torch(feats), to_torch(coords), to_torch(mask), b, (nx, ny))
    assert_close(got, np.asarray(ref), name="canvas")


def _vfe_inputs(seed=0, n_pillars=24, n_points=300):
    """Flat points in every one of ``n_pillars`` pillars (the last row is
    live: JAX's layer before the last reads it for dropped points), 40
    dropped points (id -1, zeroed before the first layer), and pillar 3
    holding one point four times (a tie of the pillar max)."""
    rng = np.random.RandomState(seed)
    coords = np.zeros((n_pillars, 4), np.int32)
    coords[:, 2] = rng.randint(0, 50, n_pillars)
    coords[:, 3] = rng.randint(0, 40, n_pillars)
    pid = np.concatenate([np.arange(n_pillars), rng.randint(0, n_pillars,
                                                             n_points - n_pillars)])
    pid[-40:] = -1
    centre = np.stack([(coords[:, 3] + 0.5) * 0.16, (coords[:, 2] + 0.5) * 0.16 - 39.68,
                       np.full(n_pillars, -1.0)], 1)
    pts = (centre[np.clip(pid, 0, None)] + rng.uniform(-0.08, 0.08, (n_points, 3))
           * [1, 1, 20]).astype(np.float32)
    dup = np.where(pid == 3)[0][:1]
    pid[-44:-40] = 3
    pts[-44:-40] = pts[dup]
    means = np.stack([pts[pid == i].mean(0) for i in range(n_pillars)]).astype(np.float32)
    return pts, pid.astype(np.int32), means, coords


@pytest.mark.parametrize("filters", [(16,), (8, 16)], ids=["one_layer", "two_layers"])
def test_pillar_vfe_matches_jax(filters):
    """DynamicPillarVFE in eval (running statistics) and in training (batch
    statistics over every point row, the zeroed rows of dropped points
    among them), and its gradients with respect to the points and every
    parameter: the four copies of one point tie in their pillar's max, and
    the port splits the gradient among them evenly, as JAX's scatter-max
    VJP does (not to the first maximum, as the port's masked_max_pool)."""
    pts, pid, means, coords = _vfe_inputs()
    nv = means.shape[0]
    kw = dict(num_filters=filters, voxel_size=(0.16, 0.16, 4.0),
              point_cloud_range=(0, -39.68, -3, 69.12, 39.68, 1))
    jv = JV.DynamicPillarVFE(**kw)
    args = [jnp.asarray(a) for a in (pts, pid, means, coords)]
    shapes = jax.eval_shape(lambda *a: jv.init(jax.random.PRNGKey(0), *a, nv), *args)
    variables = seeded_flax_variables(shapes, seed=1)
    sd = {k[len("vfe."):]: v for k, v in W.single_stage_state_dict_from_flax(
        {"params": {"vfe": variables["params"], "backbone_2d": {}, "dense_head": {}},
         "batch_stats": {"vfe": variables["batch_stats"], "backbone_2d": {}}}).items()}
    port = V.DynamicPillarVFE(3, filters, kw["voxel_size"], kw["point_cloud_range"])
    port.load_state_dict(sd, strict=True)
    tp, tid, tm, tc = (to_torch(a) for a in (pts, pid, means, coords))
    assert len(np.unique(pts[pid == 3], axis=0)) < (pid == 3).sum()

    for train in (False, True):
        def jax_fn(params, p):
            out = jv.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           p, *args[1:], nv, train, mutable=["batch_stats"])
            return out[0], out[1]["batch_stats"]

        (ref, stats), back = jax.vjp(jax_fn, variables["params"], args[0])
        ct = np.random.RandomState(2).randn(*ref.shape).astype(np.float32)
        gp, gx = back((jnp.asarray(ct), jax.tree.map(jnp.zeros_like, stats)))

        port.train(train)
        x = tp.clone().requires_grad_()
        port.zero_grad()
        got = port(x, tid, tm, tc, nv)
        (got * to_torch(ct)).sum().backward()
        mode = "train" if train else "eval"
        _rel(got.detach(), ref, f"features ({mode})")
        assert_close(x.grad, np.asarray(gx), atol=1e-5 * float(np.abs(gx).max()),
                     name=f"d points ({mode})")
        grads = W.single_stage_state_dict_from_flax(
            {"params": {"vfe": jax.tree.map(np.asarray, gp), "backbone_2d": {},
                        "dense_head": {}},
             "batch_stats": {"vfe": variables["batch_stats"], "backbone_2d": {}}})
        for n, p in port.named_parameters():
            r = grads[f"vfe.{n}"]
            assert_close(p.grad, r, atol=1e-5 * float(r.abs().max()), name=f"d {n} ({mode})")
        if train:
            new = W.single_stage_state_dict_from_flax(
                {"params": {"vfe": variables["params"], "backbone_2d": {}, "dense_head": {}},
                 "batch_stats": {"vfe": jax.tree.map(np.asarray, stats),
                                 "backbone_2d": {}}})
            for n, b in port.named_buffers():
                if n.endswith("running_mean") or n.endswith("running_var"):
                    assert_close(b, new[f"vfe.{n}"], atol=1e-6, rtol=1e-5, name=n)
    # the tied copies share the gradient of their pillar's max evenly
    tied = x.grad[-44:-40]
    assert_close(tied, tied[:1].expand(4, -1), atol=1e-7, name="tied copies")


# --- the 2D backbone's upsample forms --------------------------------------


@pytest.mark.parametrize("form", ["stride_below_one", "final_deblock", "no_upsample"])
def test_bev_backbone_upsample_forms_match_jax(form):
    """A stride < 1 upsample (a conv of kernel and stride round(1 / s)), a
    final transposed conv over the concat (one more upsample stride than
    levels), and no upsampling (one level): forward in eval and in training
    (batch statistics), against flax's BaseBEVBackbone."""
    kw = {"stride_below_one": dict(layer_nums=(1, 1), layer_strides=(1, 2),
                                   num_filters=(8, 12), upsample_strides=(0.5, 1),
                                   num_upsample_filters=(6, 6)),
          "final_deblock": dict(layer_nums=(1, 1), layer_strides=(2, 2), num_filters=(8, 12),
                                upsample_strides=(1, 2, 2), num_upsample_filters=(6, 6)),
          "no_upsample": dict(layer_nums=(2,), layer_strides=(1,), num_filters=(8,))}[form]
    x = np.random.RandomState(3).randn(2, 16, 12, 5).astype(np.float32)
    jm = JB2.BaseBEVBackbone(**kw)
    shapes = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a), jnp.asarray(x))
    variables = seeded_flax_variables(shapes, seed=2)
    sd = {k[len("backbone_2d."):]: v for k, v in W.single_stage_state_dict_from_flax(
        {"params": {"backbone_2d": variables["params"], "dense_head": {}},
         "batch_stats": {"backbone_2d": variables["batch_stats"]}}).items()}
    port = BaseBEVBackbone(5, kw["layer_nums"], kw["layer_strides"], kw["num_filters"],
                           kw.get("upsample_strides", ()), kw.get("num_upsample_filters", ()))
    port.load_state_dict(sd, strict=True)
    assert port.num_bev_features == jm.num_bev_features
    for train in (False, True):
        ref = jm.apply(variables, jnp.asarray(x), train, mutable=["batch_stats"])[0]
        port.train(train)
        with torch.no_grad():
            got = port(to_torch(x))
        _rel(got, ref, f"{form} ({'train' if train else 'eval'})")
    if form == "final_deblock":
        assert got.shape == (2, 16, 12, 12)


# --- the detectors' eval forward and post-processing ----------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_matches_jax(name):
    """The eval forward of each tiny detector (head maps, decoded boxes, the
    BEV features; the focal backbone's importances and new voxels too), and
    its post-processing (PointPillar and the focal SECONDNet one NMS, the
    multi-head one MULTI_CLASSES_NMS)."""
    cfg, jm, variables, model = _built(name)
    pts, valid = _frames()
    ref = jax.jit(lambda v, p, q: jm.apply(v, p, q, train=False))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(pts), jnp.asarray(valid))
    with torch.no_grad():
        out = model(to_torch(pts), to_torch(valid))
    for k in ("batch_cls_preds", "batch_box_preds", "spatial_features_2d"):
        _rel(out[k], ref[k], k)
    for k in ref["head_out"]:
        _rel(out["head_out"][k], ref["head_out"][k], k)
    if name == "second_focal":
        for i, (a, r) in enumerate(zip(out["focal_aux"], ref["focal_aux"])):
            rm = np.asarray(r["mask"])
            n = int(rm.sum())
            assert int(a["mask"].sum()) == n and a["stride"] == r["stride"] == 2 ** i
            # the valid rows lead, in key order, in both
            assert_close(a["coords"][:n], np.asarray(r["coords"])[:n], name="coords")
            _rel(a["importance"][:n], np.asarray(r["importance"])[:n], f"importance {i}")
        assert int(out["active_voxels"][1]) > int(out["active_voxels"][0])
    post = cfg.MODEL.POST_PROCESSING
    pr = jax_post(ref, post, 3, has_roi_head=False)
    pp = post_processing(out, post, 3, has_roi_head=False)
    for k in ("pred_mask", "pred_labels"):
        assert_close(pp[k], np.asarray(pr[k]), name=k)
    for k in ("pred_boxes", "pred_scores"):
        _rel(pp[k], pr[k], k)
    assert int(pp["pred_mask"].sum()) > 0


def test_multihead_scores_only_its_groups_classes():
    """AnchorHeadMulti's classes outside a group read -1e4 (sigmoid < 1e-3,
    as tests/test_multiclass.py checks JAX's), Car anchors first per
    location; the grouped keys are ckpt_compat's."""
    cfg, _, _, model = _built("second_multihead")
    pts, valid = _frames()
    with torch.no_grad():
        cls = model(to_torch(pts), to_torch(valid))["batch_cls_preds"]
    probs = torch.sigmoid(cls).reshape(2, -1, 6, 3)
    assert probs[:, :, :2, 1:].max() < 1e-3 and probs[:, :, 2:, 0].max() < 1e-3
    assert (cls.reshape(2, -1, 6, 3)[:, :, :2, 1:] == -1e4).all()
    assert probs[:, :, :2, 0].min() > 1e-3
    keys = model.state_dict()
    for k in ("dense_head.shared_conv.0.weight", "dense_head.shared_conv.1.running_var",
              "dense_head.rpn_heads.1.conv_cls.weight", "dense_head.rpn_heads.0.conv_dir_cls.bias"):
        assert k in keys, k
    assert keys["dense_head.rpn_heads.1.conv_cls.weight"].shape == (8, 16, 1, 1)


def test_grouped_head_checkpoint_both_ways(tmp_path):
    """The port's multi-head SECONDNet written as an OpenPCDet ``.pth``: the
    JAX package's ``multi_dense_head_from_torch`` reads its grouped head
    back to the flax variables it came from, and the port's loader gives a
    state dict that loads strictly and equals the model's."""
    _, _, variables, model = _built("second_multihead")
    path = str(tmp_path / "multihead.pth")
    ckpt.save_detector_checkpoint(path, model)
    sd = ckpt.load_detector_checkpoint(path)
    params, stats = multi_dense_head_from_torch(
        {k: v.numpy() for k, v in sd.items()})
    ref_p, ref_s = variables["params"]["dense_head"], variables["batch_stats"]["dense_head"]
    assert set(params) == set(ref_p)
    for k in ref_p:
        for leaf in ref_p[k]:
            assert_close(params[k][leaf], ref_p[k][leaf], name=f"{k}.{leaf}")
    assert_close(stats["shared_bn"]["var"], ref_s["shared_bn"]["var"], name="shared_bn var")
    again, _ = build_detector(CONFIGS["second_multihead"](), sd, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


# --- post-processing: per-class NMS and the RCNN score types ---------------


def _mc_out(case):
    """tests/test_multiclass.py's inputs: two near-identical boxes, one Car
    and one Pedestrian; or three separate boxes of each of two classes."""
    boxes = np.zeros((1, 8, 7), np.float32)
    logits = np.full((1, 8, 2), -10.0, np.float32)
    if case == "separate":
        for i in range(3):
            boxes[0, i] = [10 + 8 * i, 0, 0, 4.0, 2.0, 1.6, 0.0]
            logits[0, i, 0] = 4.0
            boxes[0, 3 + i] = [10 + 8 * i, 12, 0, 0.8, 0.6, 1.7, 0.0]
            logits[0, 3 + i, 1] = 3.0
    else:
        boxes[0, 0] = [10, 0, 0, 4.0, 2.0, 1.6, 0.0]
        boxes[0, 1] = [10.1, 0, 0, 4.0, 2.0, 1.6, 0.0]
        logits[0, 0, 0], logits[0, 1, 1] = 4.0, 3.0
    return {"batch_cls_preds": logits, "batch_box_preds": boxes}


@pytest.mark.parametrize("case,multi,thresh,post,want", [
    ("overlap", True, 0.1, 4, {1, 2}),
    ("overlap", False, 0.1, 4, {1}),
    ("overlap", True, [0.1, 0.999], 4, {1}),
    ("separate", True, 0.1, 3, {1, 2}),
], ids=["per_class_keeps_both", "agnostic_suppresses", "threshold_list", "post_per_class"])
def test_multi_classes_nms_matches_jax(case, multi, thresh, post, want):
    """MULTI_CLASSES_NMS keeps overlapping boxes of different classes that
    the class-agnostic NMS suppresses, honours a threshold a class, and
    keeps up to NMS_POST_MAXSIZE rows a class; every output equals JAX's
    (the stable order of the rows at score 0 too)."""
    out = _mc_out(case)
    cfg = Cfg({"SCORE_THRESH": thresh,
               "NMS_CONFIG": {"MULTI_CLASSES_NMS": multi, "NMS_TYPE": "nms_gpu",
                              "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 8,
                              "NMS_POST_MAXSIZE": post}})
    ref = jax_post({k: jnp.asarray(v) for k, v in out.items()}, cfg, 2, False)
    got = post_processing({k: to_torch(v) for k, v in out.items()}, cfg, 2, False)
    for k in got:
        assert_close(got[k], np.asarray(ref[k]), atol=1e-6, name=k)
    labels = set(got["pred_labels"][0][got["pred_mask"][0]].tolist())
    assert labels == want
    if case == "separate":
        assert got["pred_boxes"].shape[1] == 2 * 3 and int(got["pred_mask"].sum()) == 6


def _rcnn_out(seed=0, n=40):
    rng = np.random.RandomState(seed)
    rois = np.concatenate([rng.uniform([0, -10, -1], [30, 10, 0], (2, n, 3)),
                           rng.uniform([1, 0.5, 1.4], [4.5, 2.0, 1.8], (2, n, 3)),
                           rng.uniform(-3, 3, (2, n, 1))], -1).astype(np.float32)
    return {"rois": rois, "rcnn_iou": rng.randn(2, n).astype(np.float32),
            "roi_scores": rng.randn(2, n).astype(np.float32),
            "roi_labels": rng.randint(1, 4, (2, n)).astype(np.int32),
            "roi_mask": rng.rand(2, n) < 0.85}


@pytest.mark.parametrize("score_type", ["iou", "cls", "weighted_iou_cls", "num_pts_iou_cls",
                                        "score_by_class"])
def test_rcnn_score_types_match_jax(score_type):
    """Each SCORE_TYPE of the RCNN branch, on random RoIs of three classes
    (num_pts_iou_cls counts the valid points of a cloud with some RoIs
    dense, some empty)."""
    out = _rcnn_out()
    rng = np.random.RandomState(1)
    centres = out["rois"][:, :12, :3]
    pts = np.concatenate([np.repeat(centres, 15, 1) + rng.uniform(-0.4, 0.4, (2, 180, 3)),
                          rng.uniform(-20, 20, (2, 120, 3))], 1).astype(np.float32)
    pv = rng.rand(2, 300) < 0.9
    nms = {"NMS_TYPE": "nms_gpu", "MULTI_CLASSES_NMS": False, "NMS_THRESH": 0.1,
           "NMS_PRE_MAXSIZE": 32, "NMS_POST_MAXSIZE": 16, "SCORE_TYPE": score_type,
           "SCORE_WEIGHTS": {"iou": 0.7, "cls": 0.3},
           "SCORE_BY_CLASS": {"Car": "iou", "Pedestrian": "cls", "Cyclist": "cls"}}
    if score_type == "num_pts_iou_cls":
        nms["SCORE_THRESH"] = {"cls": 3, "iou": 12}
    cfg = Cfg({"SCORE_THRESH": 0.2, "NMS_CONFIG": nms})
    names = ["Car", "Pedestrian", "Cyclist"]
    ref = jax_post({k: jnp.asarray(v) for k, v in out.items()}, cfg, 3, True,
                   points=jnp.asarray(pts), points_valid=jnp.asarray(pv), class_names=names)
    got = post_processing({k: to_torch(v) for k, v in out.items()}, cfg, 3, True,
                          points=to_torch(pts), points_valid=to_torch(pv), class_names=names)
    for k in ("pred_mask", "pred_labels"):
        assert_close(got[k], np.asarray(ref[k]), name=k)
    for k in ("pred_boxes", "pred_scores"):
        assert_close(got[k], np.asarray(ref[k]), atol=1e-6, name=k)
    assert 0 < int(got["pred_mask"].sum()) < int(out["roi_mask"].sum())


def test_detect_stage_takes_its_branch_from_roi_head():
    """detect_stage reads ``"ROI_HEAD" in cfg.MODEL``: PointPillar goes
    through the branch without an RCNN head, SECOND-IoU through the RCNN
    branch, each equal to post_processing called with that branch."""
    pts, valid = _frames((3,))
    cfg, _, _, model = _built("pointpillar")
    pp, out = detect_stage(model, cfg, to_torch(pts[0]), to_torch(valid[0]), device="cpu")
    ref = post_processing(out, cfg.MODEL.POST_PROCESSING, 3, has_roi_head=False)
    for k in ref:
        assert torch.equal(pp[k], ref[k]), k
    assert "rois" not in out and int(pp["pred_mask"].sum()) > 0
    scfg = C.tiny_detector_cfg()
    second, _ = build_detector(scfg, device="cpu")
    pp, out = detect_stage(second, scfg, to_torch(pts[0]), to_torch(valid[0]), device="cpu")
    ref = post_processing(out, scfg.MODEL.POST_PROCESSING, 1, has_roi_head=True)
    for k in ref:
        assert torch.equal(pp[k], ref[k]), k
    assert "rois" in out


# --- the full-width configurations -----------------------------------------


def test_full_width_configs():
    """pointpillar.yaml's widths (a 432 x 496 grid, 9 VFE features into 64,
    384 BEV channels, 216 x 248 x 6 anchors) and the multi-head and focal
    SECONDNets' (1408 x 1600 x 40 voxels, 256 BEV channels into the 64-channel
    shared conv, 176 x 200 x 6 anchors), each built on the card by default."""
    pp_cfg = C.pointpillar_detector_cfg()
    model, dcfg = build_detector(pp_cfg, device="cpu")
    assert list(dcfg.grid_size) == [432, 496, 1] and dcfg.max_voxels == 40000
    assert model.vfe.pfn_layers[0].linear.weight.shape == (64, 9)
    assert model.backbone_2d.num_bev_features == 384
    assert dcfg.head_logic.anchors_flat.shape == (216 * 248 * 6, 7)
    mh_cfg = C.second_multihead_detector_cfg()
    model, dcfg = build_detector(mh_cfg, device="cpu")
    assert type(model.backbone_3d).__name__ == "VoxelResBackBone8x"
    assert list(dcfg.grid_size) == [1408, 1600, 40]
    assert model.dense_head.shared_conv[0].weight.shape == (64, 512, 3, 3)
    assert [h.conv_cls.weight.shape[0] for h in model.dense_head.rpn_heads] == [2, 2, 2]
    assert dcfg.head_logic.anchors_flat.shape == (176 * 200 * 6, 7)
    assert mh_cfg.MODEL.POST_PROCESSING.NMS_CONFIG.MULTI_CLASSES_NMS
    model, _ = build_detector(C.second_focal_detector_cfg(), device="cpu")
    assert type(model.backbone_3d).__name__ == "VoxelBackBone8xFocal"
    assert model.backbone_3d.conv2[2].topk == 128
    if not torch.cuda.is_available():
        for cfg in (pp_cfg, mh_cfg):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_detector(cfg)
