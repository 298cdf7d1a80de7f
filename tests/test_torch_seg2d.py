"""Mask R-CNN's eval path in the port (seevcn_torch.models.seg2d) against the
JAX package on the CPU, at the reference's tiny test config
(tests/test_seg2d.py's ``_tiny_cfg``: a 96x128 image, one block a stage at
widths 16-64, FPN width 32), module by module, then the whole eval forward,
then bench.py's fused frame (masks -> SEE frame -> detector) at shrunk
shapes.

Weights: one JAX ``init_seg2d`` per module, with every bias, batch-norm
scale and batch-norm statistic replaced by random values (so no norm is an
identity and a dropped bias shows), carried across by
``seg2d_state_dict_from_flax``. Inputs are numpy from a seed.

Tolerances: f32 features agree to 1e-5 of their scale (only the order of
sums differs: rtol 1e-5, atol 1e-5 x max |ref|); boxes in pixels to 1e-4
(an exp's last bit at coordinates up to 128); probabilities to 1e-6.
Indices, kept sets, validity and slot order are equal, on inputs whose
scores lie apart by more than those tolerances or tie exactly.
"""
from dataclasses import asdict

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_detector_cfg
from chip_smoke import LIDAR_TO_CAM, make_scene, seeded_state_dict
from seevcn_tpu.models.detectors.second import build_detector as jax_build_detector
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.models.seg2d import maskrcnn as JM
from seevcn_tpu.models.seg2d.backend import build_seg2d as jax_build_seg2d
from seevcn_tpu.models.seg2d.backend import init_seg2d
from seevcn_tpu.models.vcn.nets import build_vcn as jax_build_vcn
from seevcn_tpu.see import device_pipeline as JDP
from seevcn_tpu.utils.ckpt_compat import detector_variables_from_torch
from seevcn_torch.models.detectors.configs import tiny_detector_cfg
from seevcn_torch.models.detectors.second import build_detector
from seevcn_torch.models.seg2d import backend as TB
from seevcn_torch.models.seg2d import maskrcnn as TM
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.see.frame import mask_stage, run_frame
from seevcn_torch.testing import (assert_close, seeded_seg2d_weights, tiny_seg2d_cfg, to_numpy,
                                  to_torch)
from seevcn_torch.utils.weights import (seg2d_flax_from_state_dict,
                                        seg2d_state_dict_from_flax,
                                        vcn_state_dict_from_flax)
from test_seg2d import _tiny_cfg
from test_torch_frame import CAP, IMG, OUT, PROJ, M, _pallas_within_radius, jax_frame

FEAT_RTOL = 1e-5
BOX_ATOL = 1e-4
PROB_ATOL = 1e-6


def _close_features(got, ref, name):
    ref = np.asarray(ref)
    assert_close(got, ref, atol=FEAT_RTOL * float(np.abs(ref).max()),
                 rtol=FEAT_RTOL, name=name)


def _randomize(variables, seed=4):
    """Biases and batch-norm scales, means and variances at random values.
    At seed 4 the tiny model's masks cover about half of each box, so the
    fused frame below isolates and completes its instances."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        leaf = jax.tree_util.keystr(path)
        if leaf.endswith(("['scale']", "['var']")):
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        if leaf.endswith(("['bias']", "['mean']")):
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, variables)


@pytest.fixture(scope="module")
def seg():
    """(JAX cfg, JAX model, numpy variables, jitted JAX eval forward, the
    port's model on the CPU)."""
    cfg = _tiny_cfg()
    model, _ = jax_build_seg2d(cfg)
    variables = _randomize(jax.tree.map(np.asarray, init_seg2d(model)))
    forward = jax.jit(lambda v, x: model.apply(v, x, train=False))
    port = TB.build_seg2d(tiny_seg2d_cfg(), seg2d_state_dict_from_flax(variables),
                          device="cpu")
    return cfg, model, variables, forward, port


def _sub(variables, name):
    return {k: v[name] for k, v in variables.items() if name in v}


# ---------------------------------------------------------------------------
# config, anchors, deltas, padding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["default", "tiny", "bench"])
def test_config_copy_equals_jax(name):
    ours, ref = {
        "default": (TM.Seg2DConfig(), JM.Seg2DConfig()),
        "tiny": (tiny_seg2d_cfg(), _tiny_cfg()),
        "bench": (TM.Seg2DConfig(image_size=(384, 1280), max_detections=32),
                  JM.Seg2DConfig(image_size=(384, 1280), max_detections=32)),
    }[name]
    assert asdict(ours) == asdict(ref)
    assert type(ours).__module__.startswith("seevcn_torch")


@pytest.mark.parametrize("size", [(96, 128), (72, 120), (384, 1280)])
def test_generate_anchors_2d(size):
    ours, ref = TM.generate_anchors_2d(size), JM.generate_anchors_2d(size)
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    if size == (384, 1280):
        assert sum(len(a) for a in ours) == 122_760


def test_decode_deltas():
    rng = np.random.RandomState(1)
    anchors = np.concatenate(JM.generate_anchors_2d((96, 128)))[::7]
    deltas = rng.randn(len(anchors), 4).astype(np.float32) * 3
    deltas[:40, 2:] = rng.choice([-60.0, 30.0], (40, 2))   # past the clip
    ref = np.asarray(JM.decode_deltas(jnp.asarray(deltas), jnp.asarray(anchors),
                                      (96, 128)))
    got = TM.decode_deltas(to_torch(deltas), to_torch(anchors), (96, 128))
    assert_close(got, ref, atol=BOX_ATOL, name="boxes")
    # the clip on dw/dh bites, and boxes are clipped to the image
    assert (np.abs(deltas[:, 2:] / 5) > 4).any()
    assert ref[:, 2].max() == 127 and ref[:, 0].min() == 0


@pytest.mark.parametrize("k,s,n", [(7, 2, 96), (7, 2, 95), (3, 2, 96), (3, 2, 9),
                                   (1, 2, 10), (1, 2, 9), (3, 1, 15)])
def test_same_conv_matches_flax(k, s, n):
    """flax's "SAME" padding, asymmetric for a stride-2 conv on an even size."""
    rng = np.random.RandomState(k * 100 + n)
    x = rng.randn(1, n, n + 3, 5).astype(np.float32)
    conv = fnn.Conv(4, (k, k), strides=s)
    params = conv.init(jax.random.PRNGKey(0), x)["params"]
    ref = np.asarray(conv.apply({"params": params}, x))
    port = TM.SameConv2d(5, 4, k, s)
    port.load_state_dict({"weight": torch.tensor(np.transpose(
        np.asarray(params["kernel"]), (3, 2, 0, 1))), "bias": to_torch(params["bias"])})
    with torch.no_grad():
        got = port(to_torch(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close_features(got, ref, "conv")


# ---------------------------------------------------------------------------
# RoIAlign, backbone, heads
# ---------------------------------------------------------------------------
def test_roi_align():
    rng = np.random.RandomState(2)
    strides = (4, 8, 16, 32)
    maps = [rng.randn(-(-96 // s), -(-128 // s), 8).astype(np.float32) for s in strides]
    # sqrt(wh) of 40, 150, 300 and 600 px: levels P2, P3, P4 and P5; the
    # larger ones and the shifted ones lie partly outside the map
    sides = np.repeat([40.0, 150.0, 300.0, 600.0], 6)
    x1 = rng.uniform(-40, 100, len(sides))
    y1 = rng.uniform(-30, 70, len(sides))
    rois = np.stack([x1, y1, x1 + sides, y1 + sides * rng.uniform(0.9, 1.1, len(sides))],
                    1).astype(np.float32)
    align = jax.jit(JM.roi_align, static_argnums=(1, 3))
    for size in (7, 14):
        ref = align(maps, strides, rois, size)
        got = TM.roi_align([to_torch(m) for m in maps], strides, to_torch(rois), size)
        assert got.shape == (len(rois), size, size, 8)
        _close_features(got, ref, f"roi_align {size}")
    lvl = np.clip(np.floor(4 + np.log2(np.sqrt((rois[:, 2] - rois[:, 0])
                                               * (rois[:, 3] - rois[:, 1])) / 224)), 2, 5)
    assert set(lvl) == {2, 3, 4, 5}
    assert (rois[:, 0] < 0).any() and (rois[:, 2] > 128).any()


@pytest.mark.parametrize("size", [(96, 128), (72, 120)])
def test_resnet_fpn(seg, size):
    """72x120 gives C4 5x8 and C5 3x4: the FPN's nearest upsampling does not
    double exactly, and the stride-2 convs meet odd sizes."""
    cfg, _, variables, _, port = seg
    img = np.random.RandomState(3).rand(1, *size, 3).astype(np.float32)
    fpn = JM.ResNetFPN(stage_sizes=cfg.stage_sizes, stage_channels=cfg.stage_channels,
                       fpn_channels=cfg.fpn_channels)
    ref = jax.jit(lambda v, x: fpn.apply(v, x, False))(_sub(variables, "backbone"), img)
    with torch.no_grad():
        got = port.backbone(to_torch(img).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 5
    for level, (g, r) in enumerate(zip(got, ref)):
        _close_features(g.permute(0, 2, 3, 1), r, f"P{level + 2}")
    if size == (72, 120):
        assert [tuple(r.shape[1:3]) for r in ref] == [(18, 30), (9, 15), (5, 8),
                                                       (3, 4), (2, 2)]


def test_rpn_head(seg):
    cfg, _, variables, _, port = seg
    rng = np.random.RandomState(4)
    for h, w in ((24, 32), (3, 4)):
        feat = rng.randn(1, h, w, cfg.fpn_channels).astype(np.float32)
        obj, box = JM.RPNHead(3).apply(_sub(variables, "rpn"), feat)
        with torch.no_grad():
            got_obj, got_box = port.rpn(to_torch(feat).permute(0, 3, 1, 2))
        _close_features(got_obj, obj, "objectness")
        _close_features(got_box, box, "deltas")


def test_box_head(seg):
    cfg, _, variables, _, port = seg
    feats = np.random.RandomState(5).randn(9, 7, 7, cfg.fpn_channels).astype(np.float32)
    cls, box = JM.BoxHead(cfg.num_classes, hidden=cfg.box_hidden).apply(
        _sub(variables, "box_head"), feats)
    with torch.no_grad():
        got_cls, got_box = port.box_head(to_torch(feats))
    _close_features(got_cls, cls, "class logits")
    _close_features(got_box, box, "box deltas")


def test_mask_head(seg):
    """The transposed conv ``up``: flax does not flip its kernel, torch does."""
    cfg, _, variables, _, port = seg
    feats = np.random.RandomState(6).randn(5, 14, 14, cfg.fpn_channels).astype(np.float32)
    logits, feat = JM.MaskHead(cfg.num_classes, channels=cfg.mask_channels,
                               n_convs=cfg.mask_convs).apply(_sub(variables, "mask_head"),
                                                             feats)
    with torch.no_grad():
        got, got_feat = port.mask_head(to_torch(feats))
    assert got.shape == (5, 28, 28, cfg.num_classes)
    _close_features(got, logits, "mask logits")
    _close_features(got_feat, feat, "pre-upsample feature")


def test_weight_export_keys(seg):
    _, _, variables, _, port = seg
    sd = seg2d_state_dict_from_flax(variables)
    assert set(sd) == set(port.state_dict())
    up = np.asarray(variables["params"]["mask_head"]["up"]["kernel"])
    assert_close(sd["mask_head.up.weight"],
                 np.transpose(up[::-1, ::-1], (2, 3, 0, 1)), name="up")
    assert "backbone.stage0_block0.BatchNorm_2.running_var" in sd
    # at bench.py's widths stage 0 keeps its 64 channels: no projection
    bench = TM.MaskRCNN(TM.Seg2DConfig(image_size=(384, 1280), max_detections=32))
    keys = set(bench.state_dict())
    assert "backbone.stage0_block0.Conv_2.weight" not in keys
    assert "backbone.stage1_block0.Conv_2.weight" in keys


# ---------------------------------------------------------------------------
# proposals and detections
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["random", "all_equal", "rounded"])
def test_proposals(case):
    """``all_equal`` and ``rounded`` are full of exact objectness ties:
    among equal scores the lower anchor index comes first."""
    cfg = _tiny_cfg()
    logic = JM.MaskRCNNLogic(cfg)
    rng = np.random.RandomState(7)
    n = logic.anchors.shape[0]
    obj = {"random": rng.randn(n), "all_equal": np.zeros(n),
           "rounded": np.round(rng.randn(n) * 2) / 2}[case].astype(np.float32)
    box = (rng.randn(n, 4) * 0.5).astype(np.float32)
    if case == "random":        # precondition: the top scores lie apart
        top = np.sort(obj)[::-1][:cfg.pre_nms_topk + 1]
        assert np.diff(top).min() < -1e-6
    ref = [np.asarray(x) for x in logic.proposals(jnp.asarray(obj), jnp.asarray(box))]
    anchors = to_torch(np.asarray(logic.anchors))
    got = TM.proposals(tiny_seg2d_cfg(), anchors, to_torch(obj), to_torch(box))
    assert_close(got[1], ref[1], name="valid")
    assert_close(got[0], ref[0], atol=BOX_ATOL, name="boxes")
    assert_close(got[2], ref[2], atol=PROB_ATOL, name="scores")
    assert ref[1].all()             # 32 of the 128 survive NMS


@pytest.mark.parametrize("case", ["random", "tied_logits", "two_classes"])
def test_decode_detections(case):
    """``tied_logits``: every valid RoI scores exactly 0.5 and all but a few
    are invalid at exactly 0, so NMS runs on ties and the final top-k fills
    most slots with zero-score boxes, lower indices first."""
    num_classes = 2 if case == "two_classes" else 1
    jcfg = JM.Seg2DConfig(**{**asdict(_tiny_cfg()), "num_classes": num_classes,
                             "max_detections": 12})
    rng = np.random.RandomState(8)
    r = jcfg.num_proposals
    xy = rng.uniform(0, 90, (r, 2))
    rois = np.concatenate([xy, xy + rng.uniform(8, 40, (r, 2))], 1).astype(np.float32)
    valid = rng.rand(r) > 1 / 3
    logits = rng.randn(r, num_classes + 1).astype(np.float32)
    if case == "tied_logits":
        logits[:] = 0.0
        valid &= np.arange(r) % 40 == 0
    deltas = (rng.randn(r, num_classes, 4) * 0.3).astype(np.float32)
    if case != "tied_logits":   # precondition: the valid scores lie apart
        p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        for k in range(num_classes):
            s = np.sort(p[valid, k + 1])
            assert np.diff(s).min() > 1e-5
    ref = [np.asarray(x) for x in JM.MaskRCNNLogic(jcfg).decode_detections(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(logits), jnp.asarray(deltas))]
    got = TM.decode_detections(TM.Seg2DConfig(**asdict(jcfg)), to_torch(rois),
                               to_torch(valid), to_torch(logits), to_torch(deltas))
    assert got[2].dtype == torch.int32
    assert_close(got[2], ref[2], name="classes")
    assert_close(got[1], ref[1], atol=PROB_ATOL, name="scores")
    assert_close(got[0], ref[0], atol=BOX_ATOL, name="boxes")
    if case == "tied_logits":       # zero-score slots are filled, in order
        assert (ref[1] == 0).any() and (ref[1] == 0.5).any()


def test_eval_forward_matches_jax(seg):
    cfg, _, variables, forward, port = seg
    img = np.random.RandomState(9).rand(1, 96, 128, 3).astype(np.float32)
    ref = {k: np.asarray(v) for k, v in forward(variables, img).items()}
    with torch.no_grad():
        got = port(to_torch(img))
    _close_features(got["rpn_obj"], ref["rpn_obj"], "rpn_obj")
    _close_features(got["rpn_box"], ref["rpn_box"], "rpn_box")
    # precondition: the kept detections' scores lie apart
    kept = np.sort(ref["det_scores"][ref["det_scores"] > 0])
    assert len(kept) > 1 and np.diff(kept).min() > 1e-5
    assert_close(got["det_cls"], ref["det_cls"], name="det_cls")
    assert_close(got["det_scores"], ref["det_scores"], atol=PROB_ATOL, name="det_scores")
    assert_close(got["det_boxes"], ref["det_boxes"], atol=BOX_ATOL, name="det_boxes")
    assert_close(got["det_masks"], ref["det_masks"], atol=1e-5, name="det_masks")
    assert got["det_masks"].shape == (1, cfg.max_detections, 28, 28)


@pytest.mark.parametrize("option", ["cascade_stages", "semantic_branch",
                                    "mask_info_flow", "dcn_stages"])
def test_htc_option_matches_jax(option):
    """Each HTC option alone on the tiny model, the eval forward against
    JAX's (tests/test_torch_htc.py's weights: random biases and statistics,
    offset convs seeded non-zero). ``mask_info_flow`` without a cascade
    leaves the plain model, as in the reference."""
    kw = {"cascade_stages": {"cascade_stages": 3},
          "semantic_branch": {"semantic_branch": True},
          "mask_info_flow": {"mask_info_flow": True},
          "dcn_stages": {"dcn_stages": (False, True, True, True)}}[option]
    cfg = TM.Seg2DConfig(**{**asdict(tiny_seg2d_cfg()), **kw})
    model, _ = jax_build_seg2d(JM.Seg2DConfig(**asdict(cfg)))
    sd = seeded_seg2d_weights(cfg, seed=5)
    img = np.random.RandomState(9).rand(1, 96, 128, 3).astype(np.float32)
    ref = {k: np.asarray(v) for k, v in jax.jit(lambda v, x: model.apply(
        v, x, train=False))(seg2d_flax_from_state_dict(sd), img).items()}
    with torch.no_grad():
        got = TB.build_seg2d(cfg, sd, device="cpu")(to_torch(img))
    assert set(got) == set(ref)
    kept = np.sort(ref["det_scores"][ref["det_scores"] > 0])
    assert len(kept) > 1 and np.diff(kept).min() > 1e-5
    assert_close(got["det_cls"], ref["det_cls"], name="det_cls")
    assert_close(got["det_scores"], ref["det_scores"], atol=1e-5, name="det_scores")
    assert_close(got["det_boxes"], ref["det_boxes"], atol=BOX_ATOL, name="det_boxes")
    assert_close(got["det_masks"], ref["det_masks"], atol=1e-5, name="det_masks")
    plain = set(TM.MaskRCNN(tiny_seg2d_cfg()).state_dict())
    assert (set(sd) == plain) == (option == "mask_info_flow")


# ---------------------------------------------------------------------------
# the fused frame: masks -> SEE frame -> detector
# ---------------------------------------------------------------------------
def test_run_frame_matches_jax_chain(seg, monkeypatch):
    """bench.py's frame_fused composed in JAX (mask_stage, see_stage,
    vcn_stage, replace_stage, det_stage) against ``run_frame`` on the CPU:
    the tiny seg2d on a random 96x128 image drawn as bench.py draws its
    own, the scene and VCN_VC of tests/test_torch_frame.py (P 4096, 128
    points an object), the detector at ``_tiny_detector_cfg``."""
    monkeypatch.setattr(JDP, "within_radius_mask", _pallas_within_radius)
    _, _, seg_vars, forward, seg_port = seg
    image = np.random.RandomState(0).rand(1, *IMG, 3).astype(np.float32)
    scene = make_scene(3, 4096, 4, image_size=IMG, proj=PROJ, pts_per_car=300)
    vcn_model = jax_build_vcn("VCN_VC", num_coarse=OUT)
    vcn_vars = jax.tree.map(np.asarray, jax.jit(vcn_model.init)(
        jax.random.PRNGKey(0), {"input": jnp.zeros((4, OUT, 3))}))
    det, _ = build_detector(tiny_detector_cfg(), device="cpu")
    det_sd = seeded_state_dict(0, det, random_stats=True)
    det.load_state_dict(det_sd, strict=True)

    # JAX: bench.py's chain, each stage jitted as there
    out = forward(seg_vars, image)
    masks = {"det_boxes": np.asarray(out["det_boxes"][0]),
             "det_masks": np.asarray(out["det_masks"][0]),
             "det_scores": np.asarray(out["det_scores"][0])}
    ref_pts, ref_valid, ref = jax.jit(jax_frame, static_argnums=2)(
        {**scene, **masks}, vcn_vars, vcn_model)
    jcfg = _tiny_detector_cfg()
    jdet, _ = jax_build_detector(jcfg)

    @jax.jit
    def det_stage(variables, pts, valid):
        jout = jdet.apply(variables, pts, valid, train=False)
        return jax_post(jout, jcfg.MODEL.POST_PROCESSING, 1, has_roi_head=True)

    jp = det_stage(detector_variables_from_torch(det_sd, "SECONDNetIoU"),
                   ref_pts[None], ref_valid[None])

    # the port
    vcn = VCNInference("VCN_VC", vcn_state_dict_from_flax(vcn_vars, "VCN_VC"),
                       num_points=OUT, device="cpu")
    t = {k: to_torch(v) for k, v in scene.items()}
    pp, stats, new_pts, new_valid = run_frame(
        to_torch(image), t["points"], t["valid"], seg_port, vcn, det,
        tiny_detector_cfg(), to_torch(PROJ), to_torch(LIDAR_TO_CAM), device="cpu",
        max_instance_pts=M, out_pts=OUT, cand_cap=CAP)

    for k in ("det_scores", "det_masks"):
        assert_close(stats[k], masks[k], atol=1e-5, name=k)
    assert_close(stats["det_boxes"], masks["det_boxes"], atol=BOX_ATOL, name="det_boxes")
    ref_iv = np.asarray(ref["ok"] & ref["sane"])
    assert_close(stats["inst_valid"], ref_iv, name="ok & sane")
    assert ref_iv.any()                              # an instance was completed
    assert_close(stats["completed"], ref["completed"], atol=1e-3, name="completed")
    assert_close(new_valid, np.asarray(ref_valid), name="new_valid")
    assert_close(new_pts, np.asarray(ref_pts), atol=1e-3, name="new_pts")
    for k in ("pred_mask", "pred_labels"):
        assert_close(pp[k], np.array(jp[k]), name=k)
    assert_close(pp["pred_boxes"], np.array(jp["pred_boxes"]), atol=1e-4, rtol=1e-5,
                 name="pred_boxes")
    assert_close(pp["pred_scores"], np.array(jp["pred_scores"]), atol=1e-5,
                 name="pred_scores")
    assert int(pp["pred_mask"].sum()) > 0


def test_mask_stage_returns_image_zero(seg):
    _, _, _, _, port = seg
    img = torch.from_numpy(np.random.RandomState(10).rand(2, 96, 128, 3).astype(np.float32))
    boxes, masks, scores = mask_stage(port, img, device="cpu")
    with torch.no_grad():
        one = port(img[:1])
    assert boxes.shape == (4, 4) and masks.shape == (4, 28, 28) and scores.shape == (4,)
    assert_close(scores, to_numpy(one["det_scores"][0]), atol=PROB_ATOL, name="scores")
