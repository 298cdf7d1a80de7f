"""SECOND-IoU in the port (seevcn_torch.models.detectors.second) against the
JAX package on the CPU, at ``_tiny_detector_cfg``.

Weights: a state dict in the reference's layout with random values
(chip_smoke.seeded_state_dict with random_stats: conv weights at
fan-in scale, not symmetric; biases and BN affine and running statistics
random, so a wrong BN eps or a transposed layout shows), carried into flax
by the JAX package's importer and back by the port's exporter. Inputs: two
frames of car-sized point blobs on a ground plane (chip_smoke.blob_points,
numpy from a seed), small enough that no capacity of the JAX rulebook mode
truncates.

Tolerances: f32 outputs agree to 1e-5 (rtol 1e-5; box centres and sizes
atol 1e-4); only the order of sums differs. Kept sets, labels and masks
after both NMS passes are equal. With the bf16 backbone (flagship DTYPE)
pre-NMS outputs agree to atol 2e-3, rtol 1e-3: each stored activation is
rounded to bf16 (8 bits of mantissa) in both, at places where the two
frameworks' f32 sums may round differently.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import (_flagship_detector_cfg, _mini_detector_cfg,
                             _tiny_detector_cfg)
from chip_smoke import (LIDAR_TO_CAM, blob_points, make_scene,
                        seeded_state_dict, seeded_vcn_state_dict)
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.utils.ckpt_compat import detector_variables_from_torch
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector, post_processing
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.see.frame import see_and_detect
from seevcn_torch.testing import assert_close, to_torch
from seevcn_torch.utils.weights import detector_state_dict_from_flax

B, P = 2, 600
PRE_NMS = ("batch_cls_preds", "batch_box_preds", "spatial_features_2d")


@pytest.fixture(scope="module")
def weights():
    model, _ = build_detector(C.tiny_detector_cfg(), device="cpu")
    ref_sd = seeded_state_dict(0, model, random_stats=True)
    variables = jax.tree.map(np.asarray,
                             detector_variables_from_torch(ref_sd, "SECONDNetIoU"))
    frames = [blob_points(seed, P) for seed in (1, 2)]
    scene = tuple(np.stack(x) for x in zip(*frames))
    return ref_sd, variables, scene


def _jax_run(cfg, variables, pts, valid):
    model, _ = jax_build(cfg)
    out = model.apply(jax.tree.map(jnp.asarray, variables), jnp.asarray(pts),
                      jnp.asarray(valid), train=False)
    pp = jax_post(out, cfg.MODEL.POST_PROCESSING, 1, has_roi_head=True)
    return out, pp


def _port_run(cfg, variables, pts, valid):
    model, _ = build_detector(cfg, detector_state_dict_from_flax(variables),
                              device="cpu")
    with torch.no_grad():
        out = model(to_torch(pts), to_torch(valid))
        pp = post_processing(out, cfg.MODEL.POST_PROCESSING, 1, True)
    return out, pp


@pytest.mark.parametrize("name", ["mini", "flagship", "tiny"])
def test_config_copies_equal_graft_entry(name):
    ours = getattr(C, f"{name}_detector_cfg")()
    ref = {"mini": _mini_detector_cfg, "flagship": _flagship_detector_cfg,
           "tiny": _tiny_detector_cfg}[name]()
    assert ours == ref
    assert type(ours).__module__.startswith("seevcn_torch")


def test_weight_export_loads_strict(weights):
    ref_sd, variables, _ = weights
    sd = detector_state_dict_from_flax(variables)
    assert set(sd) == set(ref_sd)
    for k, v in ref_sd.items():          # flax -> reference layouts, exactly
        assert_close(sd[k], v, name=k)
    model, _ = build_detector(C.tiny_detector_cfg(), sd, device="cpu")
    for k, v in model.state_dict().items():
        assert_close(v, ref_sd[k], name=k)
    # the flagship's modules take the same keys outside its deeper 2D
    # backbone (LAYER_NUMS [5, 5]), at its widths
    flagship, _ = build_detector(C.flagship_detector_cfg(), device="cpu")
    assert {k for k in flagship.state_dict() if ".blocks." not in k} \
        == {k for k in sd if ".blocks." not in k}
    assert "backbone_2d.blocks.1.17.running_var" in flagship.state_dict()
    assert flagship.backbone_2d.blocks[0][1].in_channels == 128   # 1 z level


@pytest.mark.parametrize("mode", ["sparse", "zfold"])
def test_second_iou_matches_jax(weights, mode):
    _, variables, (pts, valid) = weights
    cfg = _tiny_detector_cfg()
    cfg.MODEL.BACKBONE_3D["MODE"] = mode
    jo, jp = _jax_run(cfg, variables, pts, valid)
    to, tp = _port_run(C.tiny_detector_cfg(), variables, pts, valid)
    # precondition: the rulebook mode's capacities (the input's rows) were
    # not reached, so both JAX modes compute the same active sets
    assert (to["active_voxels"] <= B * 512).all()
    assert to["active_voxels"][0] > 100
    # precondition: no direction logit pair near a tie
    d = np.asarray(jo["head_out"]["dir_cls_preds"]).reshape(B, -1, 2)
    assert (np.abs(d[..., 0] - d[..., 1]) > 1e-4).all()

    for k in ("cls_preds", "box_preds", "dir_cls_preds"):
        assert_close(to["head_out"][k], np.array(jo["head_out"][k]), atol=1e-5,
                     rtol=1e-5, name=k)
    assert_close(to["spatial_features_2d"], np.array(jo["spatial_features_2d"]),
                 atol=1e-5, rtol=1e-5, name="bev2d")
    assert_close(to["batch_cls_preds"], np.array(jo["batch_cls_preds"]),
                 atol=1e-5, rtol=1e-5, name="cls")
    assert_close(to["batch_box_preds"], np.array(jo["batch_box_preds"]),
                 atol=1e-4, rtol=1e-5, name="boxes")
    for k in ("roi_mask", "roi_labels"):
        assert_close(to[k], np.array(jo[k]), name=k)
    assert_close(to["rois"], np.array(jo["rois"]), atol=1e-4, rtol=1e-5, name="rois")
    assert_close(to["rcnn_iou"], np.array(jo["rcnn_iou"]), atol=1e-5, rtol=1e-5,
                 name="rcnn_iou")
    for k in ("pred_mask", "pred_labels"):
        assert_close(tp[k], np.array(jp[k]), name=k)
    assert_close(tp["pred_boxes"], np.array(jp["pred_boxes"]), atol=1e-4,
                 rtol=1e-5, name="pred_boxes")
    assert_close(tp["pred_scores"], np.array(jp["pred_scores"]), atol=1e-5,
                 name="pred_scores")
    kept = int(tp["pred_mask"].sum())
    assert 0 < kept < int(tp["pred_mask"].numel())   # the final NMS suppressed


def test_second_iou_bf16_matches_jax(weights):
    _, variables, (pts, valid) = weights
    cfg = _tiny_detector_cfg()
    cfg.MODEL.BACKBONE_3D["DTYPE"] = "bfloat16"          # MODE zfold
    jo, _ = _jax_run(cfg, variables, pts, valid)
    ours = C.tiny_detector_cfg()
    ours.MODEL.BACKBONE_3D["DTYPE"] = "bfloat16"
    to, _ = _port_run(ours, variables, pts, valid)
    f32, _ = _port_run(C.tiny_detector_cfg(), variables, pts, valid)
    for k in PRE_NMS + ("rcnn_iou",):
        assert_close(to[k], np.array(jo[k]).astype(np.float32), atol=2e-3,
                     rtol=1e-3, name=k)
    # and bf16 is really on: it moves the BEV off the f32 result
    assert (to["spatial_features_2d"] - f32["spatial_features_2d"]).abs().max() > 1e-5


def test_see_and_detect_matches_jax_detector(weights):
    """The slice as a whole on the CPU: a SEE frame, then the detector on
    its output cloud, against the JAX detector on that same cloud (the SEE
    frame itself is held against JAX in test_torch_frame.py)."""
    _, variables, _ = weights
    img = (96, 128)
    proj = np.array([[72.0, 0, 64.0, 0], [0, 72.0, 47.5, 0], [0, 0, 1.0, 0]],
                    np.float32)
    scene = make_scene(3, 4096, 4, image_size=img, proj=proj, pts_per_car=300)
    vcn = VCNInference("VCN_VC", seeded_vcn_state_dict(0, num_coarse=128),
                       num_points=128, device="cpu")
    cfg = C.tiny_detector_cfg()
    det, _ = build_detector(cfg, detector_state_dict_from_flax(variables),
                            device="cpu")
    t = {k: to_torch(v) for k, v in scene.items()}
    pp, stats, new_pts, new_valid = see_and_detect(
        t["points"], t["valid"], t["det_boxes"], t["det_masks"],
        t["det_scores"], vcn, to_torch(proj), to_torch(LIDAR_TO_CAM), det, cfg,
        img, device="cpu", max_instance_pts=256, out_pts=128, cand_cap=512)
    assert new_pts.shape == (4096 + 4 * 128, 3)
    _, jp = _jax_run(_tiny_detector_cfg(), variables, new_pts[None].numpy(),
                     new_valid[None].numpy())
    for k in ("pred_mask", "pred_labels"):
        assert_close(pp[k], np.array(jp[k]), name=k)
    assert_close(pp["pred_boxes"], np.array(jp["pred_boxes"]), atol=1e-4,
                 rtol=1e-5, name="pred_boxes")
    assert_close(pp["pred_scores"], np.array(jp["pred_scores"]), atol=1e-5,
                 name="pred_scores")
    assert int(pp["pred_mask"].sum()) > 0 and bool(stats["inst_valid"].any())
