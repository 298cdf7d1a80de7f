"""PV-RCNN++ in the port (PVRCNNPlusPlus, the SPC sampling ops and the
VectorPool layers) against the JAX package on the CPU.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init (``jax.eval_shape``, no init compile), carried into the port by
``pvrcnn_state_dict_from_flax`` with strict=True. Inputs: numpy from a seed
(chip_smoke.blob_points for the tiny configs: 600 points a frame, 220
valid). Every JAX call of a model is jitted.

Tolerances:
- ``sample_points_with_roi_mask``'s mask, ``sector_fps_sample``'s indices,
  pick validity and sectors, and the keypoints: bit for bit;
- the VectorPool layers: 1e-5 absolute and relative (JAX's einsum and the
  port's one-hot product sum a bin's members in another order);
- the eval forward as tests/test_torch_pvrcnn.py holds PV-RCNN: features,
  logits and heads 1e-5, boxes atol 1e-4; proposals, kept sets, labels and
  masks equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import LIDAR_TO_CAM, blob_points, make_scene, seeded_vcn_state_dict
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.models.modules import pfe as JPFE
from seevcn_tpu.ops import sampling as JS
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector, post_processing
from seevcn_torch.models.modules import pfe as PFE
from seevcn_torch.models.vcn.inference import VCNInference
from seevcn_torch.ops import sampling as S
from seevcn_torch.see.frame import see_and_detect
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy, to_torch
from seevcn_torch.utils import weights as W
from seevcn_torch.utils.config import Cfg

B, NPTS = 2, 600
VARIANTS = [("SPC", True), ("SPC", False), ("FPS", True), ("FPS", False)]


def _frames(seeds=(1, 2), n=NPTS):
    frames = [blob_points(s, n) for s in seeds]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


# --- the configs and the build --------------------------------------------------


def test_plusplus_configs():
    """The full config: pv_rcnn.yaml's detector with pv_rcnn_plusplus.yaml's
    PFE: 4,096 keypoints by SPC, three two-group VectorPool layers, 512 +
    32 + 128 + 128 = 800 channels into the 90-channel fusion; the tiny
    variants build with the topology they name."""
    cfg = C.pvrcnn_plusplus_detector_cfg()
    base = C.pvrcnn_detector_cfg()
    for k in ("BACKBONE_3D", "DENSE_HEAD", "POINT_HEAD", "ROI_HEAD", "POST_PROCESSING"):
        assert cfg.MODEL[k] == base.MODEL[k], k
    assert cfg.DATA_CONFIG == base.DATA_CONFIG and cfg.OPTIMIZATION == base.OPTIMIZATION
    model, _ = build_detector(cfg, device="cpu")
    assert type(model).__name__ == "PVRCNNPlusPlus" and not model.training
    pfe = model.pfe
    assert pfe.sample_method == "SPC" and pfe.num_sectors == 6
    assert pfe.num_keypoints == 4096 and pfe.num_point_features_before_fusion == 800
    assert pfe.vsa_point_feature_fusion[0].weight.shape == (90, 800)
    assert model.roi_head.roi_grid_pool_layer.mlps[0][0].weight.shape[1] == 3 + 90
    raw, (c3, c4) = pfe.SA_rawpoints, pfe.SA_layers
    assert [type(m).__name__ for m in (raw, c3, c4)] == ["VectorPoolAggregationMSG"] * 3
    assert [g.radius for g in raw.layers] == [0.2, 0.4]
    assert [g.radius for g in c4.layers] == [2.4, 4.8]
    assert all(g.nsample == 32 for m in (raw, c3, c4) for g in m.layers)
    # the raw points carry no features (x, y, z): no reduction; a stage's 64
    # channels are reduced to 32 by each group's own Linear
    assert raw.layers[0].reduce is None and raw.layers[0].post_mlps[0].weight.shape == (32, 24)
    assert c3.layers[1].reduce.weight.shape == (32, 64)
    assert c3.layers[1].post_mlps[0].weight.shape == (64, 27 * 35)
    assert c3.msg_post_mlps[0].weight.shape == (128, 128)
    for method, vp in VARIANTS:
        m, _ = build_detector(C.tiny_pvrcnn_plusplus_cfg(method, vp), device="cpu")
        assert m.pfe.sample_method == method
        assert isinstance(m.pfe.SA_rawpoints, PFE.VectorPoolAggregationMSG if vp
                          else PFE.SALayer)


# --- the proposal-centric filter -------------------------------------------------


@pytest.mark.parametrize("case", ["masked_rows", "no_valid_roi", "on_the_radius"])
def test_sample_points_with_roi_mask_matches_jax(case):
    """Masks bit for bit: some RoI rows masked (a masked RoI near points
    must not count), none valid (nothing passes), and points placed on a
    RoI's half-diagonal + radius (the strict < decides)."""
    rng = np.random.RandomState(["masked_rows", "no_valid_roi", "on_the_radius"].index(case))
    pts = rng.uniform(-15, 15, (2000, 3)).astype(np.float32)
    rois = np.concatenate([rng.uniform(-12, 12, (10, 3)), rng.uniform(1, 5, (10, 3)),
                           rng.uniform(-3, 3, (10, 1))], 1).astype(np.float32)
    roi_mask = rng.rand(10) < 0.6
    valid = rng.rand(2000) < 0.9
    radius = 1.6
    if case == "no_valid_roi":
        roi_mask[:] = False
    if case == "on_the_radius":
        roi_mask[:] = True
        rois[:, 2] = 0.0
        # along +x from each centre, at exactly the float32 threshold and
        # one ulp either side
        reach = np.linalg.norm(rois[:, 3:6] / 2, axis=1).astype(np.float32) + np.float32(radius)
        for i in range(10):
            for j, d in enumerate((np.nextafter(reach[i], 0), reach[i],
                                   np.nextafter(reach[i], 99))):
                pts[3 * i + j] = rois[i, :3] + np.float32([d, 0, 0])
    ref = np.asarray(JS.sample_points_with_roi_mask(
        jnp.asarray(pts), jnp.asarray(rois), jnp.asarray(roi_mask), radius,
        jnp.asarray(valid)))
    got = S.sample_points_with_roi_mask(torch.from_numpy(pts), torch.from_numpy(rois),
                                        torch.from_numpy(roi_mask), radius,
                                        torch.from_numpy(valid))
    assert_close(got, ref, name="mask")
    if case == "no_valid_roi":
        assert not ref.any()
    else:
        assert 0 < ref.sum() < valid.sum()
    if case == "masked_rows":
        near_masked = S.sample_points_with_roi_mask(
            torch.from_numpy(pts), torch.from_numpy(rois), torch.ones(10, dtype=torch.bool),
            radius, torch.from_numpy(valid))
        assert (near_masked & ~got).any()


# --- the sector FPS -------------------------------------------------------------


def _sector_cloud(case):
    rng = np.random.RandomState(10 + ["uneven", "empty_sector", "fewer_than_k",
                                      "equal_quotas"].index(case))
    n, k = 3000, 256
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    valid = rng.rand(n) < 0.9
    if case == "uneven":
        pts[:2200, 0] = np.abs(pts[:2200, 0]) + 1.0
    elif case == "empty_sector":
        # y > 0: every angle in (0, pi), sectors 3-5 only; point 0 (the
        # start of an empty sector's FPS) invalid in sector 0's range
        pts[:, 1] = np.abs(pts[:, 1]) + 0.1
        pts[0] = [-10.0, -1.0, 0.0]
        valid[0] = False
    elif case == "fewer_than_k":
        n = 40
        pts, valid = pts[:n], valid[:n]
    else:
        # 100 valid points in each sector at its mid-angle: equal quotas,
        # equal scores, ties broken by the sector's position
        s = np.repeat(np.arange(6), 100)
        a = (s + 0.5) * (2 * np.pi / 6) - np.pi + rng.uniform(-0.3, 0.3, 600)
        r = rng.uniform(2, 30, 600)
        pts = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-1, 1, 600)],
                       1).astype(np.float32)
        valid = np.ones(600, bool)
        k = 90
    return pts, valid, k


@pytest.mark.parametrize("case", ["uneven", "empty_sector", "fewer_than_k",
                                  "equal_quotas"])
def test_sector_fps_sample_matches_jax(case):
    """Indices, pick validity and each point's sector bit for bit."""
    pts, valid, k = _sector_cloud(case)
    ji, jok = JS.sector_fps_sample(jnp.asarray(pts), jnp.asarray(valid), k, 6)
    ti, tok = S.sector_fps_sample(torch.from_numpy(pts), torch.from_numpy(valid), k, 6)
    assert_close(tok, np.asarray(jok), name="pick validity")
    assert_close(ti, np.asarray(ji).astype(np.int64), name="indices")
    # the JAX function's own sector expression
    ang = jnp.arctan2(jnp.asarray(pts)[:, 1], jnp.asarray(pts)[:, 0]) + np.pi
    jsec = jnp.clip(jnp.floor(ang / (2.0 * np.pi / 6)).astype(jnp.int32), 0, 5)
    sec = S.sector_ids(torch.from_numpy(pts), 6)
    assert_close(sec, np.asarray(jsec).astype(np.int64), name="sectors")
    counts = np.bincount(sec.numpy()[valid], minlength=6)
    if case == "empty_sector":
        assert (counts[:3] == 0).all() and int(tok.sum()) == k
    if case == "fewer_than_k":
        assert int(tok.sum()) == valid.sum() < k
    if case == "equal_quotas":
        assert (counts == 100).all() and int(tok.sum()) == k
    # a batch runs as one: each frame's picks are its own
    bi, bok = S.sector_fps_sample(torch.from_numpy(np.stack([pts, pts[::-1].copy()])),
                                  torch.from_numpy(np.stack([valid, valid[::-1].copy()])),
                                  k, 6)
    assert torch.equal(bi[0], ti) and torch.equal(bok[0], tok)


def test_spc_keypoints_of_a_large_cloud_match_jax():
    """More than 2^15 points under SPC: the near points are deduped on the
    0.35 m grid, then sector-FPS'd, bit for bit JAX's sample_one."""
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.uniform([0, -40, -3], [70, 40, 1], (30000, 3)),
                          rng.normal([12, 3, -1], 1.5, (10000, 3))]).astype(np.float32)
    valid = rng.rand(pts.shape[0]) < 0.95
    rois = np.concatenate([rng.uniform([5, -20, -1], [40, 20, 0], (12, 3)),
                           rng.uniform(2, 5, (12, 3)), rng.uniform(-3, 3, (12, 1))],
                          1).astype(np.float32)
    roi_mask = np.arange(12) < 10
    cfg = C.tiny_pvrcnn_plusplus_cfg("SPC")
    cfg.MODEL.PFE.NUM_KEYPOINTS = 128
    vsa = PFE.VoxelSetAbstraction(cfg.MODEL.PFE, [0, -40, -3, 70.4, 40, 1],
                                  [0.1, 0.1, 0.15], 64, 3)

    @jax.jit
    def sample_one(p, v, r, m):
        near = JS.sample_points_with_roi_mask(p, r, m, 1.6, v)
        near = jnp.where(near.any(), near, v)
        sidx, sok = JS.grid_subsample(p, near, 0.35, 1 << 15)
        sub = p[sidx]
        idx, _ = JS.sector_fps_sample(sub, sok, 128, 6)
        return sub[idx], near

    ref, near = sample_one(*(jnp.asarray(a) for a in (pts, valid, rois, roi_mask)))
    args = [torch.from_numpy(a)[None] for a in (pts, valid, rois, roi_mask)]
    assert_close(vsa.spc_candidates(*args)[0], np.asarray(near), name="candidates")
    got = vsa.sample_keypoints_spc(*args)
    assert_close(got[0], np.asarray(ref), name="keypoints")
    assert 1000 < int(np.asarray(near).sum()) < int(valid.sum())


# --- the VectorPool layers ------------------------------------------------------

_GROUPS = (Cfg({"NUM_LOCAL_VOXEL": [2, 2, 2], "MAX_NEIGHBOR_DISTANCE": 0.5,
                "NEIGHBOR_NSAMPLE": -1, "POST_MLPS": [16, 12]}),
           Cfg({"NUM_LOCAL_VOXEL": [3, 2, 3], "MAX_NEIGHBOR_DISTANCE": 0.9,
                "NEIGHBOR_NSAMPLE": 8, "POST_MLPS": [16]}))


def _vector_pool_case(layer: str, channels: int):
    """(flax module, port module, flax prefix for the exporter)."""
    reduced = 4
    if layer == "group":
        g = _GROUPS[0]
        jm = JPFE.VectorPoolAggregation(tuple(g.NUM_LOCAL_VOXEL), g.MAX_NEIGHBOR_DISTANCE,
                                        32, tuple(g.POST_MLPS), reduced)
        pm = PFE.VectorPoolAggregation(channels, g.NUM_LOCAL_VOXEL, g.MAX_NEIGHBOR_DISTANCE,
                                       32, g.POST_MLPS, reduced)
        return jm, pm
    sa = Cfg({"NAME": "VectorPoolAggregationModuleMSG", "NUM_GROUPS": 2,
              "NUM_REDUCED_CHANNELS": reduced, "MSG_POST_MLPS": [24],
              "GROUP_CFG_0": _GROUPS[0], "GROUP_CFG_1": _GROUPS[1]})
    return JPFE.build_sa_layer(sa, "msg"), PFE.build_sa_layer(sa, channels)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("layer,channels", [("group", 6), ("group", 4), ("group", 0),
                                            ("msg", 6)])
def test_vector_pool_matches_jax(layer, channels, train):
    """One VectorPool group and a two-group MSG layer (the second group
    with NEIGHBOR_NSAMPLE 8 and an uneven 3 x 2 x 3 grid), over masked
    supports of two frames: features that are reduced (6 channels to 4),
    already of the reduced width (no reduce Linear) and absent (relative
    xyz only). The output within 1e-5; in training also the running
    statistics."""
    rng = np.random.RandomState(20 + channels)
    q = rng.uniform(-2, 2, (2, 40, 3)).astype(np.float32)
    sup = rng.uniform(-2, 2, (2, 400, 3)).astype(np.float32)
    feats = rng.randn(2, 400, channels).astype(np.float32) if channels else None
    valid = rng.rand(2, 400) < 0.8
    jm, pm = _vector_pool_case(layer, channels)
    args = tuple(None if a is None else jnp.asarray(a) for a in (q, sup, feats, valid))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))
    variables = seeded_flax_variables(shapes, seed=2)
    ref, mut = jax.jit(lambda v: jm.apply(v, *args, train=train,
                                          mutable=["batch_stats"]))(
        jax.tree.map(jnp.asarray, variables))
    if layer == "group":                # the exporter reads an MSG layer's groups
        wrap = lambda t: {"group0": t}                            # noqa: E731
        variables = {k: wrap(v) for k, v in variables.items()}
        mut = {"batch_stats": wrap(mut["batch_stats"])}
        prefix = "l.layers.0."
    else:
        prefix = "l."
    sd = {}
    W._sa_layer(sd, "l", variables["params"], variables["batch_stats"])
    pm.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    assert (pm.reduce is not None) == (channels == 6) if layer == "group" else True
    pm.train(train)
    frames = [(torch.from_numpy(q[b]), torch.from_numpy(sup[b][valid[b]]),
               None if feats is None else torch.from_numpy(feats[b][valid[b]]))
              for b in range(2)]
    with torch.no_grad():
        got = pm(frames, width=400)
    assert got.shape == np.asarray(ref).shape
    assert_close(got, np.asarray(ref), atol=1e-5, rtol=1e-5, name="VectorPool output")
    assert (np.abs(np.asarray(ref)).sum(-1) > 0).mean() > 0.5
    if train:
        new = {}
        W._sa_layer(new, "l", variables["params"],
                    jax.tree.map(np.asarray, mut["batch_stats"]))
        for k, v in pm.state_dict().items():
            if "running" in k:
                assert_close(v, new[prefix + k], atol=1e-5, rtol=1e-5, name=k)


# --- the whole eval forward -------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """Per variant: seeded flax variables of the tiny PV-RCNN++ (the port's
    model loaded with them, strict), and the two blob frames."""
    pts, valid = _frames()
    out = {}
    for variant in VARIANTS:
        jm, _ = jax_build(C.tiny_pvrcnn_plusplus_cfg(*variant))
        shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                     p, v, train=False),
                                jnp.asarray(pts), jnp.asarray(valid))
        variables = seeded_flax_variables(shapes, seed=0)
        model, _ = build_detector(C.tiny_pvrcnn_plusplus_cfg(*variant),
                                  W.pvrcnn_state_dict_from_flax(variables), device="cpu")
        out[variant] = (variables, model)
    return out, (pts, valid)


_JAX_RUNS = {}


def _jax_eval(variant, variables, pts, valid):
    """JAX's eval forward with every module's output captured, and its
    post-processing; one compile a variant."""
    if variant not in _JAX_RUNS:
        cfg = C.tiny_pvrcnn_plusplus_cfg(*variant)
        jm, _ = jax_build(cfg)

        @jax.jit
        def run(v, p, pv):
            out, st = jm.apply(v, p, pv, train=False, capture_intermediates=True)
            return out, st["intermediates"], jax_post(
                out, cfg.MODEL.POST_PROCESSING, 1, has_roi_head=True)

        _JAX_RUNS[variant] = run
    return _JAX_RUNS[variant](jax.tree.map(jnp.asarray, variables), jnp.asarray(pts),
                              jnp.asarray(valid))


@pytest.mark.parametrize("variant", VARIANTS, ids=["SPC-vp", "SPC-sa", "FPS-vp", "FPS-sa"])
def test_pvrcnn_plusplus_eval_matches_jax(tiny, variant):
    """The tiny PV-RCNN++'s eval forward in each of its four topologies
    against JAX: keypoints bit for bit, the VSA's features, the point
    logits, the heads 1e-5, the boxes 1e-4, the proposals and the final
    NMS's kept set and labels equal; every source's block of the keypoint
    features live."""
    models, (pts, valid) = tiny
    variables, model = models[variant]
    jo, inter, jp = _jax_eval(variant, variables, pts, valid)
    seen = {}
    hook = model.pfe.register_forward_hook(lambda m, i, o: seen.update(vsa=o))
    try:
        with torch.no_grad():
            to = model(to_torch(pts), to_torch(valid))
            tp = post_processing(to, model.cfg.model_cfg.POST_PROCESSING, 1, True)
    finally:
        hook.remove()
    assert_close(to["keypoints"], np.asarray(jo["keypoints"]), name="keypoints")
    vsa = inter["pfe"]["__call__"][0]
    for k in ("point_features_before_fusion", "point_features"):
        assert_close(seen["vsa"][k], np.asarray(vsa[k]), atol=1e-5, rtol=1e-5, name=k)
    before = np.abs(to_numpy(seen["vsa"]["point_features_before_fusion"]))
    raw_c = model.pfe.SA_rawpoints.out_channels
    widths = [64, raw_c] + [layer.out_channels for layer in model.pfe.SA_layers]
    edges = np.cumsum([0] + widths)
    assert edges[-1] == before.shape[-1]
    for lo, hi in zip(edges[:-1], edges[1:]):
        assert (before[..., lo:hi].sum(-1) > 0).mean() > 0.5, (lo, hi)
    for k in ("batch_cls_preds", "point_logits", "rcnn_cls", "rcnn_reg", "rcnn_iou"):
        assert_close(to[k], np.asarray(jo[k]), atol=1e-5, rtol=1e-5, name=k)
    for k in ("batch_box_preds", "rois"):
        assert_close(to[k], np.asarray(jo[k]), atol=1e-4, rtol=1e-5, name=k)
    for k in ("roi_mask", "roi_labels"):
        assert_close(to[k], np.asarray(jo[k]), name=k)
    for k in ("pred_mask", "pred_labels"):
        assert_close(tp[k], np.asarray(jp[k]), name=k)
    assert_close(tp["pred_boxes"], np.asarray(jp["pred_boxes"]), atol=1e-4, rtol=1e-5,
                 name="pred_boxes")
    assert_close(tp["pred_scores"], np.asarray(jp["pred_scores"]), atol=1e-5,
                 name="pred_scores")
    assert int(to["roi_mask"].sum()) > 4 and int(tp["pred_mask"].sum()) > 0
    if variant[0] == "SPC":
        # the keypoints come from the points near the proposals, not from
        # every valid point
        with torch.no_grad():
            rois = model.rpn(to_torch(pts), to_torch(valid))["props"]["rois"][..., :7]
        near = model.pfe.spc_candidates(to_torch(pts), to_torch(valid), rois,
                                        to["roi_mask"])
        assert 0 < int(near.sum()) < int(valid.sum())


def test_pvrcnn_plusplus_on_the_completed_frame_matches_jax(tiny):
    """The slice as a whole on the CPU: a SEE frame, then the tiny PV-RCNN++
    (SPC + VectorPool) on its output cloud through ``see_and_detect``,
    against JAX's PV-RCNN++ on that same cloud."""
    models, _ = tiny
    variant = ("SPC", True)
    variables, model = models[variant]
    img = (96, 128)
    proj = np.array([[72.0, 0, 64.0, 0], [0, 72.0, 47.5, 0], [0, 0, 1.0, 0]], np.float32)
    scene = make_scene(3, 4096, 4, image_size=img, proj=proj, pts_per_car=300)
    vcn = VCNInference("VCN_VC", seeded_vcn_state_dict(0, num_coarse=128),
                       num_points=128, device="cpu")
    t = {k: to_torch(v) for k, v in scene.items()}
    pp, stats, new_pts, new_valid = see_and_detect(
        t["points"], t["valid"], t["det_boxes"], t["det_masks"], t["det_scores"],
        vcn, to_torch(proj), to_torch(LIDAR_TO_CAM), model,
        C.tiny_pvrcnn_plusplus_cfg(*variant), img, device="cpu", max_instance_pts=256,
        out_pts=128, cand_cap=512)
    assert new_pts.shape == (4096 + 4 * 128, 3)
    jo, _, jp = _jax_eval(variant, variables, new_pts[None].numpy(),
                          new_valid[None].numpy())
    for k in ("pred_mask", "pred_labels"):
        assert_close(pp[k], np.asarray(jp[k]), name=k)
    assert_close(pp["pred_boxes"], np.asarray(jp["pred_boxes"]), atol=1e-4, rtol=1e-5,
                 name="pred_boxes")
    assert_close(pp["pred_scores"], np.asarray(jp["pred_scores"]), atol=1e-5,
                 name="pred_scores")
    assert int(pp["pred_mask"].sum()) > 0 and bool(stats["inst_valid"].any())
