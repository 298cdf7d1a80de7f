"""Voxel R-CNN in the port (seevcn_torch.models.detectors.voxelrcnn) against
the JAX package on the CPU: the RoI head's pooled features and outputs in
eval and in training, the whole tiny model's eval forward and
post-processing, ``detect_stage``'s branches for CenterPoint and Voxel
R-CNN, the full-width configurations, and one train step.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init (``jax.eval_shape``, no init compile), carried into the port by
``voxel_rcnn_state_dict_from_flax``. Inputs: numpy from a seed
(chip_smoke.blob_points; the head alone on voxel stages drawn here). Every
JAX model call is jitted. The tiny config keeps every pooled stage's
active voxels under JAX's extraction capacity (asserted), where JAX would
truncate and the port would not (ROADMAP §3).

Tolerances: pooled features, head outputs, proposals and boxes within
1e-5 of the tensor's largest |value| (f32, sums in another order); running
statistics 1e-5 (absolute and relative); proposal and kept masks and
labels equal. The train step, the port in f64 against JAX's f32 (JAX's
sparse convs pin f32), as tests/test_torch_pvrcnn_train.py holds PV-RCNN's:
loss terms 1e-5, gradients 5e-4 of the tensor's largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import blob_points, pvrcnn_train_inputs
from seevcn_tpu.models.detectors import voxelrcnn as JVR
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.ops import sparse as JSP
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors import voxelrcnn as VR
from seevcn_torch.models.detectors.pvrcnn import jax_stage_width
from seevcn_torch.models.detectors.second import build_detector, post_processing
from seevcn_torch.ops import sparse as SP
from seevcn_torch.see.frame import detect_stage
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy, to_torch
from seevcn_torch.train.train import create_train_state, train_forward
from seevcn_torch.utils import weights as W
from test_torch_pvrcnn_train import _argmax_routed_max_pool

CHANNELS = {"x_conv2": 32, "x_conv3": 64, "x_conv4": 64}


def _rel(got, ref, name, tol=1e-5):
    ref = to_numpy(ref)
    assert_close(got, ref, atol=tol * float(np.abs(ref).max()) + 1e-12, name=name)


def _frames(seeds=(1, 2)):
    frames = [blob_points(s, 600) for s in seeds]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


# --- the RoI head alone --------------------------------------------------------


def _stage(rng, name, width, centre, extent, vs, pcr, per_frame):
    """A stage tensor of ``width`` rows: ``per_frame`` distinct voxels a
    frame on the stage's lattice in a box ``extent`` (voxels) around
    ``centre`` (m), frame 0's rows then frame 1's, padding rows (zeros)
    scattered among them; as numpy (features, coords, mask)."""
    ds = VR.STAGE_STRIDES[name]
    base = [int((centre[i] - pcr[i]) / (vs[i] * ds)) for i in range(3)]
    rows = []
    for b in range(2):
        cells = rng.choice(np.prod(extent), per_frame, replace=False)
        x, rest = cells % extent[0], cells // extent[0]
        y, z = rest % extent[1], rest // extent[1]
        rows.append(np.stack([np.full(per_frame, b), z + base[2], y + base[1],
                              x + base[0]], 1))
    coords = np.zeros((width, 4), np.int32)
    mask = np.zeros(width, bool)
    live = np.sort(rng.choice(width, 2 * per_frame, replace=False))
    coords[live] = np.concatenate(rows)
    mask[live] = True
    feats = np.where(mask[:, None], rng.randn(width, CHANNELS[name]), 0).astype(np.float32)
    return feats, coords, mask


def _rois(rng, centre, n=3):
    rois = np.concatenate([centre + rng.uniform(-1.5, 1.5, (2, n, 3)) * [1, 1, 0.2],
                           rng.uniform([3.2, 1.5, 1.4], [4.5, 1.9, 1.7], (2, n, 3)),
                           rng.uniform(-3, 3, (2, n, 1))], -1)
    return rois.astype(np.float32)


def _head_case(case):
    """(roi_cfg, pcr, vs, rois, {name: (feats, coords, mask)}, width)."""
    rng = np.random.RandomState(0)
    if case == "jax_grid_width":
        # the full config's x_conv2 pool on 2 x 5,000 voxels near (60, 20) m
        # in a 20,000-row tensor: JAX's width runs its hash grid (the
        # difference form), the frames' compacted 5,000 rows would not
        cfg = C.voxel_rcnn_detector_cfg()
        roi = cfg.MODEL.ROI_HEAD
        roi.ROI_GRID_POOL.FEATURES_SOURCE = ["x_conv2"]
        roi.ROI_GRID_POOL.PRE_MLP = False
        pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
        vs = cfg.DATA_CONFIG.DATA_PROCESSOR[0].VOXEL_SIZE
        centre, width = np.float32([60.0, 20.0, -0.8]), 20000
        stages = {"x_conv2": _stage(rng, "x_conv2", width, centre - [2.5, 1.25, 0.4],
                                    (50, 25, 8), vs, pcr, 5000)}
    else:
        cfg = C.tiny_voxel_rcnn_cfg()
        roi = cfg.MODEL.ROI_HEAD
        pcr = cfg.DATA_CONFIG.POINT_CLOUD_RANGE
        vs = cfg.DATA_CONFIG.DATA_PROCESSOR[0].VOXEL_SIZE
        centre, width = np.float32([8.0, 0.0, -0.5]), 1536
        stages = {n: _stage(rng, n, width, centre - np.float32([4, 4, 1.5]), ext, vs, pcr, k)
                  for n, ext, k in (("x_conv2", (8, 8, 10), 300), ("x_conv3", (4, 4, 5), 60),
                                    ("x_conv4", (2, 2, 3), 10))}
    roi.DP_RATIO = 0.0
    return roi, pcr, vs, _rois(rng, centre), stages, width


def _jax_head(roi, pcr, vs, rois, stages, train, seed=3):
    jm = JVR.VoxelRCNNHead(roi_cfg=roi, point_cloud_range=tuple(pcr), voxel_size=tuple(vs))
    ms = {n: JSP.SparseTensor(jnp.asarray(f), jnp.asarray(c), jnp.asarray(m), (41, 1600, 1408),
                              2) for n, (f, c, m) in stages.items()}
    shapes = jax.eval_shape(lambda r: jm.init(jax.random.PRNGKey(0), r, ms), jnp.asarray(rois))
    variables = jax.tree.map(jnp.asarray, seeded_flax_variables(shapes, seed=seed))
    (cls, reg), st = jax.jit(lambda v, r: jm.apply(
        v, r, ms, train, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name is not None
        and mdl.name.startswith("pool_")))(variables, jnp.asarray(rois))
    pooled = {n[len("pool_"):]: np.asarray(v["__call__"][0])
              for n, v in st["intermediates"].items()}
    return variables, cls, reg, pooled, st["batch_stats"]


def _port_head(roi, pcr, vs, variables, train, batch_stats=None):
    sd = {}
    W._voxel_rcnn_head(sd, "h", jax.tree.map(np.asarray, variables["params"]),
                       jax.tree.map(np.asarray, batch_stats or variables["batch_stats"]))
    head = VR.VoxelRCNNHead(roi, pcr, vs, {**CHANNELS, "x_conv1": 16})
    if batch_stats is None:
        head.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    head.train(train)
    return head, {k[2:]: v for k, v in sd.items()}


@pytest.mark.parametrize("case,train", [("tiny", False), ("tiny", True),
                                        ("jax_grid_width", False)],
                         ids=["tiny_eval", "tiny_train", "jax_grid_width"])
def test_voxel_rcnn_head_matches_jax(case, train):
    """JAX's VoxelRCNNHead on padded stage tensors (padding rows among the
    frames' rows) against the port's on the same stages: each source's
    pooled features (grid-major per RoI), rcnn_cls and rcnn_reg; in
    training (PRE_MLP's batch norm over the padded width, the FC stacks'
    over the RoIs) the running statistics too. ``jax_grid_width``: the ball
    query's form follows ``width``, JAX's padded row count: with it the
    port equals JAX; with the frames' compacted row count (below JAX's grid
    threshold, so the Gram form) its pooled features read otherwise."""
    roi, pcr, vs, rois, stages, width = _head_case(case)
    variables, cls, reg, pooled, new_stats = _jax_head(roi, pcr, vs, rois, stages, train)
    head, _ = _port_head(roi, pcr, vs, variables, train)
    ms = {n: SP.SparseTensor(to_torch(f), to_torch(c), to_torch(m), (41, 1600, 1408), 2)
          for n, (f, c, m) in stages.items()}
    with torch.no_grad():
        got = head.pool(to_torch(rois), ms, width)
        got_cls, got_reg = head.head(got)
    parts = torch.split(got, [head.get_submodule(f"pool_{n}").out_channels
                              for n in head.sources], -1)
    for n, part in zip(head.sources, parts):
        _rel(part.reshape(2, -1, part.shape[-1]), pooled[n], f"pooled {n}")
    _rel(got_cls, cls, "rcnn_cls")
    _rel(got_reg, reg, "rcnn_reg")
    if train:
        _, after = _port_head(roi, pcr, vs, variables, train, batch_stats=new_stats)
        for n, b in head.named_buffers():
            if n.endswith("running_mean") or n.endswith("running_var"):
                assert_close(b, after[n], atol=1e-5, rtol=1e-5, name=n)
        assert "pre_bn_x_conv2.running_var" in after
    if case == "jax_grid_width":
        assert width >= 16384 > int(stages["x_conv2"][2].sum()) // 2
        head.eval()
        with torch.no_grad():
            compacted = head.pool(to_torch(rois), ms, 5000)
        assert (compacted - got).abs().max() > 1e-3


# --- the whole model -----------------------------------------------------------------


_BUILT = {}


def _built():
    if not _BUILT:
        cfg = C.tiny_voxel_rcnn_cfg()
        jm, _ = jax_build(cfg)
        pts, valid = _frames()
        shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                     p, v, train=False),
                                jnp.asarray(pts), jnp.asarray(valid))
        variables = seeded_flax_variables(shapes, seed=0)
        model, dcfg = build_detector(cfg, W.voxel_rcnn_state_dict_from_flax(variables),
                                     device="cpu")
        _BUILT.update(cfg=cfg, dcfg=dcfg, jm=jm, variables=variables, model=model)
    return _BUILT


def test_voxel_rcnn_eval_matches_jax():
    """The tiny Voxel R-CNN's eval forward (anchor head, proposals, RoI head,
    refined boxes) and its post-processing (the RCNN branch, scored by the
    class logit's sigmoid), against JAX's; every pooled stage's active
    voxels stay under JAX's extraction capacity."""
    b = _built()
    cfg, model = b["cfg"], b["model"]
    pts, valid = _frames()
    ref = jax.jit(lambda v, p, q: b["jm"].apply(v, p, q, train=False))(
        jax.tree.map(jnp.asarray, b["variables"]), jnp.asarray(pts), jnp.asarray(valid))
    with torch.no_grad():
        out = model(to_torch(pts), to_torch(valid))
    cap = jax_stage_width(b["dcfg"], 2)
    assert cap == 1536 and int(out["active_voxels"][2:5].max()) < cap
    for k in ("batch_cls_preds", "batch_box_preds", "roi_scores", "rcnn_cls", "rcnn_reg",
              "rcnn_iou", "rois"):
        _rel(out[k], ref[k], k)
    for k in ("roi_mask", "roi_labels"):
        assert_close(out[k], np.asarray(ref[k]), name=k)
    post = cfg.MODEL.POST_PROCESSING
    pr = jax_post(ref, post, 1, has_roi_head=True)
    pp = post_processing(out, post, 1, has_roi_head=True)
    for k in ("pred_mask", "pred_labels"):
        assert_close(pp[k], np.asarray(pr[k]), name=k)
    for k in ("pred_boxes", "pred_scores"):
        _rel(pp[k], pr[k], k)
    assert int(out["roi_mask"].sum()) == 16 and int(pp["pred_mask"].sum()) > 0


def test_detect_stage_branches():
    """``detect_stage`` takes the dense branch for CenterPoint (no ROI_HEAD;
    the decoded labels kept) and the RCNN branch for Voxel R-CNN, each equal
    to post_processing called with that branch."""
    pts, valid = _frames((3,))
    for cfg in (C.tiny_centerpoint_cfg(), C.tiny_voxel_rcnn_cfg()):
        model, _ = build_detector(cfg, device="cpu")
        pp, out = detect_stage(model, cfg, to_torch(pts[0]), to_torch(valid[0]), device="cpu")
        roi = "ROI_HEAD" in cfg.MODEL
        ref = post_processing(out, cfg.MODEL.POST_PROCESSING, len(cfg.CLASS_NAMES),
                              has_roi_head=roi)
        for k in ref:
            assert torch.equal(pp[k], ref[k]), k
        assert ("rois" in out) == roi and int(pp["pred_mask"].sum()) > 0
        if not roi:
            kept = pp["pred_labels"][pp["pred_mask"]]
            assert len(set(kept.tolist())) > 1


def test_full_width_configs():
    """centerpoint.yaml's model on the flagship's grid (704 x 800 x 27: a
    128-channel BEV at 100 x 88, 512 channels into the 64-channel shared
    conv, 500 decoded peaks) and voxel_rcnn_car.yaml (1408 x 1600 x 40: a
    256-channel BEV at 200 x 176, the three pools' 96 channels at 216 grid
    points into the first 256-wide FC), each built on the card by default."""
    cp_cfg = C.centerpoint_detector_cfg()
    model, dcfg = build_detector(cp_cfg, device="cpu")
    assert list(dcfg.grid_size) == [704, 800, 27] and dcfg.max_voxels == 90000
    assert dcfg.head_logic is None
    assert type(model.backbone_3d).__name__ == "VoxelResBackBone8x"
    assert model.backbone_3d.encoded_shape(dcfg.sparse_shape) == (1, 100, 88)
    assert model.backbone_2d.blocks[0][1].weight.shape == (128, 128, 3, 3)
    assert model.dense_head.shared_conv.weight.shape == (64, 512, 3, 3)
    assert model.dense_head.sep.hm_out.weight.shape == (3, 64, 3, 3)
    assert torch.all(model.dense_head.sep.hm_out.bias == -2.19)
    assert cp_cfg.MODEL.POST_PROCESSING.MAX_OBJ_PER_SAMPLE == 500
    vr_cfg = C.voxel_rcnn_detector_cfg()
    model, dcfg = build_detector(vr_cfg, device="cpu")
    assert list(dcfg.grid_size) == [1408, 1600, 40] and dcfg.max_voxels == 40000
    assert model.backbone_2d.blocks[0][1].weight.shape == (64, 256, 3, 3)
    assert dcfg.head_logic.anchors_flat.shape == (176 * 200 * 2, 7)
    head = model.roi_head
    assert head.sources == ["x_conv2", "x_conv3", "x_conv4"] and head.grid_size == 6
    assert head.shared_fc0.weight.shape == (256, 96 * 216)
    assert head.pre_x_conv4.weight.shape == (64, 64)
    assert [head.get_submodule(f"pool_{n}").radii for n in head.sources] == \
        [(0.4,), (0.8,), (1.6,)]
    assert jax_stage_width(dcfg, 2) == 120000
    if not torch.cuda.is_available():
        for cfg in (cp_cfg, vr_cfg):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_detector(cfg)


# --- one train step ------------------------------------------------------------


def test_voxel_rcnn_train_step_matches_jax():
    """One training forward and loss of the tiny Voxel R-CNN (DP_RATIO 0) on
    two blob frames with cars near two training proposals each
    (chip_smoke.pvrcnn_train_inputs), the RoI sample's priorities JAX's own
    draws: JAX's loss terms and ``jax.value_and_grad`` gradients (its
    max-pool routed by its argmax while it traces: ROADMAP §3) against the
    port's step in f64, whose sample has foreground; the running
    statistics it leaves. No RCNN gradient reaches the 3D backbone (JAX's
    stop_gradient on the stage features). Tolerances: loss terms 1e-5
    (absolute and relative), gradients 5e-4 of the tensor's largest,
    running statistics 1e-5."""
    cfg = C.tiny_voxel_rcnn_cfg()
    cfg.MODEL.ROI_HEAD.DP_RATIO = 0.0
    jm, _ = jax_build(cfg)
    p0, v0 = _frames()
    shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                 p, v, train=False),
                            jnp.asarray(p0), jnp.asarray(v0))
    variables = jax.tree.map(jnp.asarray, seeded_flax_variables(shapes, seed=3))
    params, stats = variables["params"], variables["batch_stats"]
    export = lambda p, s: W.voxel_rcnn_state_dict_from_flax(   # noqa: E731
        jax.tree.map(np.asarray, {"params": p, "batch_stats": s}))
    pts, valid, gt = pvrcnn_train_inputs(cfg, export(params, stats))
    rng = jax.random.PRNGKey(7)
    n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
    u = np.asarray(jax.vmap(lambda r: jax.random.uniform(r, (n_rois,)))(
        jax.random.split(rng, 2)))

    def loss_fn(prm):
        out, new = jm.apply({"params": prm, "batch_stats": stats}, pts, valid, gt_boxes=gt,
                            train=True, rng=rng, mutable=["batch_stats"])
        total, tb = jm.loss(out, jnp.asarray(gt))
        return total, (tb, new["batch_stats"])

    with _argmax_routed_max_pool():
        (loss, (tb, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params)
    jax_grads, jax_after = export(grads, stats), export(params, new_stats)
    model, _ = build_detector(cfg, export(params, stats), device="cpu")
    state = create_train_state(model.double(), cfg.OPTIMIZATION, 100)
    dbl = lambda a: torch.from_numpy(np.array(a)).double()     # noqa: E731
    ploss, ptb, out = train_forward(state, dbl(pts), torch.from_numpy(valid), dbl(gt),
                                    roi_u=dbl(u))
    backbone = list(model.backbone_3d.parameters())
    rcnn_on_backbone = torch.autograd.grad(ptb["rcnn_loss"], backbone, retain_graph=True,
                                           allow_unused=True)
    assert all(g is None or not g.any() for g in rcnn_on_backbone)
    state.optimizer.zero_grad()
    ploss.backward()
    terms = {"loss": ploss.item(), **{k: v.item() for k, v in ptb.items()}}
    ref = {"loss": float(loss), **{k: float(v) for k, v in tb.items()}}
    assert set(terms) == set(ref)
    for k, v in ref.items():
        assert_close(np.float64(terms[k]), np.float64(v), atol=1e-5, rtol=1e-5, name=k)
    for n, p in model.named_parameters():
        r = jax_grads[n]
        assert_close(p.grad, r, atol=5e-4 * float(r.abs().max()) + 1e-12, name=f"grad {n}")
    for n, b in model.named_buffers():
        if n.endswith("running_mean") or n.endswith("running_var"):
            assert_close(b, jax_after[n], atol=1e-5, rtol=1e-5, name=n)
    tg = out["rcnn_targets"]
    assert int((tg["roi_sample_mask"] & tg["reg_valid_mask"]).sum()) > 0
    assert terms["rcnn_loss_reg"] > 0 and terms["rcnn_loss_corner"] > 0
    assert model.roi_head.pre_x_conv2.weight.grad.abs().max() > 0
