"""CenterPoint in the port (seevcn_torch.models.modules.center_head,
seevcn_torch.models.detectors.centerpoint, the dense branch of
post_processing for its decoded boxes) against the JAX package on the CPU.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init (``jax.eval_shape``, no init compile), carried into the port by
``centerpoint_state_dict_from_flax``. Inputs: numpy from a seed
(chip_smoke.blob_points and chip_smoke.single_stage_train_inputs). Every
JAX model call is jitted.

Tolerances: the radius, the targets and the decoded boxes within 1e-5 of
the tensor's largest |value| (f32, the same operations); centre pixels,
validity, labels and the order of the top k equal; head maps and BEV
features 1e-5 of the largest; the losses 1e-5 (relative) and their
gradients 1e-5 of the largest. The train step, the port in f64 against
JAX's f32 (JAX's sparse convs pin f32): loss terms 1e-5 (absolute and
relative), gradients 5e-4 of the tensor's largest, running statistics
1e-5.

Post-processing departs from JAX on purpose (ROADMAP §3): the port reads
the decoded probabilities and labels as they are, where JAX takes a second
sigmoid and labels every box 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import blob_points, single_stage_train_inputs
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.models.modules import center_head as JC
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector, post_processing
from seevcn_torch.models.modules import center_head as TC
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy, to_torch
from seevcn_torch.train.train import create_train_state, train_forward
from seevcn_torch.utils.weights import centerpoint_state_dict_from_flax

PCR, VS, STRIDE = (0, -8, -2, 16, 8, 2), (0.25, 0.25, 0.1), 8     # an 8 x 8 map


def _rel(got, ref, name, tol=1e-5):
    ref = to_numpy(ref)
    assert_close(got, ref, atol=tol * float(np.abs(ref).max()) + 1e-12, name=name)


def _frames(seeds=(1, 2)):
    frames = [blob_points(s, 600) for s in seeds]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


_BUILT = {}


def _built():
    """(cfg, JAX model, seeded flax variables, the port's model), once."""
    if not _BUILT:
        cfg = C.tiny_centerpoint_cfg()
        jm, _ = jax_build(cfg)
        pts, valid = _frames()
        shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                     p, v, train=False),
                                jnp.asarray(pts), jnp.asarray(valid))
        variables = seeded_flax_variables(shapes, seed=0)
        model, _ = build_detector(cfg, centerpoint_state_dict_from_flax(variables),
                                  device="cpu")
        _BUILT.update(cfg=cfg, jm=jm, variables=variables, model=model)
    return _BUILT


def _gt_boxes():
    """Two frames of boxes of the three classes: in frame 0 one on the
    map's last column and row (x 15.9, y 7.9), one outside the map (x 17),
    a padding row; in frame 1 two boxes in one pixel and a tiny box."""
    gt = np.zeros((2, 6, 8), np.float32)
    gt[0, 0] = [8.0, 0.0, -0.5, 4.0, 1.8, 1.5, 0.3, 1]
    gt[0, 1] = [15.9, 7.9, -0.6, 0.8, 0.6, 1.7, 1.2, 2]
    gt[0, 2] = [17.0, 1.0, -0.6, 1.7, 0.6, 1.7, -0.4, 3]
    gt[0, 3] = [3.1, -5.2, -0.6, 1.7, 0.6, 1.7, 2.9, 3]
    gt[1, 0] = [5.0, 3.0, -0.5, 3.9, 1.7, 1.5, -1.2, 1]
    gt[1, 1] = [5.6, 3.4, -0.5, 0.8, 0.6, 1.7, 0.1, 2]
    gt[1, 2] = [12.0, -6.0, -0.6, 0.05, 0.05, 0.3, 0.0, 1]
    return gt


def test_gaussian_radius_matches_jax():
    rng = np.random.RandomState(0)
    dx = rng.uniform(0.01, 30, 500).astype(np.float32)
    dy = rng.uniform(0.01, 30, 500).astype(np.float32)
    for ov in (0.1, 0.7):
        ref = np.asarray(JC.gaussian_radius(jnp.asarray(dx), jnp.asarray(dy), ov))
        _rel(TC.gaussian_radius(to_torch(dx), to_torch(dy), ov), ref, f"radius {ov}")


def test_make_center_targets_match_jax():
    """Heatmaps, regression targets, centre pixels and validity of every
    box: the edge box keeps its pixel (7, 7), the box outside the map and
    the padding row are invalid and splat nothing, and two boxes of one
    pixel's neighbourhood take the max."""
    gt = _gt_boxes()
    mask = np.abs(gt).sum(-1) > 0
    for b in range(2):
        ref = JC.make_center_targets(jnp.asarray(gt[b]), jnp.asarray(mask[b]), (8, 8), PCR,
                                     VS, STRIDE, 3)
        got = TC.make_center_targets(to_torch(gt[b]), to_torch(mask[b]), (8, 8), PCR, VS,
                                     STRIDE, 3)
        _rel(got[0], ref[0], "heatmap")
        _rel(got[1], ref[1], "regression targets")
        assert_close(got[2], np.asarray(ref[2]), name="centre pixels")
        assert_close(got[3], np.asarray(ref[3]), name="valid")
    assert got[3].tolist() == [True, True, True, False, False, False]
    heat, _, yx, ok = TC.make_center_targets(to_torch(gt[0]), to_torch(mask[0]), (8, 8),
                                             PCR, VS, STRIDE, 3)
    assert ok.tolist() == [True, True, False, True, False, False]
    assert yx[1].tolist() == [7, 7] and float(heat[7, 7, 1]) == 1.0
    assert float(heat[..., 0].max()) == 1.0 and (heat >= 0).all()


def _maps(seed, b=2, h=8, w=8, c=3):
    rng = np.random.RandomState(seed)
    return {"hm": rng.randn(b, h, w, c).astype(np.float32) * 2,
            "center": rng.rand(b, h, w, 2).astype(np.float32),
            "center_z": rng.randn(b, h, w, 1).astype(np.float32),
            "dim": rng.randn(b, h, w, 3).astype(np.float32) * 0.5,
            "rot": rng.randn(b, h, w, 2).astype(np.float32)}


def test_center_losses_match_jax():
    """The focal loss alone, and ``center_head_loss`` over two frames: the
    value of each term and its gradient with respect to every map."""
    maps = _maps(3)
    gt = _gt_boxes()
    mask = np.abs(gt).sum(-1) > 0
    heat = JC.make_center_targets(jnp.asarray(gt[0]), jnp.asarray(mask[0]), (8, 8), PCR, VS,
                                  STRIDE, 3)[0]
    ref, ref_g = jax.value_and_grad(JC.centernet_focal_loss)(jnp.asarray(maps["hm"][0]), heat)
    hm = to_torch(maps["hm"][0]).requires_grad_()
    got = TC.centernet_focal_loss(hm, to_torch(np.asarray(heat)))
    got.backward()
    assert_close(got.detach(), np.asarray(ref), rtol=1e-5, name="focal loss")
    _rel(hm.grad, ref_g, "d focal / d hm")

    def jax_fn(m):
        return JC.center_head_loss(m, jnp.asarray(gt), jnp.asarray(mask), (8, 8), PCR, VS,
                                   STRIDE, 3)

    (ref_hm, ref_reg), vjp = jax.vjp(jax_fn, {k: jnp.asarray(v) for k, v in maps.items()})
    tm = {k: to_torch(v).requires_grad_() for k, v in maps.items()}
    got_hm, got_reg = TC.center_head_loss(tm, to_torch(gt), to_torch(mask), (8, 8), PCR, VS,
                                          STRIDE, 3)
    assert_close(got_hm.detach(), np.asarray(ref_hm), rtol=1e-5, name="hm loss")
    assert_close(got_reg.detach(), np.asarray(ref_reg), rtol=1e-5, name="reg loss")
    (got_hm + 2 * got_reg).backward()
    grads = vjp((jnp.float32(1.0), jnp.float32(2.0)))[0]
    for k, g in grads.items():
        _rel(tm[k].grad, g, f"d loss / d {k}")
    assert float(ref_reg) > 0


@pytest.mark.parametrize("case", ["few_peaks", "random"])
def test_decode_center_boxes_matches_jax(case):
    """``few_peaks``: a heatmap rising along the flattened pixels (each
    channel's one local maximum its last pixel) with five peaks on it (two
    of them tied neighbours, both kept), k 20: the zero rows after the
    peaks follow JAX's top_k order (the lower index first). ``random``: k
    50 of 192 cells. Boxes, probabilities and labels equal JAX's."""
    maps = _maps(4)
    k = 50
    if case == "few_peaks":
        ramp = -4 + 0.05 * np.arange(64, dtype=np.float32).reshape(8, 8)
        hm = np.broadcast_to(ramp[None, :, :, None], (2, 8, 8, 3)).copy()
        for b, y, x, c, v in ((0, 1, 1, 0, 3.0), (0, 5, 6, 2, 1.0), (0, 5, 7, 2, 1.0),
                              (1, 0, 7, 1, 2.0), (1, 7, 0, 0, -1.0)):
            hm[b, y, x, c] = v
        maps["hm"], k = hm, 20
    ref = JC.decode_center_boxes({k_: jnp.asarray(v) for k_, v in maps.items()}, PCR, VS,
                                 STRIDE, k=k)
    got = TC.decode_center_boxes({k_: to_torch(v) for k_, v in maps.items()}, PCR, VS,
                                 STRIDE, k=k)
    _rel(got[0], ref[0], "boxes")
    assert_close(got[1], np.asarray(ref[1]), atol=1e-7, name="probabilities")
    assert_close(got[2], np.asarray(ref[2]), name="labels")
    if case == "few_peaks":
        assert (to_numpy(got[1]) > 0).sum(1).tolist() == [6, 5]
        assert (to_numpy(got[1])[:, 6:] == 0).all()


def _eval():
    b = _built()
    pts, valid = _frames()
    ref = jax.jit(lambda v, p, q: b["jm"].apply(v, p, q, train=False))(
        jax.tree.map(jnp.asarray, b["variables"]), jnp.asarray(pts), jnp.asarray(valid))
    with torch.no_grad():
        out = b["model"](to_torch(pts), to_torch(valid))
    return b["cfg"], ref, out


def test_centerpoint_eval_matches_jax():
    """The tiny CenterPoint's eval forward: every head map, and the decoded
    boxes, probabilities and labels (k 64 of 192 cells, more than the
    peaks, so the zero rows' order is JAX's too)."""
    _, ref, out = _eval()
    for k, v in ref["head_out"].items():
        _rel(out["head_out"][k], v, k)
    _rel(out["batch_box_preds"], ref["batch_box_preds"], "boxes")
    _rel(out["batch_cls_preds"], ref["batch_cls_preds"], "probabilities")
    assert_close(out["batch_pred_labels"], np.asarray(ref["batch_pred_labels"]), name="labels")
    assert out["batch_box_preds"].shape == (2, 64, 7)
    assert (out["batch_cls_preds"] == 0).any()
    assert len(set(out["batch_pred_labels"].flatten().tolist())) == 3


@pytest.mark.parametrize("thresh", [0.0, 0.1], ids=["score_thresh_0", "score_thresh_0.1"])
def test_post_processing_departure(thresh):
    """The deliberate departure of ROADMAP §3 on the tiny CenterPoint's
    output. At SCORE_THRESH 0 the port keeps JAX's set in JAX's order with
    JAX's boxes; JAX labels every kept box 1 and scores it sigmoid(p), where
    the port keeps the decoded label and p. At 0.1 the port's result is
    JAX's post-processing of the logit of p (so that its sigmoid gives p
    back), with the decoded labels; JAX's own keeps boxes the threshold
    removes (their probability below it), its scores all at least 0.5."""
    cfg, ref, out = _eval()
    post = cfg.MODEL.POST_PROCESSING
    post.SCORE_THRESH = thresh
    post.NMS_CONFIG.NMS_POST_MAXSIZE = 64           # every box the NMS keeps
    got = post_processing(out, post, 3, has_roi_head=False)
    jax_pp = {k: np.asarray(v) for k, v in jax_post(ref, post, 3, has_roi_head=False).items()}
    mask = to_numpy(got["pred_mask"])
    if thresh == 0.0:
        assert_close(mask, jax_pp["pred_mask"], name="kept")
        _rel(got["pred_boxes"], jax_pp["pred_boxes"], "boxes")
        assert (jax_pp["pred_labels"][mask] == 1).all()
        assert_close(torch.sigmoid(got["pred_scores"])[got["pred_mask"]],
                     jax_pp["pred_scores"][mask], atol=1e-6, name="JAX's scores")
    else:
        p = np.clip(np.asarray(ref["batch_cls_preds"], np.float64), 1e-12, 1 - 1e-7)
        logit = {**ref, "batch_cls_preds": jnp.asarray(np.log(p / (1 - p)), jnp.float32)}
        want = {k: np.asarray(v) for k, v in jax_post(logit, post, 3, False).items()}
        assert_close(mask, want["pred_mask"], name="kept")
        _rel(got["pred_boxes"], want["pred_boxes"], "boxes")
        assert_close(got["pred_scores"], want["pred_scores"], atol=1e-6, name="scores")
        # JAX keeps boxes whose probability is below the threshold
        js = jax_pp["pred_scores"][jax_pp["pred_mask"]].astype(np.float64)
        assert (js >= 0.5).all() and (np.log(js / (1 - js)) < thresh).any()
        assert mask.sum() > 0 and (to_numpy(got["pred_scores"])[mask] >= thresh).all()
    # the decoded labels of the kept boxes: every class, none forced to 1
    labels = to_numpy(got["pred_labels"])[mask]
    assert len(set(labels.tolist())) > 1 and (labels >= 1).all()
    assert (to_numpy(got["pred_labels"])[~mask] == 0).all()


def test_centerpoint_train_step_matches_jax():
    """One training forward and loss of the tiny CenterPoint (batch norms
    in training) on two frames with cars, a pedestrian and a cyclist:
    JAX's loss terms and ``jax.value_and_grad`` gradients against the
    port's train step in f64, and the running statistics it leaves."""
    b = _built()
    cfg, jm = b["cfg"], b["jm"]
    pts, valid, gt = single_stage_train_inputs()
    pts = np.ascontiguousarray(pts)
    variables = jax.tree.map(jnp.asarray, seeded_flax_variables(
        jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), b["variables"]),
        seed=5))
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(prm):
        out, new = jm.apply({"params": prm, "batch_stats": stats}, pts, valid,
                            gt_boxes=gt, train=True, mutable=["batch_stats"])
        total, tb = jm.loss(out, jnp.asarray(gt))
        return total, (tb, new["batch_stats"])

    (loss, (tb, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    export = lambda p, s: centerpoint_state_dict_from_flax(   # noqa: E731
        jax.tree.map(np.asarray, {"params": p, "batch_stats": s}))
    jax_grads, jax_after = export(grads, stats), export(params, new_stats)
    model, _ = build_detector(cfg, export(params, stats), device="cpu")
    state = create_train_state(model.double(), cfg.OPTIMIZATION, 100)
    dbl = lambda a: torch.from_numpy(np.array(a)).double()     # noqa: E731
    ploss, ptb, _ = train_forward(state, dbl(pts), torch.from_numpy(valid), dbl(gt))
    state.optimizer.zero_grad()
    ploss.backward()
    terms = {"loss": ploss.item(), **{k: v.item() for k, v in ptb.items()}}
    ref = {"loss": float(loss), **{k: float(v) for k, v in tb.items()}}
    assert set(terms) == set(ref) == {"loss", "hm_loss", "loc_loss", "rpn_loss"}
    for k, v in ref.items():
        assert_close(np.float64(terms[k]), np.float64(v), atol=1e-5, rtol=1e-5, name=k)
    for n, p in model.named_parameters():
        r = jax_grads[n]
        if n == "dense_head.shared_conv.bias":
            # the training batch norm after the conv cancels its bias: the
            # true gradient is 0, both sides read rounding noise
            scale = float(jax_grads["dense_head.shared_conv.weight"].abs().max())
            assert p.grad.abs().max() < 1e-12 * scale and r.abs().max() < 1e-5 * scale
            continue
        assert_close(p.grad, r, atol=5e-4 * float(r.abs().max()) + 1e-12, name=f"grad {n}")
        assert p.grad.abs().max() > 0, n
    for n, buf in model.named_buffers():
        if n.endswith("running_mean") or n.endswith("running_var"):
            assert_close(buf, jax_after[n], atol=1e-5, rtol=1e-5, name=n)
    assert terms["loc_loss"] > 0
