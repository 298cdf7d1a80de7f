"""PointRCNN in the port (seevcn_torch.models.detectors.pointrcnn, the
PointNet++ backbone and box coder of
seevcn_torch.models.modules.pointnet2_backbone, ``three_nn_interpolate``
and ``resample_points`` of seevcn_torch.ops.sampling) against the JAX
package on the CPU: the ops, the backbone, the RoI point pool, the tiny
model's eval forward and post-processing, and one train step.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init (``jax.eval_shape``, no init compile), carried into the port by
``pointrcnn_state_dict_from_flax``. JAX's PointRCNN is built on the port's
DetectorConfig (it reads only the model block and the class count; JAX's
own DetectorConfig needs a voxel block that pointrcnn.yaml lacks). Inputs:
numpy from a seed (chip_smoke.blob_points, chip_smoke.pvrcnn_train_inputs).
Every JAX call is jitted.

Tolerances: the three-NN interpolation 1e-6 of the largest |value|: the
port takes the Gram form with the squared norms as XLA's CPU fusion rounds
them (a fused multiply-add chain), so the distances are JAX's bit for bit,
and only the weighted sum's order differs. That matters because a query
that is also a support keeps the Gram form's rounding residue, whose
inverse dominates the weights: with the plain Gram form the interpolation
strays past this bound (the ``coincident`` case shows it).
Backbone features, point logits and boxes, proposals, RoI head outputs and
post-processed boxes and scores 1e-5 of the largest |value| (f32, sums in
another order); the pool's indices, proposal masks, labels and kept masks
equal. The train step, the port in f64 against JAX's f32: loss terms 1e-5
(absolute and relative), gradients 5e-4 of the tensor's largest, running
statistics 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import blob_points, pvrcnn_train_inputs
from seevcn_tpu.models.detectors import pointrcnn as JPR
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.models.modules import pointnet2_backbone as JPB
from seevcn_tpu.ops import sampling as JS
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors import pointrcnn as PR
from seevcn_torch.models.detectors.second import DetectorConfig, build_detector, post_processing
from seevcn_torch.models.modules import pointnet2_backbone as PB
from seevcn_torch.ops import sampling as S
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy, to_torch
from seevcn_torch.train.train import create_train_state, train_forward
from seevcn_torch.utils import weights as W


def _rel(got, ref, name, tol=1e-5):
    ref = to_numpy(ref)
    assert_close(got, ref, atol=tol * float(np.abs(ref).max()) + 1e-12, name=name)


def _frames(seeds=(1, 2)):
    frames = [blob_points(s, 600) for s in seeds]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


# --- the ops -------------------------------------------------------------------------


def _three_nn_case(case):
    rng = np.random.RandomState(0)
    q = rng.uniform(-20, 20, (900, 3)).astype(np.float32)
    valid = np.ones(300, bool)
    if case == "coincident":
        # FPS-style supports: every support is also a query
        s = q[rng.choice(900, 300, replace=False)]
    elif case == "ties":
        # a lattice: many queries sit at equal distances from several supports
        g = np.stack(np.meshgrid(*[np.arange(-3, 4)] * 3, indexing="ij"), -1).reshape(-1, 3)
        s = g[:300].astype(np.float32)
        q = (g[rng.randint(0, len(g), 900)] + rng.choice([-0.5, 0.0, 0.5], (900, 3))) \
            .astype(np.float32)
    else:                                           # invalid supports, one frame with 2
        s = q[rng.choice(900, 300, replace=False)] + np.float32(0.25)
        valid = rng.rand(300) > 0.3
    f = rng.randn(300, 8).astype(np.float32)
    return q, s, f, valid


@pytest.mark.parametrize("case", ["coincident", "ties", "invalid"])
def test_three_nn_interpolate_matches_jax(case):
    """Queries that coincide with supports (the Gram form's residue), a
    lattice with tied distances (ties to the lower index, as lax.top_k),
    and invalid supports; with two valid supports left the third pick is
    an invalid one at weight 0, as in JAX."""
    q, s, f, valid = _three_nn_case(case)
    ref = jax.jit(JS.three_nn_interpolate)(q, s, f, valid)
    got = S.three_nn_interpolate(*(to_torch(a) for a in (q, s, f, valid)))
    _rel(got, ref, "interpolated", tol=1e-6)
    d = np.asarray(jax.jit(JS.pairwise_sqdist)(q, s))
    _, ji = jax.jit(lambda d: jax.lax.top_k(-jnp.where(valid[None], d, jnp.inf), 3))(d)
    idx, dist = S.three_nn(*(to_torch(a) for a in (q, s, valid)))
    assert_close(idx, np.asarray(ji), name="three-NN indices")
    assert_close(S.gram_sqdist_fma(to_torch(q), to_torch(s)), d, name="Gram distances")
    if case == "coincident":
        # the plain Gram form's residue at the coincident points moves the
        # interpolation past this test's bound: why the port rounds as XLA
        plain = S.pairwise_sqdist(to_torch(q), to_torch(s)).gather(1, idx)
        w = 1.0 / plain.clamp_min(1e-8)
        stray = torch.einsum("nk,nkc->nc", w / w.sum(1, keepdim=True), to_torch(f)[idx])
        assert (stray - got).abs().max() > 1e-6 * np.abs(np.asarray(ref)).max()
    if case == "ties":
        assert (np.diff(np.sort(d, 1)[:, :4], axis=1) == 0).any()
    if case == "invalid":
        few = valid.copy()
        few[np.flatnonzero(few)[2:]] = False
        ref = jax.jit(JS.three_nn_interpolate)(q, s, f, few)
        got = S.three_nn_interpolate(*(to_torch(a) for a in (q, s, f, few)))
        _rel(got, ref, "two valid supports", tol=1e-6)
        assert not valid[S.three_nn(to_torch(q), to_torch(s), to_torch(few))[0][:, 2]].all()


def test_resample_points_matches_jax():
    """Without a generator, JAX's ``resample_points`` (valid rows cycled,
    in order); with one, the rows of the permutation it draws, cycled."""
    rng = np.random.RandomState(1)
    pts = rng.randn(50, 3).astype(np.float32)
    valid = rng.rand(50) > 0.6
    for n in (16, 100):
        ref = jax.jit(lambda p, v: JS.resample_points(p, v, n))(pts, valid)
        assert_close(S.resample_points(to_torch(pts), to_torch(valid), n), np.asarray(ref),
                     name=f"resample {n}")
    gen = torch.Generator().manual_seed(3)
    got = S.resample_points(to_torch(pts), to_torch(valid), 100, generator=gen)
    perm = torch.randperm(50, generator=torch.Generator().manual_seed(3))
    want = pts[perm.numpy()][valid[perm.numpy()]]
    assert_close(got, np.resize(want, (100, 3)), name="resample with a permutation")


def test_point_residual_coder_matches_jax():
    """Encode and decode with the three mean sizes, and without them."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-10, 10, (40, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-10, 10, (40, 3)), rng.uniform(0.5, 4, (40, 3)),
                            rng.uniform(-np.pi, np.pi, (40, 1))], 1).astype(np.float32)
    cls = rng.randint(1, 4, 40)
    sizes = C.pointrcnn_detector_cfg().MODEL.POINT_HEAD.TARGET_CONFIG.BOX_CODER_CONFIG.mean_size
    for use in (True, False):
        jc = JPB.PointResidualCoder(use_mean_size=use, mean_size=sizes)
        tc = PB.PointResidualCoder(use_mean_size=use, mean_size=sizes)
        enc = jax.jit(jc.encode)(boxes, pts, cls)
        got = tc.encode(to_torch(boxes), to_torch(pts), to_torch(cls))
        _rel(got, enc, f"encode {use}", tol=1e-6)
        dec = jax.jit(jc.decode)(enc, pts, cls)
        _rel(tc.decode(to_torch(np.asarray(enc)), to_torch(pts), to_torch(cls)), dec,
             f"decode {use}", tol=1e-6)


# --- the backbone and the RoI pool --------------------------------------------------


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_pointnet2_msg_matches_jax(train):
    """The tiny PointNet2MSG (two SA levels, two FP levels) on two frames,
    one with fewer valid points than the first level samples: the
    per-point features, and in training the running statistics that its
    batch norms (over all rows, padding included) leave."""
    cfg = C.tiny_pointrcnn_cfg()
    bb = cfg.MODEL.BACKBONE_3D
    jm = JPB.PointNet2MSG(sa_cfg=bb.SA_CONFIG, fp_mlps=tuple(tuple(m) for m in bb.FP_MLPS))
    pts, valid = _frames()
    valid[1, 100:] = False
    shapes = jax.eval_shape(lambda p, v: jm.init(jax.random.PRNGKey(0), p, v), pts, valid)
    variables = seeded_flax_variables(shapes, seed=2)
    ref, new = jax.jit(lambda v, p, q: jm.apply(v, p, q, train, mutable=["batch_stats"]))(
        jax.tree.map(jnp.asarray, variables), pts, valid)
    export = lambda stats: {k[len("backbone_3d."):]: v for k, v in   # noqa: E731
                            W.pointrcnn_state_dict_from_flax(_wrap(variables["params"], stats))
                            .items() if k.startswith("backbone_3d.")}
    model = PB.PointNet2MSG(bb.SA_CONFIG, bb.FP_MLPS)
    model.load_state_dict(export(variables["batch_stats"]), strict=True)
    model.train(train)
    with torch.no_grad():
        got = model(to_torch(pts), to_torch(valid))
    _rel(got, ref, "point features")
    if train:
        after = export(new["batch_stats"])
        for n, b in model.named_buffers():
            if n.endswith("running_mean") or n.endswith("running_var"):
                assert_close(b, after[n], atol=1e-5, rtol=1e-5, name=n)


def _wrap(bb_params, bb_stats):
    """A backbone's flax variables inside an otherwise empty PointRCNN tree
    (a point head of one output layer each), for the exporter."""
    head = {"cls_out": {"kernel": np.zeros((1, 1)), "bias": np.zeros(1)},
            "reg_out": {"kernel": np.zeros((1, 1)), "bias": np.zeros(1)}}
    return {"params": {"backbone_3d": bb_params, "point_head": head, "roi_head": {}},
            "batch_stats": {"backbone_3d": bb_stats, "point_head": {}}}


def test_roi_point_pool_matches_jax():
    """The RoI point pool of JAX's PointRCNNHead (its stable argsort of the
    in-box points, cycled) against ``roi_point_indices`` and the port's
    pool: an RoI with no point inside (point 0's features, zero geometry),
    one with fewer points than it samples, one with more, and invalid
    points inside a box; then the head's outputs on them."""
    rng = np.random.RandomState(4)
    pts, valid = _frames()
    feats = rng.randn(2, 600, 16).astype(np.float32)
    rois = np.zeros((2, 4, 7), np.float32)
    rois[:, 0] = [40.0, 30.0, 0.0, 2.0, 2.0, 2.0, 0.3]            # empty
    for b in range(2):
        c = pts[b, 0]
        rois[b, 1] = [*c, 0.6, 0.6, 0.6, 0.0]                     # a few points
        rois[b, 2] = [*pts[b, 150], 6.0, 4.0, 3.0, 0.7]            # many
        rois[b, 3] = [*pts[b, 210], 3.0, 3.0, 1.0, -1.2]           # the ground strip
    valid[0, 60:90] = False
    jh = JPR.PointRCNNHead(num_sampled_points=32, xyz_up=(16, 16), cls_fc=(32,), reg_fc=(32,))
    shapes = jax.eval_shape(lambda r, p, f, v: jh.init(jax.random.PRNGKey(0), r, p, f, v),
                            rois, pts, feats, valid)
    variables = seeded_flax_variables(shapes, seed=5)
    (cls, reg), inter = jax.jit(lambda v, *a: jh.apply(
        v, *a, capture_intermediates=True, mutable=["intermediates"]))(
        jax.tree.map(jnp.asarray, variables), rois, pts, feats, valid)
    x_up = np.asarray(inter["intermediates"]["xyz_up0"]["__call__"][0])
    head = PR.PointRCNNHead(16, 32, 70.0, (16, 16), (32,), (32,))
    head.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in {
        f"{n}.{'weight' if a == 'kernel' else 'bias'}": (w.T if a == "kernel" else w)
        for n, leaf in variables["params"].items() for a, w in leaf.items()}.items()},
        strict=True)
    with torch.no_grad():
        geo, pooled = head.pool(*(to_torch(a) for a in (rois, pts, feats, valid)))
        got_cls, got_reg = head.head(geo, pooled)
    ref_geo = x_up.reshape(2, 4, 32, -1)
    port_up = head.xyz_up0(geo).detach()
    _rel(port_up, ref_geo, "xyz_up0 of the pooled geometry")
    _rel(got_cls, cls, "rcnn_cls")
    _rel(got_reg, reg, "rcnn_reg")
    for b in range(2):
        idx, ok = PR.roi_point_indices(to_torch(rois[b]), to_torch(pts[b]), to_torch(valid[b]),
                                       32)
        inside = np.asarray(jax.jit(lambda p, r: JPR.points_in_boxes(p, r))(pts[b], rois[b]))
        inside = inside & valid[b][None]
        assert not ok[0] and (idx[0] == 0).all() and (geo[b, 0] == 0).all()
        assert_close(pooled[b, 0], np.broadcast_to(feats[b, 0], (32, 16)), name="empty RoI")
        for r in range(1, 4):
            members = np.flatnonzero(inside[r])
            assert ok[r] and len(members) > 0
            assert_close(idx[r], members[np.arange(32) % len(members)], name=f"RoI {r}")
        counts = inside.sum(1)
        assert counts[1] < 32 < counts[2]


# --- the whole model -------------------------------------------------------------


_BUILT = {}


def _jax_model(cfg):
    return JPR.PointRCNN(cfg=DetectorConfig(cfg.MODEL, cfg.DATA_CONFIG, cfg.CLASS_NAMES))


def _built():
    if not _BUILT:
        cfg = C.tiny_pointrcnn_cfg()
        jm = _jax_model(cfg)
        pts, valid = _frames()
        shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                     p, v, train=False), pts, valid)
        variables = seeded_flax_variables(shapes, seed=0)
        model, _ = build_detector(cfg, W.pointrcnn_state_dict_from_flax(variables), device="cpu")
        _BUILT.update(cfg=cfg, jm=jm, shapes=shapes, variables=variables, model=model)
    return _BUILT


def _export(p, s):
    return W.pointrcnn_state_dict_from_flax(jax.tree.map(np.asarray, {"params": p,
                                                                      "batch_stats": s}))


@pytest.fixture(scope="module")
def pointrcnn_jax():
    """JAX's side of the eval and the train-step tests, built once (the init
    shapes shared): the eval forward at ``_built``'s weights (seed 0) on the
    blob frames, and the training loss, its terms, the new batch stats and
    ``jax.value_and_grad``'s gradients at weights from seed 3 on the blob
    frames with cars near two training proposals each
    (chip_smoke.pvrcnn_train_inputs), the RoI sample's priorities JAX's own
    draws."""
    b = _built()
    cfg, jm = b["cfg"], b["jm"]
    variables = jax.tree.map(jnp.asarray, seeded_flax_variables(b["shapes"], seed=3))
    params, stats = variables["params"], variables["batch_stats"]
    pts, valid, gt = pvrcnn_train_inputs(cfg, _export(params, stats))
    rng = jax.random.PRNGKey(7)
    n_rois = int(cfg.MODEL.ROI_HEAD.NMS_CONFIG.TRAIN.NMS_POST_MAXSIZE)
    u = np.asarray(jax.vmap(lambda r: jax.random.uniform(r, (n_rois,)))(
        jax.random.split(rng, 2)))
    p0, v0 = _frames()

    def loss_fn(prm):
        out, new = jm.apply({"params": prm, "batch_stats": stats}, pts, valid, gt_boxes=gt,
                            train=True, rng=rng, mutable=["batch_stats"])
        total, tb = jm.loss(out, jnp.asarray(gt))
        return total, (tb, new["batch_stats"])

    # two compiles: in one jitted call with the train step, XLA fuses the
    # eval forward otherwise and its point_cls moves 2.9e-6 (1.3e-6 of the
    # largest), past the eval test's bound
    ref = jax.jit(lambda v, p, q: jm.apply(v, p, q, train=False))(
        jax.tree.map(jnp.asarray, b["variables"]), p0, v0)
    (loss, (tb, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"eval": ref, "params": params, "stats": stats, "inputs": (pts, valid, gt, u),
            "loss": loss, "terms": tb, "new_stats": new_stats, "grads": grads}


def test_pointrcnn_eval_matches_jax(pointrcnn_jax):
    """The tiny PointRCNN's eval forward (point logits and boxes, the
    proposals over the points, the RoI head, the refined boxes) and its
    post-processing (the RCNN branch), against JAX's."""
    b = _built()
    cfg, model = b["cfg"], b["model"]
    pts, valid = _frames()
    ref = pointrcnn_jax["eval"]
    with torch.no_grad():
        out = model(to_torch(pts), to_torch(valid))
    for k in ("point_cls", "point_reg", "batch_box_preds", "roi_scores", "rcnn_cls",
              "rcnn_reg", "rois"):
        _rel(out[k], ref[k], k)
    for k in ("roi_mask", "roi_labels"):
        assert_close(out[k], np.asarray(ref[k]), name=k)
    post = cfg.MODEL.POST_PROCESSING
    pr = jax_post(ref, post, 3, has_roi_head=True)
    pp = post_processing(out, post, 3, has_roi_head=True)
    for k in ("pred_mask", "pred_labels"):
        assert_close(pp[k], np.asarray(pr[k]), name=k)
    for k in ("pred_boxes", "pred_scores"):
        _rel(pp[k], pr[k], k)
    assert int(out["roi_mask"].sum()) == 32 and int(pp["pred_mask"].sum()) > 0


def test_pointrcnn_train_step_matches_jax(pointrcnn_jax):
    """One training forward and loss of the tiny PointRCNN on two blob
    frames with cars near two training proposals each
    (chip_smoke.pvrcnn_train_inputs), the RoI sample's priorities JAX's own
    draws: JAX's loss terms and ``jax.value_and_grad`` gradients against
    the port's in f64; the running statistics it leaves. No RCNN gradient
    reaches the backbone or the point head (JAX's stop_gradient on the
    point features)."""
    cfg = C.tiny_pointrcnn_cfg()
    r = pointrcnn_jax
    params, stats, (pts, valid, gt, u) = r["params"], r["stats"], r["inputs"]
    loss, tb, new_stats, grads = r["loss"], r["terms"], r["new_stats"], r["grads"]
    jax_grads, jax_after = _export(grads, stats), _export(params, new_stats)
    model, _ = build_detector(cfg, _export(params, stats), device="cpu")
    state = create_train_state(model.double(), cfg.OPTIMIZATION, 100)
    dbl = lambda a: torch.from_numpy(np.array(a)).double()     # noqa: E731
    ploss, ptb, out = train_forward(state, dbl(pts), torch.from_numpy(valid), dbl(gt),
                                    roi_u=dbl(u))
    early = list(model.backbone_3d.parameters()) + list(model.point_head.parameters())
    rcnn_on_early = torch.autograd.grad(ptb["rcnn_loss"], early, retain_graph=True,
                                        allow_unused=True)
    assert all(g is None or not g.any() for g in rcnn_on_early)
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
    assert terms["rcnn_loss_reg"] > 0 and terms["point_loss_box"] > 0
