"""Part-A2 in the port (seevcn_torch.models.detectors.parta2, UNetV2 of
seevcn_torch.models.modules.unet3d, ``sparse_inverse_conv3d`` of
seevcn_torch.ops.sparse, seevcn_torch.ops.roiaware) against the JAX package
on the CPU: the inverse conv (against a numpy transpose, JAX, and
gradcheck), the channel reduction, UNetV2 in the JAX package's sparse
mode and, compared by voxel key, its default hybrid mode, the roiaware
pool, the tiny model's eval forward and post-processing, one train step;
then the full-width configurations of PointRCNN and Part-A2 and
``detect_stage`` with both.

Weights: seevcn_torch.testing.seeded_flax_variables on the tree of JAX's
init (``jax.eval_shape``, no init compile), carried into the port by
``parta2_state_dict_from_flax``. Inputs: numpy from a seed
(chip_smoke.blob_points, chip_smoke.pvrcnn_train_inputs). Every JAX call
is jitted. The tiny config keeps every stage's active voxels under JAX's
capacities (asserted), where JAX would truncate and the port would not
(ROADMAP §3).

Tolerances: the inverse conv and the channel reduction 1e-5 of the largest
|value| (f32 sums in another order; gradcheck in f64 at its defaults);
UNetV2's features, the roiaware pools, the part head, proposals, RoI head
outputs and post-processed boxes and scores 1e-5 of the largest |value|;
voxel keys, proposal masks, labels and kept masks equal. The train step,
the port in f64 against JAX's f32 (JAX's sparse convs pin f32): loss terms
1e-5 (absolute and relative), gradients 5e-4 of the tensor's largest,
running statistics 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import blob_points, pvrcnn_train_inputs
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.detectors.second import post_processing as jax_post
from seevcn_tpu.models.modules import unet3d as JU
from seevcn_tpu.ops import roiaware as JRA
from seevcn_tpu.ops import sparse as JSP
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector, post_processing
from seevcn_torch.models.modules import unet3d as TU
from seevcn_torch.ops import roiaware as RA
from seevcn_torch.ops import sparse as SP
from seevcn_torch.ops.voxelize import voxelize_batch
from seevcn_torch.see.frame import detect_stage
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy, to_torch
from seevcn_torch.train.train import create_train_state, train_forward
from seevcn_torch.utils import weights as W


def _rel(got, ref, name, tol=1e-5):
    ref = to_numpy(ref)
    assert_close(got, ref, atol=tol * float(np.abs(ref).max()) + 1e-12, name=name)


def _frames(seeds=(1, 2)):
    frames = [blob_points(s, 600) for s in seeds]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def _random_sparse(rng, batch=2, dims=(5, 8, 8), cin=3, density=0.2, pad=9):
    """A key-sorted sparse tensor as numpy (features, coords, mask) with
    ``pad`` padding rows, and its dense occupancy."""
    nz, ny, nx = dims
    occ = rng.rand(batch, nz, ny, nx) < density
    coords = np.argwhere(occ).astype(np.int32)
    n = len(coords)
    feats = rng.randn(n, cin).astype(np.float32)
    coords = np.concatenate([coords, np.zeros((pad, 4), np.int32)])
    feats = np.concatenate([feats, np.zeros((pad, cin), np.float32)])
    return feats, coords, np.arange(n + pad) < n


def _jst(a, dims, batch=2):
    return JSP.make_sparse_tensor(*(jnp.asarray(x) for x in a), dims, batch)


def _tst(a, dims, batch=2, dtype=None):
    f, c, m = (to_torch(x) for x in a)
    return SP.make_sparse_tensor(f if dtype is None else f.to(dtype), c, m, dims, batch)


# --- the inverse conv and the channel reduction ---------------------------------------


def _down_up(rng, dims=(5, 8, 8)):
    a = _random_sparse(rng, dims=dims)
    w_down = (rng.randn(27, 3, 5) * 0.3).astype(np.float32)
    w_up = (rng.randn(27, 5, 4) * 0.3).astype(np.float32)
    return a, w_down, w_up


def test_sparse_inverse_conv3d_matches_numpy_and_jax():
    """A stride-2 conv (padding 1) then its inverse back onto the input's
    rows: every output row against the numpy sum over the kernel of
    in[(p + pad - k) / 2] W[k] where it divides (the JAX package's
    tests/test_unet3d.py), and against JAX's ``sparse_inverse_conv3d``
    (whose strided conv keeps the input's row count; the port's keeps every
    active output, so the down tensors' rows differ but the output's are
    the input's in both)."""
    rng = np.random.RandomState(0)
    dims = (5, 8, 8)
    a, w_down, w_up = _down_up(rng, dims)
    down = SP.sparse_conv3d(_tst(a, dims), to_torch(w_down), 3, 2, 1, out_capacity=SP.ALL)
    up = SP.sparse_inverse_conv3d(down, to_torch(w_up), _tst(a, dims), 3, 2, 1)
    assert up.spatial_shape == dims
    def jax_up(f, c, m, wd, wu):
        jst = JSP.make_sparse_tensor(f, c, m, dims, 2)
        jdown = JSP.sparse_conv3d(jst, wd, 3, 2, 1, out_capacity=f.shape[0])
        return JSP.sparse_inverse_conv3d(jdown, wu, jst, 3, 2, 1).features, jdown.mask.sum()

    jup, jcount = jax.jit(jax_up)(*a, w_down, w_up)
    _rel(up.features, jup, "inverse conv vs JAX")
    assert int(down.mask.sum()) == int(jcount)
    got = up.features.numpy()
    dd = {tuple(c): f for c, f, m in zip(down.coords.numpy(), down.features.numpy(),
                                          down.mask.numpy()) if m}
    wk = w_up.reshape(3, 3, 3, 5, 4)
    feats, coords, mask = a
    for i in np.flatnonzero(mask):
        b, z, y, x = coords[i]
        acc = np.zeros(4, np.float64)
        for kz in range(3):
            for ky in range(3):
                for kx in range(3):
                    num = np.array([z + 1 - kz, y + 1 - ky, x + 1 - kx])
                    if (num % 2).any():
                        continue
                    f = dd.get((b, *(num // 2)))
                    if f is not None:
                        acc += f.astype(np.float64) @ wk[kz, ky, kx]
        assert_close(got[i], acc, atol=1e-5, name=f"row {i}")
    assert (got[~mask] == 0).all()


def test_sparse_inverse_conv3d_gradcheck():
    """The inverse conv's backward (``_RulebookConv`` with the query sets
    swapped: the input gradient gathers through the regular conv's
    queries) against ``torch.autograd.gradcheck`` in f64, for the features
    and the weight."""
    rng = np.random.RandomState(1)
    dims = (3, 6, 6)
    a, w_down, w_up = _down_up(rng, dims)
    target = _tst(a, dims, dtype=torch.float64)
    down = SP.sparse_conv3d(target, to_torch(w_down).double(), 3, 2, 1, out_capacity=SP.ALL)
    feats = down.features.detach().requires_grad_(True)
    w = to_torch(w_up).double().requires_grad_(True)

    def f(x, weight):
        return SP.sparse_inverse_conv3d(down._replace(features=x), weight, target,
                                        3, 2, 1).features

    assert torch.autograd.gradcheck(f, (feats, w))


def test_channel_reduction_matches_jax():
    """Channel c goes to group c // (C / out), as JAX's reshape-and-sum."""
    rng = np.random.RandomState(2)
    a = _random_sparse(rng, cin=12)
    dims = (5, 8, 8)
    ref = JU.channel_reduction(_jst(a, dims), 4).features
    got = TU.channel_reduction(_tst(a, dims), 4).features
    _rel(got, ref, "channel reduction", tol=1e-6)
    assert_close(got[:, 0], a[0][:, :3].sum(1), atol=1e-6, name="group 0")


# --- UNetV2 ---------------------------------------------------------------------------


def _voxels(cfg):
    pts, valid = _frames()
    dc = build_detector(cfg, device="cpu")[1]
    f, c, m = voxelize_batch(to_torch(pts), to_torch(valid), point_cloud_range=dc.point_cloud_range,
                             voxel_size=dc.voxel_size, max_voxels=dc.max_voxels,
                             max_points_per_voxel=dc.max_points_per_voxel)
    return (f.numpy(), c.numpy(), m.numpy()), dc.sparse_shape


def _by_key(feats, coords, mask, dims):
    """Valid rows of a stage tensor sorted by voxel key (b, z, y, x)."""
    feats, coords, mask = (np.asarray(x) for x in (feats, coords, mask))
    nz, ny, nx = dims
    c = coords[mask].astype(np.int64)
    key = ((c[:, 0] * nz + c[:, 1]) * ny + c[:, 2]) * nx + c[:, 3]
    order = np.argsort(key)
    return key[order], feats[mask][order]


@pytest.fixture(scope="module")
def unet_jax():
    """JAX's UNetV2 on the voxelised blob frames, weights from seed 4, for
    every case of ``test_unetv2_matches_jax``: the sparse mode in eval and
    in training from one jitted call (one compile), the hybrid mode in
    eval. -> (voxels, dims, variables, {(mode, train): (output, new
    batch stats)})."""
    a, dims = _voxels(C.tiny_parta2_cfg())
    st = lambda f, c, m: JSP.make_sparse_tensor(f, c, m, dims, 2)   # noqa: E731
    runs, variables = {}, None
    for mode in ("sparse", "hybrid"):
        jm = JU.UNetV2(input_channels=3, mode=mode)
        if variables is None:
            shapes = jax.eval_shape(lambda *x: jm.init(jax.random.PRNGKey(0), st(*x)), *a)
            variables = seeded_flax_variables(shapes, seed=4)
        flags = (False, True) if mode == "sparse" else (False,)
        outs = jax.jit(lambda v, *x: [jm.apply(v, st(*x), t, mutable=["batch_stats"])
                                      for t in flags])(jax.tree.map(jnp.asarray, variables), *a)
        runs.update({(mode, t): o for t, o in zip(flags, outs)})
    return a, dims, variables, runs


@pytest.mark.parametrize("mode,train", [("sparse", False), ("sparse", True),
                                        ("hybrid", False)],
                         ids=["sparse_eval", "sparse_train", "hybrid_eval"])
def test_unetv2_matches_jax(unet_jax, mode, train):
    """UNetV2 on two voxelised blob frames: the stride-1 point features,
    the stage-4 features and the stride-8 tensor held by voxel key (in
    hybrid mode JAX re-extracts each stage into round(1.5 x rows) key-sorted
    rows), their active sets equal; in training the running statistics.
    Every stage's active voxels stay under JAX's capacity."""
    a, dims, variables, runs = unet_jax
    ref, new = runs[(mode, train)]

    def export(stats):
        sd = {}
        W._backbone_3d(sd, variables["params"], stats)
        W._unet_decoder(sd, "backbone_3d", variables["params"], stats)
        return {k[len("backbone_3d."):]: v for k, v in sd.items()}

    model = TU.UNetV2(3)
    model.load_state_dict(export(variables["batch_stats"]), strict=True)
    model.train(train)
    with torch.no_grad():
        out = model(_tst(a, dims))
    cap = a[0].shape[0]
    for name, got, r in (
            ("point_features", out["point_features"], ref["point_features"]),
            ("x_conv4", out["multi_scale_3d_features"]["x_conv4"],
             ref["multi_scale_3d_features"]["x_conv4"]),
            ("encoded", out["encoded_spconv_tensor"], ref["encoded_spconv_tensor"])):
        if name == "encoded" and mode == "hybrid":
            r = JSP.as_sparse(r, 2, cap)
        gk, gf = _by_key(got.features, got.coords, got.mask, got.spatial_shape)
        rk, rf = _by_key(r.features, r.coords, r.mask, got.spatial_shape)
        assert_close(gk, rk, name=f"{name} keys")
        _rel(gf, rf, name)
    active = [int(s.mask.sum()) for s in out["multi_scale_3d_features"].values()]
    assert max(active) < cap and active[0] == int(a[2].sum())
    if mode == "sparse":
        assert_close(out["point_features"].features, np.asarray(ref["point_features"].features),
                     atol=1e-5 * float(np.abs(ref["point_features"].features).max()),
                     name="point features row by row")
    if train:
        after = export(new["batch_stats"])
        for n, b in model.named_buffers():
            if n.endswith("running_mean") or n.endswith("running_var"):
                assert_close(b, after[n], atol=1e-5, rtol=1e-5, name=n)


# --- the roiaware pool ---------------------------------------------------------------


@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(method):
    """Rotated RoIs over random points, some invalid and some outside every
    box, at G 4: JAX's pool against the port's, and the JAX package's own
    exact cases (an axis-aligned box at G 2; a turned box whose +y is its
    +x)."""
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    feats = rng.randn(500, 6).astype(np.float32)
    valid = rng.rand(500) > 0.2
    rois = np.concatenate([rng.uniform(-2, 2, (5, 3)), rng.uniform(1.5, 4, (5, 3)),
                           rng.uniform(-np.pi, np.pi, (5, 1))], 1).astype(np.float32)
    ref = jax.jit(lambda *x: JRA.roiaware_pool3d(*x, grid_size=4, method=method))(
        rois, xyz, feats, valid)
    got = RA.roiaware_pool3d(*(to_torch(x) for x in (rois, xyz, feats, valid)), 4, method)
    _rel(got, ref, f"pooled {method}")
    cells = RA.roi_cells(to_torch(rois), to_torch(xyz), to_torch(valid), 4)
    assert (cells == 64).any() and ((cells < 64) & ~to_torch(valid)[None]).sum() == 0
    assert (np.asarray(ref) == 0).all(-1).any() and (np.asarray(ref) != 0).any()
    box = np.float32([[0, 0, 0, 4.0, 2.0, 1.6, 0.0]])
    pts = np.float32([[-1.0, -0.5, -0.4], [1.0, 0.5, 0.4], [1.0, -0.5, 0.4], [9.0, 9.0, 9.0],
                      [-1.0, -0.5, -0.4]])
    f = np.float32([[1.0], [2.0], [3.0], [99.0], [5.0]])
    v = np.array([True, True, True, True, method == "avg"])
    out = RA.roiaware_pool3d(*(to_torch(x) for x in (box, pts, f, v)), 2, method)[0, :, 0]
    assert out[0] == (3.0 if method == "avg" else 1.0) and out[7] == 2.0 and out[5] == 3.0
    assert out[1] == 0.0 and (out != 99.0).all()
    turned = RA.roiaware_pool3d(to_torch(np.float32([[0, 0, 0, 4.0, 2.0, 1.6, np.pi / 2]])),
                                to_torch(np.float32([[0.0, 1.5, 0.0]])),
                                to_torch(np.float32([[7.0]])), torch.ones(1, dtype=torch.bool),
                                2, method)[0, :, 0]
    assert turned.max() == 7.0 and int(torch.nonzero(turned)[0]) >= 4


# --- the whole model --------------------------------------------------------------------


_BUILT = {}


def _built():
    if not _BUILT:
        cfg = C.tiny_parta2_cfg()
        jm, _ = jax_build(cfg)
        pts, valid = _frames()
        shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                     p, v, train=False), pts, valid)
        variables = seeded_flax_variables(shapes, seed=0)
        model, dcfg = build_detector(cfg, W.parta2_state_dict_from_flax(variables), device="cpu")
        _BUILT.update(cfg=cfg, dcfg=dcfg, jm=jm, shapes=shapes, variables=variables,
                      model=model)
    return _BUILT


def _export(p, s):
    return W.parta2_state_dict_from_flax(jax.tree.map(np.asarray, {"params": p,
                                                                   "batch_stats": s}))


@pytest.fixture(scope="module")
def parta2_jax():
    """JAX's side of the eval and the train-step tests from one jitted call
    (one compile): the eval forward at ``_built``'s weights (seed 0) on the
    blob frames, and the training loss, its terms, the new batch stats and
    ``jax.value_and_grad``'s gradients at weights from seed 3 on the blob
    frames with cars near two training proposals each, the RoI sample's
    priorities JAX's own draws."""
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

    def both(ev, prm):
        return jm.apply(ev, p0, v0, train=False), jax.value_and_grad(loss_fn, has_aux=True)(prm)

    ref, ((loss, (tb, new_stats)), grads) = jax.jit(both)(
        jax.tree.map(jnp.asarray, b["variables"]), params)
    return {"eval": ref, "params": params, "stats": stats, "inputs": (pts, valid, gt, u),
            "loss": loss, "terms": tb, "new_stats": new_stats, "grads": grads}


def test_parta2_eval_matches_jax(parta2_jax):
    """The tiny Part-A2's eval forward (the anchor RPN on UNetV2's stride-8
    tensor, the part head on its stride-1 voxels, proposals, the roiaware
    pools and the FC head, the refined boxes) and its post-processing,
    against JAX's in its sparse mode (whose stride-1 rows are the
    voxeliser's, as the port's)."""
    b = _built()
    cfg, model = b["cfg"], b["model"]
    pts, valid = _frames()
    ref = parta2_jax["eval"]
    with torch.no_grad():
        out = model(to_torch(pts), to_torch(valid))
    assert int(out["active_voxels"][1:5].max()) < 2 * b["dcfg"].max_voxels
    for k in ("batch_cls_preds", "batch_box_preds", "seg_logits", "part_reg", "roi_scores",
              "rcnn_cls", "rcnn_reg", "rcnn_iou", "rois"):
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


def test_parta2_train_step_matches_jax(parta2_jax):
    """One training forward and loss of the tiny Part-A2 on two blob frames
    with cars near two training proposals each, the RoI sample's
    priorities JAX's own draws: JAX's loss terms (the RPN's, seg, part and
    RCNN) and ``jax.value_and_grad`` gradients against the port's step in
    f64; the running statistics it leaves. No RCNN gradient reaches the
    backbones or the part head (the pooled inputs are detached)."""
    cfg = C.tiny_parta2_cfg()
    r = parta2_jax
    params, stats, (pts, valid, gt, u) = r["params"], r["stats"], r["inputs"]
    loss, tb, new_stats, grads = r["loss"], r["terms"], r["new_stats"], r["grads"]
    jax_grads, jax_after = _export(grads, stats), _export(params, new_stats)
    model, _ = build_detector(cfg, _export(params, stats), device="cpu")
    state = create_train_state(model.double(), cfg.OPTIMIZATION, 100)
    dbl = lambda a: torch.from_numpy(np.array(a)).double()     # noqa: E731
    ploss, ptb, out = train_forward(state, dbl(pts), torch.from_numpy(valid), dbl(gt),
                                    roi_u=dbl(u))
    early = [p for n, p in model.named_parameters() if not n.startswith("roi_head.")]
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
    assert terms["rcnn_loss_reg"] > 0 and terms["part_loss"] > 0


# --- full width and the frame's detector stage ------------------------------------------


def test_full_width_configs():
    """pointrcnn.yaml (SA 4,096 / 1,024 / 256 / 64 points, 128 features a
    point after the FP decoder, 512 sampled points an RoI, proposals 9,000
    -> 100 in eval) and PartA2.yaml (1408 x 1600 x 40 voxels, UNetV2's
    decoder back to 16 channels, a 256-channel BEV at 200 x 176, three
    classes' anchors, the 12^3 x 20 pooled grid into the first 256-wide
    FC), each built on the card by default."""
    pr_cfg = C.pointrcnn_detector_cfg()
    model, dcfg = build_detector(pr_cfg, device="cpu")
    assert dcfg.voxel_size is None and dcfg.head_logic is None and dcfg.num_class == 3
    bb = model.backbone_3d
    assert bb.npoints == [4096, 1024, 256, 64]
    assert [m.out_channels for m in bb.SA_modules] == [96, 256, 512, 1024]
    assert bb.SA_modules[0].mlps[1][0].weight.shape == (32, 3, 1, 1)
    assert bb.FP_modules[3].mlp[0].weight.shape == (512, 1536, 1, 1)
    assert bb.FP_modules[0].mlp[0].weight.shape == (128, 256, 1, 1)
    assert model.point_head.box_layers[6].weight.shape == (8, 256)
    head = model.roi_head
    assert head.num_sampled_points == 512 and head.merge_down.weight.shape == (256, 256)
    assert pr_cfg.MODEL.ROI_HEAD.NMS_CONFIG.TEST.NMS_PRE_MAXSIZE == 9000
    pa_cfg = C.parta2_detector_cfg()
    model, dcfg = build_detector(pa_cfg, device="cpu")
    assert list(dcfg.grid_size) == [1408, 1600, 40] and dcfg.max_voxels == 40000
    assert type(model.backbone_3d).__name__ == "UNetV2"
    assert model.backbone_3d.inv_conv4.get_submodule("0").weight.shape == (64, 3, 3, 3, 64)
    assert model.backbone_3d.conv5[0].get_submodule("0").weight.shape == (16, 3, 3, 3, 16)
    assert model.backbone_2d.blocks[0][1].weight.shape == (128, 256, 3, 3)
    assert dcfg.head_logic.anchors_flat.shape == (176 * 200 * 6, 7)
    assert model.roi_head.grid_size == 12
    assert model.roi_head.shared_fc0.weight.shape == (256, 20 * 12 ** 3)
    assert model.roi_head.shared_fc2.weight.shape == (256, 256)
    if not torch.cuda.is_available():
        for cfg in (pr_cfg, pa_cfg):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_detector(cfg)


@pytest.mark.parametrize("name", ["PointRCNN", "PartA2Net", "PartA2"])
def test_detect_stage_takes_the_rcnn_branch(name):
    """``detect_stage`` with tiny PointRCNN and Part-A2 (under either of its
    names) takes the RCNN branch of post-processing."""
    cfg = C.tiny_pointrcnn_cfg() if name == "PointRCNN" else C.tiny_parta2_cfg()
    cfg.MODEL.NAME = name
    pts, valid = _frames((3,))
    model, _ = build_detector(cfg, device="cpu")
    pp, out = detect_stage(model, cfg, to_torch(pts[0]), to_torch(valid[0]), device="cpu")
    ref = post_processing(out, cfg.MODEL.POST_PROCESSING, 3, has_roi_head=True)
    for k in ref:
        assert torch.equal(pp[k], ref[k]), k
    assert "rcnn_iou" in out and int(pp["pred_mask"].sum()) > 0
