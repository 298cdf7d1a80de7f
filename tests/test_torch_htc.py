"""HTC in the port (seevcn_torch/models/seg2d: the cascade, the semantic
branch, mask info flow and deformable stages; the exporters, the checkpoint
pickle and the image backend) against the JAX package on the CPU, at the
reference's tiny HTC config (tests/test_seg2d_htc.py's ``_htc_cfg``,
``seevcn_torch.testing.tiny_htc_cfg``: 96x128, width 8, one mask conv).

Weights: ``seevcn_torch.testing.seeded_seg2d_weights``, the port's
``init_seg2d`` from a seed, with every bias, batch-norm scale and statistic
at random values and the deformable convs' offset convs seeded non-zero (at their zero init DCN is a plain conv and would show
nothing), carried to JAX by ``seg2d_flax_from_state_dict``; the tree it
makes is held against the structure of JAX's own init. Inputs are numpy
from a seed; JAX calls are jitted.

Tolerances: features and logits 1e-5 of their scale (sums in another
order); boxes 1e-4 px; scores and masks 1e-5; indices, classes and kept
sets equal, on inputs whose scores lie apart by more than that.
"""
import os
import pickle
from dataclasses import asdict

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from seevcn_tpu.models.seg2d import maskrcnn as JM
from seevcn_tpu.models.seg2d.backend import JaxMaskRCNNBackend
from seevcn_tpu.models.seg2d.backend import build_seg2d as jax_build_seg2d
from seevcn_tpu.models.seg2d.backend import save_seg2d_checkpoint as jax_save
from seevcn_torch.models.seg2d import maskrcnn as TM
from seevcn_torch.models.seg2d.backend import (MaskRCNNBackend, build_seg2d,
                                               load_seg2d_checkpoint,
                                               save_seg2d_checkpoint)
from seevcn_torch.testing import (assert_close, seeded_seg2d_weights, tiny_htc_cfg, to_numpy,
                                  to_torch)
from seevcn_torch.utils.weights import seg2d_flax_from_state_dict, seg2d_state_dict_from_flax

FEAT_RTOL = 1e-5
BOX_ATOL = 1e-4
PROB_ATOL = 1e-5
VARIANTS = {
    "cascade": dict(semantic_branch=False, mask_info_flow=False),
    "semantic": dict(cascade_stages=1, mask_info_flow=False),
    "cascade_info_flow": dict(semantic_branch=False),
    "dcn": dict(cascade_stages=1, semantic_branch=False, mask_info_flow=False,
                dcn_stages=(False, True, True, True)),
    "full_htc": dict(dcn_stages=(False, True, True, True)),
}


def _close_features(got, ref, name):
    ref = np.asarray(ref)
    assert_close(got, ref, atol=FEAT_RTOL * float(np.abs(ref).max()), rtol=FEAT_RTOL,
                 name=name)


def htc_cfgs(variant="full_htc"):
    """(JAX cfg, the port's cfg) of one of VARIANTS."""
    cfg = TM.Seg2DConfig(**{**asdict(tiny_htc_cfg()), **VARIANTS[variant]})
    return JM.Seg2DConfig(**asdict(cfg)), cfg


def _image(seed=9):
    return np.random.RandomState(seed).rand(1, 96, 128, 3).astype(np.float32)


def _init_structure(model, cfg):
    """The shapes of JAX's own init of ``model``: a tree traced, not run."""
    img = jnp.zeros((1, *cfg.image_size, 3), jnp.float32)
    return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, img,
                                             train=False))


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), dict(tree))


# ---------------------------------------------------------------------------
# the semantic head and its resizes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size", [(96, 128), (76, 122)])
def test_semantic_head_matches_jax(size):
    """The fused semantic head on random FPN maps of an image of ``size``:
    76x122 gives P2 19x31 -> P3 10x16, a shrink by a factor that is not 2."""
    rng = np.random.RandomState(1)
    dims = [size]
    for _ in range(6):
        dims.append(tuple(-(-d // 2) for d in dims[-1]))
    feats = [rng.randn(2, *dims[2 + i], 8).astype(np.float32) for i in range(5)]
    head = JM.SemanticHead(1, channels=6, n_convs=2)
    params = jax.tree.map(np.asarray, head.init(jax.random.PRNGKey(0), feats)["params"])
    params = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32), params)
    logits, feat = jax.jit(lambda p, f: head.apply({"params": p}, f))(params, feats)
    port = TM.SemanticHead(8, 1, channels=6, n_convs=2)
    port.load_state_dict(seg2d_state_dict_from_flax({"params": params}), strict=True)
    with torch.no_grad():
        got_l, got_f = port([to_torch(f).permute(0, 3, 1, 2) for f in feats])
    assert got_l.shape == (2, 2, *dims[3])
    _close_features(got_l.permute(0, 2, 3, 1), logits, "semantic logits")
    _close_features(got_f.permute(0, 2, 3, 1), feat, "semantic feature")


@pytest.mark.parametrize("src,dst", [((96, 320), (48, 160)), ((97, 321), (48, 160)),
                                     ((19, 31), (10, 16))])
def test_semantic_resizes_match_jax(src, dst):
    """What the semantic branch's two resizes must be: JAX's bilinear
    shrink antialiases (torch's bilinear without it reads about 1 off),
    its upsample does not (P6 -> P3 agrees either way), and its "nearest"
    samples at half-pixel centres, torch's ``nearest-exact`` (torch's
    "nearest" picks other pixels)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, *src).astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (2, 4, *dst), "bilinear"))
    t = to_torch(x)
    aa = F.interpolate(t, size=dst, mode="bilinear", align_corners=False, antialias=True)
    plain = F.interpolate(t, size=dst, mode="bilinear", align_corners=False)
    assert_close(aa, ref, atol=1e-6 * float(np.abs(ref).max()), name="antialiased shrink")
    assert float((plain - to_torch(ref)).abs().max()) > 0.1
    small = rng.randn(2, 4, 2, 2).astype(np.float32)
    up = np.asarray(jax.image.resize(small, (2, 4, *dst), "bilinear"))
    for antialias in (False, True):
        assert_close(F.interpolate(to_torch(small), size=dst, mode="bilinear",
                                   align_corners=False, antialias=antialias), up,
                     atol=1e-6, name="upsample")
    labels = rng.randint(0, 3, (2, src[0] * 4, src[1] * 4)).astype(np.float32)
    nearest = np.asarray(jax.image.resize(labels, (2, *dst), "nearest"))
    exact = F.interpolate(to_torch(labels)[:, None], size=dst, mode="nearest-exact")[:, 0]
    assert_close(exact, nearest, name="nearest-exact")
    other = F.interpolate(to_torch(labels)[:, None], size=dst, mode="nearest")[:, 0]
    assert (other.numpy() != nearest).any()


def test_semantic_loss_matches_jax():
    """The semantic cross-entropy on random logits against the union of
    overlapping instance masks with padding rows (a padding row's mask is
    full and must not count), two foreground classes."""
    rng = np.random.RandomState(4)
    b, g, h, w = 2, 4, 96, 128
    masks = (rng.rand(b, g, h, w) > 0.6).astype(np.float32)
    labels = rng.randint(0, 2, (b, g)).astype(np.int32)
    valid = np.array([[True, True, False, True], [True, False, False, False]])
    masks[~valid] = 1.0
    logits = rng.randn(b, h // 8, w // 8, 3).astype(np.float32)
    # the reference's lines (maskrcnn.py:778-787), which MaskRCNN.loss runs
    # inline; tests/test_torch_htc_train.py holds the whole loss
    lab = jnp.where(jnp.asarray(valid)[:, :, None, None],
                    (jnp.asarray(masks) >= 0.5).astype(jnp.int32)
                    * (jnp.asarray(labels)[:, :, None, None] + 1), 0)
    tgt8 = jax.image.resize(jnp.max(lab, axis=1).astype(jnp.float32), (b, h // 8, w // 8),
                            "nearest")
    onehot = jax.nn.one_hot(tgt8.astype(jnp.int32), 3)
    want = -(jax.nn.log_softmax(jnp.asarray(logits)) * onehot).sum(-1).mean()
    got = TM.semantic_loss(TM.Seg2DConfig(num_classes=2), to_torch(logits), to_torch(labels),
                           to_torch(valid), to_torch(masks))
    assert_close(got, np.asarray(want), atol=1e-6, rtol=1e-6, name="semantic CE")
    assert set(np.unique(np.asarray(tgt8))) == {0.0, 1.0, 2.0}


# ---------------------------------------------------------------------------
# the cascade's relabelling and refinement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fg_iou", [0.5, 0.6, 0.7])
def test_assign_rois_matches_jax(fg_iou):
    """Padding ground-truth rows (one of them a copy of a valid box, which
    must not match), a duplicated valid box (the lower row wins the tie),
    invalid RoIs, RoIs at every IoU around the threshold."""
    rng = np.random.RandomState(5)
    gtb = np.array([[10, 10, 50, 40], [60, 20, 110, 70], [60, 20, 110, 70],
                    [10, 10, 50, 40], [0, 0, 0, 0]], np.float32)
    gtl = np.array([0, 1, 2, 2, 0], np.int32)
    gtv = np.array([True, True, True, False, False])
    rois = gtb[rng.randint(0, 3, 40)] + rng.uniform(-12, 12, (40, 4)).astype(np.float32)
    valid = rng.rand(40) > 0.2
    jcfg = JM.Seg2DConfig(num_classes=3)
    ref = [np.asarray(x) for x in JM.MaskRCNNLogic(jcfg).assign_rois(
        *(jnp.asarray(x) for x in (rois, valid, gtb, gtl, gtv)), fg_iou)]
    got = TM.assign_rois(*(to_torch(x) for x in (rois, valid, gtb, gtl, gtv)), fg_iou)
    for name, g, r in zip(("classes", "deltas", "is_fg", "matched"), got, ref):
        if name == "deltas":
            assert_close(g, r, atol=1e-5, rtol=2e-7, name=name)
        else:
            assert_close(g, r, name=name)
    assert ref[2].any() and not ref[2].all()
    assert not np.isin(ref[3], [2, 3, 4]).any()         # ties and padding rows
    assert (ref[0][~valid] == 0).all()


def test_refine_rois_matches_jax():
    """Three classes, logits with tied foreground classes (the first
    wins), deltas past the exp's clip: boxes 1e-4 px, detached."""
    rng = np.random.RandomState(6)
    r, k = 50, 3
    xy = rng.uniform(0, 90, (r, 2))
    rois = np.concatenate([xy, xy + rng.uniform(4, 40, (r, 2))], 1).astype(np.float32)
    logits = rng.randn(r, k + 1).astype(np.float32)
    logits[:10, 2] = logits[:10, 1]
    logits[:10, 3] = logits[:10, 1] - 1
    deltas = (rng.randn(r, k, 4) * 2).astype(np.float32)
    deltas[::7, :, 2:] = 60.0
    jcfg = JM.Seg2DConfig(num_classes=k, image_size=(96, 128))
    ref = np.asarray(jax.jit(JM.MaskRCNNLogic(jcfg).refine_rois)(rois, logits, deltas))
    t_logits = to_torch(logits).requires_grad_()
    got = TM.refine_rois(TM.Seg2DConfig(**asdict(jcfg)), to_torch(rois), t_logits,
                         to_torch(deltas))
    assert not got.requires_grad
    assert_close(got, ref, atol=BOX_ATOL, name="refined boxes")
    # the tie goes to class 1: its deltas, not class 2's
    one = np.asarray(JM.decode_deltas(jnp.asarray(deltas[:10, 0]), jnp.asarray(rois[:10]),
                                      (96, 128)))
    assert_close(got[:10], one, atol=BOX_ATOL, name="tied rows")


# ---------------------------------------------------------------------------
# the eval forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_forward_matches_jax(variant):
    jcfg, cfg = htc_cfgs(variant)
    model, _ = jax_build_seg2d(jcfg)
    sd = seeded_seg2d_weights(cfg)
    variables = seg2d_flax_from_state_dict(sd)
    assert _shapes(variables) == _shapes(_init_structure(model, jcfg))
    img = _image()
    ref = {k: np.asarray(v) for k, v in jax.jit(
        lambda v, x: model.apply(v, x, train=False))(variables, img).items()}
    port = build_seg2d(cfg, sd, device="cpu")
    with torch.no_grad():
        got = port(to_torch(img))
    assert set(got) == set(ref)
    _close_features(got["rpn_obj"], ref["rpn_obj"], "rpn_obj")
    if cfg.semantic_branch:
        _close_features(got["semantic_logits"], ref["semantic_logits"], "semantic_logits")
    kept = np.sort(ref["det_scores"][ref["det_scores"] > 0])
    assert len(kept) > 1 and np.diff(kept).min() > PROB_ATOL    # scores lie apart
    assert_close(got["det_cls"], ref["det_cls"], name="det_cls")
    assert_close(got["det_scores"], ref["det_scores"], atol=PROB_ATOL, name="det_scores")
    assert_close(got["det_boxes"], ref["det_boxes"], atol=BOX_ATOL, name="det_boxes")
    assert_close(got["det_masks"], ref["det_masks"], atol=PROB_ATOL, name="det_masks")
    assert got["det_masks"].shape == (1, cfg.max_detections, 28, 28)


@pytest.mark.parametrize("variant", ["cascade_info_flow", "full_htc"])
def test_mask_heads_chain_matches_jax(variant):
    """The info-flow mask heads alone on random RoI features: each head's
    logits and pre-upsample feature, fed the previous one's."""
    jcfg, cfg = htc_cfgs(variant)
    sd = seeded_seg2d_weights(cfg)
    variables = seg2d_flax_from_state_dict(sd)
    port = build_seg2d(cfg, sd, device="cpu")
    f14 = np.random.RandomState(7).randn(5, 14, 14, cfg.fpn_channels).astype(np.float32)
    last, t_last = None, None
    for s, head in enumerate(port.mask_heads):
        name = "mask_head" if s == 0 else f"mask_head_s{s}"
        jhead = JM.MaskHead(1, channels=cfg.mask_channels, n_convs=cfg.mask_convs)
        sub = {"params": variables["params"][name]}
        logits, last = jax.jit(lambda p, x, prev: jhead.apply(p, x, prev))(sub, f14, last)
        with torch.no_grad():
            t_logits, t_last = head(to_torch(f14), t_last)
        _close_features(t_logits, logits, f"{name} logits")
        _close_features(t_last, last, f"{name} feature")
    assert len(port.mask_heads) == 3


# ---------------------------------------------------------------------------
# exporters, checkpoints, the image backend
# ---------------------------------------------------------------------------
def test_exporters_round_trip_full_htc():
    """A full-HTC flax tree with DCN (JAX's own init, shapes and names) ->
    state dict -> flax tree, bit for bit; the state dict loads strictly into
    the port, DCN's kernel as a Conv2d's (out, in, kh, kw)."""
    jcfg, cfg = htc_cfgs("full_htc")
    model, _ = jax_build_seg2d(jcfg)
    struct = _init_structure(model, jcfg)
    rng = np.random.RandomState(8)
    tree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), dict(struct))
    sd = seg2d_state_dict_from_flax(tree)
    port = TM.MaskRCNN(cfg)
    port.load_state_dict(sd, strict=False)
    assert set(sd) == set(port.state_dict())
    back = seg2d_flax_from_state_dict(sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree),
                            jax.tree.leaves(back)):
        assert a.shape == b.shape and np.array_equal(a, b), jax.tree_util.keystr(path)
    k = tree["params"]["backbone"]["stage1_block0"]["DeformConv2d_0"]["kernel"]
    assert_close(sd["backbone.stage1_block0.DeformConv2d_0.weight"],
                 np.transpose(k, (3, 2, 0, 1)), name="DCN kernel")
    for key in ("backbone.stage1_block0.Conv_1.weight",          # the projection
                "backbone.stage1_block0.DeformConv2d_0.offset_conv.bias",
                "mask_head_s2.res_conv.weight", "semantic_head.lat4.weight",
                "box_head_s2.cls.weight"):
        assert key in sd, key
    assert "backbone.stage0_block0.Conv_2.weight" in sd           # a plain block


def test_checkpoint_pickle_both_ways(tmp_path):
    """A pickle JAX wrote at full HTC loads into the port with its config
    and gives JAX's eval forward; the port's pickle of the same weights
    loads in JAX (pickle.load, its own model) and gives the port's."""
    jcfg, cfg = htc_cfgs("full_htc")
    model, _ = jax_build_seg2d(jcfg)
    sd = seeded_seg2d_weights(cfg, seed=2)
    variables = seg2d_flax_from_state_dict(sd)
    forward = jax.jit(lambda v, x: model.apply(v, x, train=False))
    img = _image()
    ref = {k: np.asarray(v) for k, v in forward(variables, img).items()}

    path = str(tmp_path / "jax.ckpt")
    jax_save(path, variables, jcfg)
    loaded_cfg, loaded = load_seg2d_checkpoint(path)
    assert asdict(loaded_cfg) == asdict(cfg)
    for k, v in loaded.items():
        assert torch.equal(v, sd[k]) or k.endswith("num_batches_tracked"), k
    with torch.no_grad():
        got = build_seg2d(loaded_cfg, loaded, device="cpu")(to_torch(img))
    assert_close(got["det_scores"], ref["det_scores"], atol=PROB_ATOL, name="det_scores")
    assert_close(got["det_masks"], ref["det_masks"], atol=PROB_ATOL, name="det_masks")

    path = str(tmp_path / "port.ckpt")
    save_seg2d_checkpoint(path, build_seg2d(cfg, sd, device="cpu"), cfg)
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert asdict(saved["cfg"]) == asdict(jcfg)
    jmodel, _ = jax_build_seg2d(saved["cfg"])
    back = {k: np.asarray(v) for k, v in jax.jit(lambda v, x: jmodel.apply(
        v, x, train=False))({"params": saved["params"],
                             "batch_stats": saved["batch_stats"]}, img).items()}
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    assert not os.path.exists(path + ".tmp")


def test_mask_rcnn_backend_matches_jax(tmp_path):
    """MaskRCNNBackend against JaxMaskRCNNBackend on one checkpoint (full
    HTC) and a 75x250 BGR image: the same detections (boxes to 1e-3 px in
    the camera image, scores 1e-5, categories equal) and the same masks at
    every pixel whose pasted value (the reference's cv2.resize of its 28x28
    probabilities) lies more than 2e-5 from the 0.5 threshold: the two
    models' probabilities agree to 1e-5, and cv2's float resize (through
    IPP) and the port's to 1.5e-6. The mask heads' logits are scaled up so
    that the masks reach well past 0.5 on both sides."""
    jcfg, cfg = htc_cfgs("full_htc")
    sd = seeded_seg2d_weights(cfg, seed=2)
    for k in sd:
        if k.startswith("mask_head") and ".logits." in k:
            sd[k] = sd[k] * 30
    path = str(tmp_path / "htc.ckpt")
    jax_save(path, seg2d_flax_from_state_dict(sd), jcfg)
    image = (np.random.RandomState(11).rand(75, 250, 3) * 255).astype(np.uint8)
    ref_backend = JaxMaskRCNNBackend(path, score_thresh=0.3)
    ref = ref_backend(image)
    got = MaskRCNNBackend(path, score_thresh=0.3, device="cpu")(image)
    assert len(ref) >= 2 and len(got) == len(ref)
    # the reference's 28x28 probabilities, from its own preprocessing
    img = cv2.resize(image[..., ::-1], (128, 96)).astype(np.float32)
    img = (img / 255.0 - np.array([0.485, 0.456, 0.406], np.float32)) / \
        np.array([0.229, 0.224, 0.225], np.float32)
    out = ref_backend._fwd(ref_backend.variables, jnp.asarray(img[None]))
    slots = np.nonzero(np.asarray(out["det_scores"][0]) >= 0.3)[0]
    near, pixels = 0, 0
    for r, g, d in zip(ref, got, slots):
        assert g["category_id"] == r["category_id"] == 3
        assert abs(g["score"] - r["score"]) <= PROB_ATOL
        assert_close(np.asarray(g["bbox"]), np.asarray(r["bbox"]), atol=1e-3, name="bbox")
        assert g["mask"].dtype == bool and g["mask"].shape == (75, 250)
        x1, y1, w, h = r["bbox"]
        bw, bh = max(int(round(w)), 1), max(int(round(h)), 1)
        vals = cv2.resize(np.asarray(out["det_masks"][0, d]), (bw, bh))
        sure = np.ones((75, 250), bool)
        xi, yi = max(int(round(x1)), 0), max(int(round(y1)), 0)
        sure[yi:yi + bh, xi:xi + bw] = (np.abs(vals - 0.5) > 2e-5)[:75 - yi, :250 - xi]
        np.testing.assert_array_equal(g["mask"][sure], r["mask"][sure])
        near, pixels = near + int((~sure).sum()), pixels + vals.size
        assert r["mask"].any() and (vals < 0.5).any()
    print(f"backend masks: {near} of {pixels} pasted pixels within 2e-5 of 0.5")
    assert near <= 1e-3 * pixels


def test_backend_resize_is_cv2s():
    """The backend's uint8 resize (``resize_linear`` on uint8) against cv2's
    INTER_LINEAR, bit for bit: KITTI's 375x1242 to bench.py's 384x1280 and
    to 96x128, the test image's 75x250, and one channel."""
    from seevcn_torch.ops.resize import resize_linear

    rng = np.random.RandomState(12)
    for (h, w), (oh, ow) in (((375, 1242), (384, 1280)), ((375, 1242), (96, 128)),
                             ((75, 250), (96, 128)), ((75, 250), (384, 1280)),
                             ((40, 7), (3, 300))):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(resize_linear(to_torch(img), (oh, ow)).numpy(),
                                      cv2.resize(img, (ow, oh)))
        np.testing.assert_array_equal(
            resize_linear(to_torch(img[..., 0]), (oh, ow)).numpy(),
            cv2.resize(np.ascontiguousarray(img[..., 0]), (ow, oh)))
    assert to_numpy(resize_linear(to_torch(img), (5, 5))).dtype == np.uint8
