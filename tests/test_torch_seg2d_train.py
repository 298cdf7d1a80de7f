"""Mask R-CNN training in the port (seevcn_torch.models.seg2d, train/optim.py)
against the JAX package on the CPU, at the reference's tiny test config
(tests/test_seg2d.py's ``_tiny_cfg``: a 96x128 image, one block a stage at
widths 16-64, FPN width 32, max_gt 4, 16 RoIs a image, 64 anchors a image).

The target logic (``encode_deltas``, ``rpn_targets``, ``sample_rois``,
``mask_targets``, the three losses) is held function by function against
``MaskRCNNLogic``; the random priorities of the two samples are JAX's own
draws (``jax.random.uniform`` of the keys the reference splits), passed to
the port. The whole training forward, loss and gradients are held against
``model.apply(..., train=True)`` / ``model.loss`` under ``jax.value_and_grad``
at JAX's init (exported by ``seg2d_state_dict_from_flax``) on two synthetic
scenes, with the draws the reference folds from its key: ``fold_in(rng, i)``
split for image i's RoI sample, ``fold_in(rng, 100 + i)`` split for its
anchors. Then two train steps against ``make_seg2d_train_step`` with the
CLI's optax chain, in the packed wire format with the ``it`` counter.

JAX runs those two in f64 (``jax.enable_x64``), the port in f32: JAX's own
f32 gradients of this model on the CPU stray from its f64 ones by more
than the tolerance in stages 0-1, because flax's BatchNorm takes the
variance as E[x^2] - E[x]^2 by default, which cancels in f32; the port's
batch norm takes the mean of squared deviations, as flax does with
``use_fast_variance=False``, and its f32 gradients stay close to JAX's f64
ones (``test_backbone_gradients_against_jax_f64`` measures the three). In
f64 JAX draws its priorities in f64; the port is given those draws as they
are, so both order the same keys.

Tolerances, each stated at its assertion:
- indices, labels, weights, masks of the samples: equal;
- f32 values from the same formula on the same inputs (deltas): 1e-5;
- boxes decoded from the RPN's outputs: 1e-4 px;
- features and logits: 1e-5 of their scale (rtol 1e-5, atol 1e-5 x max);
- loss terms: 1e-5 absolute and relative;
- gradients: 5e-4 of each tensor's largest |gradient|;
- batch-norm running statistics: 1e-5 absolute and relative;
- parameters after two steps: 1e-5 where the gradient is sure (at least 5%
  of its tensor's largest and 1e-6 after the clip, in both steps), else 2
  lr a step (Adam's first update is lr g / (|g| + 1e-8): a gradient that
  is rounding noise may step either way).
"""
import functools
from dataclasses import asdict

import jax
import flax.linen as flax_nn
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from seevcn_tpu.models.seg2d import maskrcnn as JM
from seevcn_tpu.models.seg2d.backend import build_seg2d as jax_build_seg2d
from seevcn_tpu.models.seg2d.backend import init_seg2d as jax_init_seg2d
from seevcn_tpu.models.seg2d.backend import make_seg2d_train_step as jax_train_step
from seevcn_tpu.models.seg2d.synthetic import synth_batch
from seevcn_torch.models.seg2d import maskrcnn as TM
from seevcn_torch.models.seg2d.backend import (LOSS_TERMS, build_seg2d, decode_wire,
                                               init_seg2d, make_seg2d_train_step,
                                               seg2d_train_forward)
from seevcn_torch.testing import assert_close, tiny_seg2d_cfg, to_numpy, to_torch
from seevcn_torch.train.optim import build_seg2d_optimizer, warmup_cosine_decay_schedule
from seevcn_torch.train.train import TrainState
from seevcn_torch.utils.weights import seg2d_flax_from_state_dict, seg2d_state_dict_from_flax
from test_seg2d import _tiny_cfg

B = 2
FEAT_RTOL = 1e-5
OUT_KEYS = ("rpn_obj", "rpn_box", "rois", "roi_cls_tgt", "roi_delta_tgt", "roi_fg",
            "roi_matched", "cls_logits", "box_deltas", "mask_logits")


def _close_features(got, ref, name):
    ref = np.asarray(ref)
    assert_close(got, ref, atol=FEAT_RTOL * float(np.abs(ref).max()), rtol=FEAT_RTOL,
                 name=name)


def _cfgs(**kw):
    return (JM.Seg2DConfig(**{**asdict(_tiny_cfg()), **kw}),
            TM.Seg2DConfig(**{**asdict(tiny_seg2d_cfg()), **kw}))


def _uniform_pair(key, n):
    """The two draws the reference makes from ``key``: split, then U[0, 1)
    of length n from each half."""
    k1, k2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(k1, (n,))),
                     np.asarray(jax.random.uniform(k2, (n,)))])


def _step_draws(rng, cfg, n_anchors):
    """The RoI and anchor priorities the reference's forward and loss draw
    from ``rng``: (B, 2, P + G) and (B, 2, N)."""
    n_cand = cfg.num_proposals + cfg.max_gt
    roi = np.stack([_uniform_pair(jax.random.fold_in(rng, i), n_cand) for i in range(B)])
    rpn = np.stack([_uniform_pair(jax.random.fold_in(rng, 100 + i), n_anchors)
                    for i in range(B)])
    return roi, rpn


def _batch(seed=0):
    """Two synthetic scenes at 96x128, up to 4 cars, padding rows where a
    scene has fewer."""
    return synth_batch(np.random.RandomState(seed), (96, 128), B, max_gt=4)


# ---------------------------------------------------------------------------
# deltas and targets
# ---------------------------------------------------------------------------
def test_encode_deltas():
    rng = np.random.RandomState(0)
    anchors = np.concatenate(JM.generate_anchors_2d((96, 128)))[::5]
    xy = rng.uniform(-10, 120, (len(anchors), 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 60, (len(anchors), 2))], 1)
    boxes[:30, 2] = boxes[:30, 0]                 # zero width
    boxes[30:60, 3] = boxes[30:60, 1] - 3.0       # negative height
    boxes = boxes.astype(np.float32)
    anchors[:10, 2] = anchors[:10, 0]             # a zero-width anchor
    ref = np.asarray(JM.encode_deltas(jnp.asarray(boxes), jnp.asarray(anchors)))
    got = TM.encode_deltas(to_torch(boxes), to_torch(anchors))
    assert np.isfinite(ref).all()
    # 1e-5 absolute, 2e-7 relative: the log of a floored width reaches -53
    assert_close(got, ref, atol=1e-5, rtol=2e-7, name="deltas")


def _corner_gt():
    """A 14x8 box in the image's corner: every anchor that holds it has the
    same IoU (0.11), so its best anchor is anchor 0, which it cannot make
    positive by IoU."""
    return np.array([0.0, 0.0, 14.0, 8.0], np.float32)


def _rpn_case(name):
    """(cfg overrides, gt_boxes (4, 4), gt_valid (4,))."""
    anchors = np.concatenate(JM.generate_anchors_2d((96, 128)))
    rng = np.random.RandomState(1)
    gtb = np.zeros((4, 4), np.float32)
    gtv = np.zeros(4, bool)
    kw = {}
    if name == "no_valid_gt":
        gtb[:2] = [[10, 10, 50, 40], [60, 20, 110, 70]]
    elif name in ("padding_after", "padding_before"):
        # a corner box and the padding rows mark anchor 0; the last row's
        # value stands: padding after the box (rows 1 and 3) unmarks it,
        # padding before it (rows 0 and 1, the box at 3) does not
        k = 0 if name == "padding_after" else 3
        gtb[k], gtv[k] = _corner_gt(), True
        gtb[2], gtv[2] = [60, 20, 110, 70], True
    elif name == "more_pos_than_n_fg":
        # four anchors as boxes: each has a few neighbours at IoU >= 0.7,
        # more than the 8 positives of rpn_batch 16
        kw = {"rpn_batch": 16}
        gtb[:] = anchors[[2000, 2200, 2400, 2600]]
        gtv[:] = True
    elif name == "fewer_pos_than_n_fg":
        gtb[0], gtv[0] = anchors[900] + rng.uniform(-2, 2, 4), True
    return kw, gtb, gtv


@pytest.mark.parametrize("case", ["no_valid_gt", "padding_after", "padding_before",
                                  "more_pos_than_n_fg", "fewer_pos_than_n_fg"])
def test_rpn_targets(case):
    kw, gtb, gtv = _rpn_case(case)
    jcfg, tcfg = _cfgs(**kw)
    logic = JM.MaskRCNNLogic(jcfg)
    key = jax.random.PRNGKey(3)
    ref = [np.asarray(x) for x in logic.rpn_targets(jnp.asarray(gtb), jnp.asarray(gtv),
                                                    key)]
    u = _uniform_pair(key, logic.anchors.shape[0])
    got = TM.rpn_targets(tcfg, to_torch(np.asarray(logic.anchors)), to_torch(gtb),
                         to_torch(gtv), to_torch(u[0]), to_torch(u[1]))
    for name, g, r in zip(("labels", "deltas", "weights", "fg"), got, ref):
        if name == "deltas":
            assert_close(g, r, atol=1e-5, rtol=2e-7, name=name)
        else:
            assert_close(g, r, name=name)
    n_fg = int(tcfg.rpn_batch * tcfg.rpn_fg_fraction)
    n_pos, n_w = int(ref[3].sum()), int(ref[2].sum())
    if case == "no_valid_gt":
        assert n_pos == 0 and n_w == tcfg.rpn_batch - n_fg
    if case == "padding_after":       # the padding row's False stands on anchor 0
        assert not ref[3][0]
    if case == "padding_before":      # the corner box's True stands
        assert ref[3][0]
    if case == "more_pos_than_n_fg":
        assert n_pos == n_fg
    if case == "fewer_pos_than_n_fg":
        assert 0 < n_pos < n_fg and n_w == n_pos + tcfg.rpn_batch - n_fg


def _roi_case(name, cfg):
    """(proposals (P, 4), valid (P,), gt_boxes, gt_labels, gt_valid)."""
    rng = np.random.RandomState(2)
    p = cfg.num_proposals
    xy = rng.uniform(0, 100, (p, 2))
    props = np.concatenate([xy, xy + rng.uniform(8, 40, (p, 2))], 1).astype(np.float32)
    valid = rng.rand(p) > 0.2
    gtb = np.zeros((4, 4), np.float32)
    gtl = np.zeros(4, np.int32)
    gtv = np.zeros(4, bool)
    if name == "more_fg_than_n_fg":
        gtb[:3] = [[10, 10, 50, 40], [60, 20, 110, 70], [30, 50, 70, 90]]
        gtv[:3] = True
        # jittered copies of the ground truth among the proposals
        props[:12] = gtb[np.arange(12) % 3] + rng.uniform(-2, 2, (12, 4))
    elif name == "fewer_fg_than_n_fg":
        # one ground truth, far from every proposal: the foreground is the
        # appended box alone, and 3 of the 4 fg picks are -1 rows in index
        # order
        gtb[1], gtv[1] = [100, 70, 126, 94], True
        props[:, :2] = np.minimum(props[:, :2], 60)
        props[:, 2:] = np.minimum(props[:, 2:], 80)
    elif name == "no_valid_gt":
        gtb[0] = [10, 10, 50, 40]
    return props, valid, gtb, gtl, gtv


@pytest.mark.parametrize("case", ["more_fg_than_n_fg", "fewer_fg_than_n_fg",
                                  "no_valid_gt"])
def test_sample_rois(case):
    jcfg, tcfg = _cfgs()
    props, valid, gtb, gtl, gtv = _roi_case(case, jcfg)
    key = jax.random.PRNGKey(5)
    ref = [np.asarray(x) for x in JM.MaskRCNNLogic(jcfg).sample_rois(
        *(jnp.asarray(x) for x in (props, valid, gtb, gtl, gtv)), key)]
    u = _uniform_pair(key, len(props) + 4)
    got = TM.sample_rois(tcfg, *(to_torch(x) for x in (props, valid, gtb, gtl, gtv)),
                         to_torch(u[0]), to_torch(u[1]))
    for name, g, r in zip(("rois", "classes", "deltas", "is_fg", "matched"), got, ref):
        if name == "deltas":
            assert_close(g, r, atol=1e-5, rtol=2e-7, name=name)
        else:
            assert_close(g, r, name=name)      # rois: the same rows, bit for bit
    n_fg = int(tcfg.roi_batch * tcfg.roi_fg_fraction)
    if case == "more_fg_than_n_fg":
        assert ref[3].sum() == n_fg
    if case == "fewer_fg_than_n_fg":
        # the padding picks: the lowest-index non-foreground rows, as
        # background rows of the sample
        assert ref[3].sum() == 1 and (ref[1][1:n_fg] == 0).all()
        np.testing.assert_array_equal(ref[0][1:n_fg], props[:n_fg - 1])
    if case == "no_valid_gt":
        assert not ref[3].any() and (ref[1] == 0).all()


@pytest.mark.parametrize("case", ["random", "pixel_aligned"])
def test_mask_targets(case):
    """Equal except at pixels whose bilinear value lies within 1e-6 of 0.5
    (the f32 operations may round it to either side); those pixels are
    counted and bounded. ``pixel_aligned`` RoIs are whole pixels 28 wide,
    so the samples sit at half pixels and land on exactly 0.5 on every
    mask edge: exact in f32 on both sides, equal."""
    img, boxes, labels, valid, masks = _batch(3)
    gt = masks[0]
    rng = np.random.RandomState(4)
    r = 40
    # RoIs around the valid boxes, matched to them
    matched = rng.choice(np.nonzero(valid[0])[0], r).astype(np.int32)
    if case == "random":
        rois = boxes[0][matched] + rng.uniform(-6, 6, (r, 4))
    else:
        xy = np.round(boxes[0][matched, :2] + rng.uniform(-6, 6, (r, 2)))
        rois = np.concatenate([xy, xy + 28], 1)
    rois = rois.astype(np.float32)
    logic = JM.MaskRCNNLogic(_tiny_cfg())
    ref = np.asarray(logic.mask_targets(jnp.asarray(gt), jnp.asarray(rois),
                                        jnp.asarray(matched)))
    got = to_numpy(TM.mask_targets(to_torch(gt), to_torch(rois), to_torch(matched)))
    # the bilinear values before the threshold, in f64
    steps = (np.arange(28) + 0.5) / 28
    rw = np.maximum(rois[:, 2] - rois[:, 0], 1e-3)
    rh = np.maximum(rois[:, 3] - rois[:, 1], 1e-3)
    gx = rois[:, 0, None] + steps * rw[:, None]
    gy = rois[:, 1, None] + steps * rh[:, None]
    x, y = np.broadcast_arrays(gx[:, None, :], gy[:, :, None])
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    h, w = gt.shape[1:]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = gt[matched[:, None, None], np.clip(yi, 0, h - 1).astype(int),
               np.clip(xi, 0, w - 1).astype(int)]
        return np.where(inb, v, 0.0)

    raw = ((tap(x0, y0) * (1 - wx) + tap(x0 + 1, y0) * wx) * (1 - wy)
           + (tap(x0, y0 + 1) * (1 - wx) + tap(x0 + 1, y0 + 1) * wx) * wy)
    near = np.abs(raw - 0.5) <= 1e-6
    differ = got != ref
    assert not (differ & ~near).any()
    assert differ.sum() <= max(near.sum(), 0) and differ.sum() <= 1e-3 * ref.size
    assert 0.05 < ref.mean() < 0.95               # both values occur
    if case == "pixel_aligned":
        assert near.sum() > 0 and differ.sum() == 0


def _loss_inputs(seed, all_background):
    """The three losses' inputs: 300 anchors, 16 RoIs, one class; f32 but
    the classes (int32) and the fg masks (bool)."""
    rng = np.random.RandomState(seed)
    n, r, k = 300, 16, 1
    labels, weights = rng.rand(n) > 0.7, rng.rand(n) > 0.5
    cls_tgt = np.zeros(r, np.int32) if all_background else rng.randint(0, k + 1, r)
    f32 = {"rpn_obj": rng.randn(n) * 3, "rpn_box": rng.randn(n, 4), "labels": labels,
           "deltas": rng.randn(n, 4), "weights": weights,
           "cls_logits": rng.randn(r, k + 1) * 2, "box_deltas": rng.randn(r, k, 4),
           "delta_tgt": rng.randn(r, 4), "mask_logits": rng.randn(r, 28, 28, k) * 2,
           "mask_tgt": rng.rand(r, 28, 28) > 0.5}
    return {**{name: v.astype(np.float32) for name, v in f32.items()},
            "cls_tgt": cls_tgt.astype(np.int32), "is_fg": cls_tgt > 0,
            "fg": labels & weights & (not all_background)}


@pytest.mark.parametrize("all_background", [False, True])
def test_losses(all_background):
    """The three losses, 1e-6 absolute and relative; all-background RoIs
    (class 0: jax.nn.one_hot(-1) is all zeros) give a zero regression and
    mask loss and a finite cross-entropy."""
    jcfg, tcfg = _cfgs()
    logic = JM.MaskRCNNLogic(jcfg)
    d = _loss_inputs(6, all_background)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: to_torch(v) for k, v in d.items()}
    ref_rpn = logic.rpn_loss(j["rpn_obj"], j["rpn_box"], j["labels"], j["deltas"],
                             j["weights"], j["fg"])
    got_rpn = TM.rpn_loss(t["rpn_obj"], t["rpn_box"], t["labels"], t["deltas"],
                          t["weights"], t["fg"])
    ref_box = logic.box_loss(j["cls_logits"], j["box_deltas"], j["cls_tgt"],
                             j["delta_tgt"], j["is_fg"])
    got_box = TM.box_loss(tcfg, t["cls_logits"], t["box_deltas"], t["cls_tgt"],
                          t["delta_tgt"], t["is_fg"])
    ref_mask = logic.mask_loss(j["mask_logits"], j["mask_tgt"], j["cls_tgt"], j["is_fg"])
    got_mask = TM.mask_loss(tcfg, t["mask_logits"], t["mask_tgt"], t["cls_tgt"],
                            t["is_fg"])
    for (g, gt), (r, rt) in ((got_rpn, ref_rpn), (got_box, ref_box)):
        assert_close(g, np.asarray(r), atol=1e-6, rtol=1e-6, name="loss")
        for k in rt:
            assert_close(gt[k], np.asarray(rt[k]), atol=1e-6, rtol=1e-6, name=k)
    assert_close(got_mask, np.asarray(ref_mask), atol=1e-6, rtol=1e-6, name="mask")
    if all_background:
        assert float(ref_box[1]["box_reg"]) == 0 and float(ref_mask) == 0
        assert float(ref_rpn[1]["rpn_reg"]) == 0
        assert float(got_box[1]["box_cls"]) > 0


# ---------------------------------------------------------------------------
# the training forward, loss and gradients
# ---------------------------------------------------------------------------
def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64)
                        if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a),
                        tree)


@pytest.fixture(scope="module")
def jax_init():
    """(JAX cfg, port cfg, JAX model, its logic, JAX's init as numpy)."""
    jcfg, tcfg = _cfgs()
    model, logic = jax_build_seg2d(jcfg)
    return jcfg, tcfg, model, logic, jax.tree.map(np.asarray, jax_init_seg2d(model))


class _TwoPassBatchNormLinen:
    """flax.linen as maskrcnn.py sees it, but BatchNorm with
    ``use_fast_variance=False``: the variance as the mean of squared
    deviations, not E[x^2] - E[x]^2."""

    def __getattr__(self, name):
        if name == "BatchNorm":
            return functools.partial(flax_nn.BatchNorm, use_fast_variance=False)
        return getattr(flax_nn, name)


def test_backbone_gradients_against_jax_f64(jax_init, monkeypatch):
    """Why this module holds the port against JAX in f64: on the backbone
    alone (train mode, a random cotangent on P2..P6) JAX's own f32
    gradients stray from its f64 ones by more than the 5e-4 the tests
    allow, in stages 0-1. The cause is flax's BatchNorm, whose default
    variance is E[x^2] - E[x]^2, which cancels in f32; the port's batch norm
    takes torch's, the mean of squared deviations. The port's f32 gradients
    and JAX's f32 with ``use_fast_variance=False`` both stay within 2e-5 of
    JAX's f64 ones (``pytest -s`` prints the three readings)."""
    jcfg, tcfg, _, _, variables = jax_init
    sub = {k: v["backbone"] for k, v in variables.items()}
    imgs = _batch(0)[0]
    rng = np.random.RandomState(0)
    cots = None

    def grads(dtype):
        nonlocal cots
        fpn = JM.ResNetFPN(stage_sizes=jcfg.stage_sizes,
                           stage_channels=jcfg.stage_channels,
                           fpn_channels=jcfg.fpn_channels)
        with jax.enable_x64(dtype == np.float64):
            p, st = jax.tree.map(lambda a: jnp.asarray(a, dtype), (sub["params"],
                                                                   sub["batch_stats"]))
            x = jnp.asarray(imgs, dtype)

            def f(p):
                return fpn.apply({"params": p, "batch_stats": st}, x, True,
                                 mutable=["batch_stats"])[0]
            if cots is None:
                cots = [rng.randn(*o.shape) for o in jax.eval_shape(f, p)]
            g = jax.jit(jax.grad(lambda p: sum((a * jnp.asarray(c, dtype)).sum()
                                               for a, c in zip(f(p), cots))))(p)
            return seg2d_state_dict_from_flax(
                {"params": {"backbone": _f64(g)}, "batch_stats": {"backbone": _f64(st)}})

    g64, g32 = grads(np.float64), grads(np.float32)
    monkeypatch.setattr(JM, "nn", _TwoPassBatchNormLinen())
    g32_two_pass = grads(np.float32)
    monkeypatch.undo()
    port = build_seg2d(tcfg, seg2d_state_dict_from_flax(variables), device="cpu").train()
    out = port.backbone(to_torch(imgs).permute(0, 3, 1, 2))
    sum((a.permute(0, 2, 3, 1) * to_torch(c.astype(np.float32))).sum()
        for a, c in zip(out, cots)).backward()
    got = {f"backbone.{n}": p.grad for n, p in port.backbone.named_parameters()}

    def worst(g):
        return max(float((g[n].double() - g64[n]).abs().max() / g64[n].abs().max())
                   for n in got)

    print(f"backbone gradients against JAX's f64: the port's f32 {worst(got):.3g}, "
          f"JAX's f32 with the two-pass variance {worst(g32_two_pass):.3g}, JAX's f32 "
          f"as flax defaults it {worst(g32):.3g} of a tensor's largest")
    assert worst(got) <= 2e-5
    assert worst(g32_two_pass) <= 2e-5


@pytest.fixture(scope="module")
def forward_pair(jax_init):
    """JAX's training forward, loss and gradients at its init on two
    scenes, in f64 (JAX's f32 gradients on the CPU stray from its own f64
    ones, see the module's docstring), and the port's in f32 from the same
    weights and JAX's draws."""
    jcfg, tcfg, model, logic, variables = jax_init
    batch = _batch(0)
    with jax.enable_x64(True):
        imgs, gtb, gtl, gtv, gtm = (jnp.asarray(x) for x in _f64(batch))
        rng = jax.random.PRNGKey(11)

        @jax.jit
        def value_and_grad(params, stats):
            def loss_fn(p):
                out, mut = model.apply({"params": p, "batch_stats": stats}, imgs, gtb,
                                       gtl, gtv, gtm, train=True, rng=rng,
                                       mutable=["batch_stats"])
                loss, tb = model.loss(out, gtb, gtl, gtv, gtm, rng)
                return loss, (tb, out, mut["batch_stats"])
            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        v64 = _f64(variables)
        (loss, (tb, out, stats)), grads = value_and_grad(v64["params"], v64["batch_stats"])
        ref = {"loss": np.asarray(loss), "terms": jax.tree.map(np.asarray, tb),
               "out": jax.tree.map(np.asarray, out),
               "grads": seg2d_state_dict_from_flax({"params": jax.tree.map(np.asarray, grads),
                                                    "batch_stats": v64["batch_stats"]}),
               "after": seg2d_state_dict_from_flax(jax.tree.map(
                   np.asarray, {"params": v64["params"], "batch_stats": stats}))}
        # JAX's draws, f64 here: the port orders the same keys
        roi_u, rpn_u = _step_draws(rng, jcfg, logic.anchors.shape[0])

    port = build_seg2d(tcfg, seg2d_state_dict_from_flax(variables), device="cpu").train()
    state = TrainState(port, None)
    t = [to_torch(x) for x in batch]
    loss_t, tb_t, out_t = seg2d_train_forward(state, *t, roi_u=to_torch(roi_u),
                                              rpn_u=to_torch(rpn_u))
    loss_t.backward()
    got = {"loss": loss_t.detach(), "terms": {k: v.detach() for k, v in tb_t.items()},
           "out": {k: v.detach() for k, v in out_t.items()},
           "grads": {n: p.grad for n, p in port.named_parameters()},
           "after": port.state_dict()}
    return ref, got, batch[3]


def test_train_forward_matches_jax(forward_pair):
    """Every output key: the RoI sample equal (classes, fg, matched; the
    rois, proposals decoded from the RPN's f32 outputs, to 1e-4 px, and
    their delta targets to 1e-3, BOX_W x 1e-4 px over a RoI a few pixels
    wide), features and logits to 1e-5 of their scale."""
    ref, got, gtv = forward_pair
    assert set(got["out"]) == set(OUT_KEYS) == set(ref["out"])
    for k in ("roi_cls_tgt", "roi_fg", "roi_matched"):
        assert_close(got["out"][k], ref["out"][k], name=k)
    assert_close(got["out"]["rois"], ref["out"]["rois"], atol=1e-4, name="rois")
    assert_close(got["out"]["roi_delta_tgt"], ref["out"]["roi_delta_tgt"], atol=1e-3,
                 name="roi_delta_tgt")
    for k in ("rpn_obj", "rpn_box", "cls_logits", "box_deltas", "mask_logits"):
        _close_features(got["out"][k], ref["out"][k], k)
    # the batch has padding rows and a foreground sample
    assert not gtv.all() and ref["out"]["roi_fg"].any()


def test_train_loss_terms_match_jax(forward_pair):
    ref, got, _ = forward_pair
    assert set(got["terms"]) == set(LOSS_TERMS) == set(ref["terms"])
    assert_close(got["loss"], ref["loss"], atol=1e-5, rtol=1e-5, name="loss")
    for k in LOSS_TERMS:
        assert_close(got["terms"][k], ref["terms"][k], atol=1e-5, rtol=1e-5, name=k)
        assert float(ref["terms"][k]) > 0


def test_train_gradients_match_jax(forward_pair):
    """5e-4 of each tensor's largest |gradient|, every parameter."""
    ref, got, _ = forward_pair
    assert set(got["grads"]) == {k for k in ref["grads"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    for n, g in got["grads"].items():
        r = ref["grads"][n]
        assert_close(g, r, atol=5e-4 * float(r.abs().max()) + 1e-12, name=f"grad {n}")


def test_batch_norm_statistics_after_the_forward(forward_pair):
    """flax's running update (momentum 0.9, the biased batch variance), 1e-5
    absolute and relative."""
    ref, got, _ = forward_pair
    keys = [k for k in ref["after"] if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 13             # the stem's and 3 a block
    for k in keys:
        assert_close(got["after"][k], ref["after"][k], atol=1e-5, rtol=1e-5, name=k)
        assert not torch.equal(got["after"][k], torch.zeros_like(got["after"][k])
                               if k.endswith("mean") else torch.ones_like(got["after"][k]))


def test_train_needs_training_mode():
    model = build_seg2d(tiny_seg2d_cfg(), device="cpu")
    imgs, gtb, gtl, gtv, gtm = (to_torch(x) for x in _batch(1))
    with pytest.raises(ValueError, match="training mode"):
        model(imgs, gtb, gtl, gtv, gtm, train=True)


def test_draws_come_from_the_generator():
    """With no draws given the RoI and anchor priorities come from the
    generator: one seed repeats, another differs."""
    tcfg = tiny_seg2d_cfg()
    sd = init_seg2d(TM.MaskRCNN(tcfg), torch.Generator().manual_seed(0)).state_dict()
    imgs, gtb, gtl, gtv, gtm = (to_torch(x) for x in _batch(1))
    runs = []
    for seed in (1, 2, 1):
        model = build_seg2d(tcfg, sd, device="cpu").train()
        loss, _, out = seg2d_train_forward(TrainState(model, None), imgs, gtb, gtl, gtv,
                                           gtm, torch.Generator().manual_seed(seed))
        runs.append((loss.detach(), out["rois"]))
    assert torch.equal(runs[0][0], runs[2][0]) and torch.equal(runs[0][1], runs[2][1])
    assert not torch.equal(runs[0][1], runs[1][1])


# ---------------------------------------------------------------------------
# the train step and the optimizer
# ---------------------------------------------------------------------------
LR, WD = 1e-3, 1e-4


@pytest.fixture(scope="module")
def two_steps(jax_init):
    """Two steps of JAX's make_seg2d_train_step with the CLI's chain
    (warm-up 1, so the second update runs at the peak lr; in f64, as the
    gradients above) and of the port's make_seg2d_train_step with
    build_seg2d_optimizer (f32), in the packed wire format, the step key
    folded from the ``it`` counter. Also the two optimizers alone (optax's
    chain in f32) fed the port's gradients of each step."""
    jcfg, tcfg, model, logic, variables = jax_init
    port = build_seg2d(tcfg, seg2d_state_dict_from_flax(variables), device="cpu").train()
    state = TrainState(port, build_seg2d_optimizer(port.parameters(), LR, WD, 1, 100))
    step = make_seg2d_train_step(packed_masks=True)
    grads = {}
    update = state.optimizer.step

    def record_then_update(count):        # the gradients before the clip
        grads[count] = {n: p.grad.clone() for n, p in port.named_parameters()}
        update(count)

    state.optimizer.step = record_then_update
    wires = []
    for k in range(2):
        imgs, gtb, gtl, gtv, gtm = _batch(10 + k)
        packed = np.packbits(gtm >= 0.5, axis=-1, bitorder="little")
        wires.append((imgs.astype(np.float16), gtb, gtl, gtv, packed))

    out = []
    with jax.enable_x64(True):
        v64 = _f64(variables)
        sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
        tx = optax.chain(optax.clip_by_global_norm(10.0),
                         optax.adamw(sched, weight_decay=WD))
        jstate = {"params": v64["params"], "batch_stats": v64["batch_stats"],
                  "opt": tx.init(v64["params"]), "it": jnp.zeros((), jnp.int32)}
        jstep = jax_train_step(model, tx, packed_masks=True)
        rng = jax.random.PRNGKey(0)
        for k, wire in enumerate(wires):
            before = {n: p.detach().clone() for n, p in port.named_parameters()}
            jstate, jmetrics = jstep(jstate, *(jnp.asarray(x) for x in wire), rng)
            roi_u, rpn_u = _step_draws(jax.random.fold_in(rng, k), jcfg,
                                       logic.anchors.shape[0])
            metrics = step(state, *(to_torch(x) for x in wire), roi_u=to_torch(roi_u),
                           rpn_u=to_torch(rpn_u))
            out.append({
                "jax_metrics": jax.tree.map(np.asarray, jmetrics), "metrics": metrics,
                "grads": grads[k], "before": before,
                "jax_after": seg2d_state_dict_from_flax(jax.tree.map(
                    np.asarray, {"params": jstate["params"],
                                 "batch_stats": jstate["batch_stats"]})),
                "after": {n: v.clone() for n, v in port.state_dict().items()},
                "lr": warmup_cosine_decay_schedule(0.0, LR, 1, 100)(k)})
    assert state.step == 2

    # the optimizers alone, optax's chain in f32, on the port's gradients
    sched = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 100)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(sched, weight_decay=WD))
    opt_model = build_seg2d(tcfg, seg2d_state_dict_from_flax(variables), device="cpu")
    opt = build_seg2d_optimizer(opt_model.parameters(), LR, WD, 1, 100)
    jparams = variables["params"]
    jopt = tx.init(jparams)
    for k in range(2):
        # the gradients as a flax tree (the state dict's buffers tell the
        # batch norms apart)
        g = seg2d_flax_from_state_dict({**opt_model.state_dict(), **grads[k]})["params"]
        upd, jopt = jax.jit(tx.update)(g, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, p in opt_model.named_parameters():
            p.grad = grads[k][n].clone()
        opt.step(k)
        out[k]["opt"] = {n: p.detach().clone() for n, p in opt_model.named_parameters()}
        out[k]["jax_opt"] = seg2d_state_dict_from_flax(
            {"params": jax.tree.map(np.asarray, jparams),
             "batch_stats": variables["batch_stats"]})
    return out


def test_two_train_steps_match_jax(two_steps):
    """Loss terms 1e-5 in both steps (the second starts from weights apart
    by Adam's noise steps: 1e-4 there); the parameters after each step
    tightly where the gradient is sure, 2 lr a step elsewhere; running
    statistics 1e-5 (1e-4 after the second)."""
    lr_sum = 0.0
    for k, s in enumerate(two_steps):
        tol = 1e-5 if k == 0 else 1e-4
        lr_sum += s["lr"]
        assert set(s["metrics"]) == {"loss", *LOSS_TERMS}
        for name, v in s["metrics"].items():
            assert_close(v, s["jax_metrics"][name], atol=tol, rtol=tol, name=name)
        params = set(s["grads"])
        for n, v in s["after"].items():
            ref = s["jax_after"][n]
            if n.endswith("num_batches_tracked"):
                continue
            if n not in params:
                assert_close(v, ref, atol=tol, rtol=tol, name=n)
                continue
            sure = torch.ones_like(v, dtype=torch.bool)
            for prev in two_steps[:k + 1]:
                g = prev["grads"][n].abs()
                norm = float(torch.sqrt(sum((x ** 2).sum() for x in prev["grads"].values())))
                sure &= (g >= 0.05 * g.max()) & (g * min(10 / norm, 1.0) >= 1e-6)
            assert_close(v[sure], ref[sure], atol=1e-5, name=f"updated {n}")
            assert_close(v, ref, atol=2 * lr_sum + 1e-7, name=f"updated {n} (all)")
    # step 0 runs at lr 0: no parameter moves; step 1 moves them all
    first, second = two_steps
    assert first["lr"] == 0.0 and second["lr"] == LR
    for n in params:
        assert torch.equal(first["after"][n], first["before"][n])
        assert not torch.equal(second["after"][n], second["before"][n]), n


@pytest.mark.parametrize("step", [0, 1])
def test_optimizer_matches_optax_on_the_same_gradients(two_steps, step):
    """clip_by_global_norm(10) -> adamw(warmup-cosine, weight decay 1e-4),
    the port's and optax's fed the same gradients: within 1e-7 and two f32
    ulps."""
    s = two_steps[step]
    for n, v in s["opt"].items():
        assert_close(v, s["jax_opt"][n], atol=1e-7, rtol=2.5e-7, name=n)


@pytest.mark.parametrize("count", [0, 1, 199, 200, 1000, 1999, 2500])
def test_warmup_cosine_decay_schedule(count):
    """Against optax's at the CLI's defaults (0 -> 1e-3 over 200, to 0 at
    2000), 1e-9 absolute and 1e-6 relative (optax evaluates it in f32)."""
    ref = float(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 200, 2000)(count))
    got = warmup_cosine_decay_schedule(0.0, 1e-3, 200, 2000)(count)
    assert abs(got - ref) <= 1e-9 + 1e-6 * abs(ref)


def test_init_seg2d_matches_flax_defaults():
    """Each kernel's std within 5% of 1/sqrt(fan_in) (fan_in: input
    channels times taps; a transposed conv's input channels are its
    weight's first dimension), |w| within the truncation bound, biases 0,
    batch norm at identity; one generator seed repeats."""
    cfg = TM.Seg2DConfig(image_size=(96, 128))
    model = init_seg2d(TM.MaskRCNN(cfg), torch.Generator().manual_seed(0))
    again = init_seg2d(TM.MaskRCNN(cfg), torch.Generator().manual_seed(0))
    checked = 0
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            w = m.weight.detach()
            fan_in = w.shape[0] * w[0, 0].numel() if isinstance(
                m, torch.nn.ConvTranspose2d) else w[0].numel()
            std = 1 / np.sqrt(fan_in)
            if w.numel() >= 2000:
                assert abs(float(w.std()) / std - 1) < 0.05, name
            assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 * (1 + 1e-6)
            if m.bias is not None:
                assert not m.bias.any()
            checked += 1
        elif isinstance(m, torch.nn.BatchNorm2d):
            assert (m.weight == 1).all() and not m.bias.any()
            assert not m.running_mean.any() and (m.running_var == 1).all()
    assert checked == 41
    for (n, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("packed", [True, False, None])
def test_decode_wire(packed):
    """f16 images -> f32; masks packed with np.packbits(little) unpack to
    the originals; ``None`` guesses by the packed width."""
    imgs, _, _, _, gtm = _batch(2)
    wire = np.packbits(gtm >= 0.5, axis=-1, bitorder="little") if packed is not False \
        else gtm
    got_i, got_m = decode_wire(to_torch(imgs.astype(np.float16)), to_torch(wire), packed)
    assert got_i.dtype == got_m.dtype == torch.float32
    assert_close(got_i, imgs.astype(np.float16).astype(np.float32), name="images")
    assert_close(got_m, gtm, name="masks")
