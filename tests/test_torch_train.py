"""The training side of the port against the JAX package on the CPU: box
geometry (points_in_boxes, boxes_iou3d, boxes3d_nearest_bev_iou), the
ResidualCoder's encode, the anchor target assigner, the losses, the RoI
sampler, the sparse conv's backward, batch norm's running statistics in
training, and the optimizers and their schedules. The full train steps are
in test_torch_train_step.py.

Every JAX call is jitted. Inputs are made from seeds with numpy; each test
states its tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from __graft_entry__ import _tiny_detector_cfg
from seevcn_tpu.geom import boxes as JB
from seevcn_tpu.models import losses as JL
from seevcn_tpu.models.detectors.second import DetectorConfig as JaxDetectorConfig
from seevcn_tpu.models.modules import box_coder as JBC
from seevcn_tpu.models.modules.common import MaskedBatchNorm as JaxMaskedBN
from seevcn_tpu.models.modules import roi_heads as JR
from seevcn_tpu.ops import iou3d as JI
from seevcn_tpu.ops import sparse as JSP
from seevcn_tpu.train import optim as JO
from seevcn_tpu.utils.config import Cfg as JaxCfg
from seevcn_torch.geom import boxes as TB
from seevcn_torch.models import losses as TL
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import DetectorConfig
from seevcn_torch.models.modules import roi_heads as TR
from seevcn_torch.models.modules.box_coder import ResidualCoder
from seevcn_torch.models.modules.common import BatchNorm2d, MaskedBatchNorm
from seevcn_torch.ops import iou3d as TI
from seevcn_torch.ops import sparse as TSP
from seevcn_torch.testing import assert_close, plain_sparse_backward, to_numpy, to_torch
from seevcn_torch.train import optim as TO
from seevcn_torch.utils.config import Cfg


def _boxes(rng, n, spread=10.0):
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                           rng.uniform(-1, 1, (n, 1)), rng.uniform(1, 5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


# --------------------------------------------------------------------------- #
# geometry
# --------------------------------------------------------------------------- #

def test_points_in_boxes_matches_jax():
    """Equal membership (a bool per pair) and counts; enlarge_box3d exact."""
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 12, 5.0)
    pts = rng.uniform(-7, 7, (3000, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 3, 3000)
    mask = rng.rand(3000) > 0.2
    got = TB.points_in_boxes(to_torch(pts), to_torch(boxes))
    ref = jax.jit(JB.points_in_boxes)(pts, boxes)
    assert_close(got, np.asarray(ref), name="points_in_boxes")
    assert 100 < int(got.sum()) < got.numel() // 2
    assert_close(TB.points_in_boxes_count(to_torch(pts), to_torch(boxes), to_torch(mask)),
                 np.asarray(jax.jit(JB.points_in_boxes_count)(pts, boxes, mask)),
                 name="count")
    assert_close(TB.enlarge_box3d(to_torch(boxes), (0.2, 0.3, 0.4)),
                 np.asarray(JB.enlarge_box3d(jnp.asarray(boxes), (0.2, 0.3, 0.4))),
                 name="enlarge")


def test_box_ious_match_jax():
    """boxes_iou3d within 1e-5 (the rotated-overlap formula in another
    framework's f32), boxes3d_nearest_bev_iou within 1e-6; identical boxes
    read 1."""
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 40, 4.0), _boxes(rng, 30, 4.0)
    b[:5] = a[:5]
    got = TI.boxes_iou3d(to_torch(a), to_torch(b))
    ref = np.asarray(jax.jit(JI.boxes_iou3d)(a, b))
    assert_close(got, ref, atol=1e-5, name="iou3d")
    assert (ref > 0.05).sum() > 20
    assert_close(torch.diagonal(got[:5, :5]), np.ones(5), atol=1e-5, name="self")
    assert_close(TB.boxes3d_nearest_bev_iou(to_torch(a), to_torch(b)),
                 np.asarray(jax.jit(JB.boxes3d_nearest_bev_iou)(a, b)), atol=1e-6,
                 name="nearest_bev")


def test_residual_coder_encode_matches_jax_and_round_trips():
    """encode within 1e-6 of JAX's; decode(encode(b, a), a) == b within 1e-5."""
    rng = np.random.RandomState(2)
    gt, anchors = _boxes(rng, 200), _boxes(rng, 200)
    gt[:3, 3:6] = 0.0                           # sizes clamped to 1e-5 first
    got = ResidualCoder().encode(to_torch(gt), to_torch(anchors))
    ref = JBC.ResidualCoder().encode(jnp.asarray(gt), jnp.asarray(anchors))
    assert_close(got, np.asarray(ref), atol=1e-6, rtol=1e-6, name="encode")
    back = ResidualCoder().decode(got[3:], to_torch(anchors[3:]))
    assert_close(back, gt[3:], atol=1e-5, rtol=1e-5, name="round trip")


# --------------------------------------------------------------------------- #
# anchor target assignment and the RPN loss
# --------------------------------------------------------------------------- #

def _assign_gt(port_cfg):
    """Ground truth over the tiny config's anchors: a box equal to an anchor
    and its duplicate (tied argmaxes), a box midway between two anchor rows
    (tied force matches), a small box (matched only by force), a box of an
    unanchored class, a wide box whose crossed anchor falls between the
    thresholds (ignored), padding; a second frame of random boxes."""
    a = port_cfg.head_logic.anchors_flat
    gt = np.zeros((2, 7, 8), np.float32)
    gt[0, 0, :7] = a[10, :7]
    gt[0, 1] = gt[0, 0]
    gt[0, 0, 7] = gt[0, 1, 7] = 1
    mid = (a[0, :7] + a[8, :7]) / 2
    gt[0, 2] = [*mid, 1]
    gt[0, 3] = [4.0, 2.0, -1.0, 0.8, 0.6, 1.0, 0.2, 1]
    gt[0, 4] = [9.0, -3.0, -1.0, 4.0, 1.9, 1.5, 0.0, 2]
    gt[0, 5] = [*a[20, :3], 4.2, 3.3, a[20, 5], 0.0, 1]
    rng = np.random.RandomState(3)
    for j in range(5):
        gt[1, j] = [rng.uniform(1, 15), rng.uniform(-7, 7), -1.0, 4.0, 1.8, 1.5,
                    rng.uniform(-3, 3), 1]
    return gt


@pytest.fixture(scope="module")
def head_logics():
    jcfg = _tiny_detector_cfg()
    jd = JaxDetectorConfig(jcfg.MODEL, jcfg.DATA_CONFIG, jcfg.CLASS_NAMES)
    pcfg = C.tiny_detector_cfg()
    pd = DetectorConfig(pcfg.MODEL, pcfg.DATA_CONFIG, pcfg.CLASS_NAMES)
    return jd.head_logic, pd.head_logic, _assign_gt(pd)


def test_assigner_matches_jax(head_logics):
    """Labels and weights equal, targets within 1e-6, ties included."""
    jl, pl, gt = head_logics
    ref = jax.tree.map(np.asarray, jl.assign_targets(jnp.asarray(gt)))
    got = pl.assign_targets(to_torch(gt))
    assert_close(got["box_cls_labels"], ref["box_cls_labels"], name="labels")
    assert_close(got["reg_weights"], ref["reg_weights"], name="weights")
    assert_close(got["box_reg_targets"], ref["box_reg_targets"], atol=1e-6,
                 name="targets")
    labels = ref["box_cls_labels"]
    assert (labels == 1).sum() >= 4 and (labels == 0).any() and (labels == -1).any()


def test_rpn_loss_matches_jax(head_logics):
    """The dense head's loss terms within 1e-5 (relative), on random head
    maps and the assigner's targets."""
    jl, pl, gt = head_logics
    rng = np.random.RandomState(4)
    b, h, w = 2, 4, 4
    a = pl.num_anchors_per_location
    preds = {"cls_preds": rng.randn(b, h, w, a).astype(np.float32),
             "box_preds": rng.randn(b, h, w, a * 7).astype(np.float32) * 0.3,
             "dir_cls_preds": rng.randn(b, h, w, a * 2).astype(np.float32)}
    targets = jl.assign_targets(jnp.asarray(gt))
    _, ref = jax.jit(jl.loss)(jax.tree.map(jnp.asarray, preds), targets)
    _, got = pl.loss({k: to_torch(v) for k, v in preds.items()},
                     pl.assign_targets(to_torch(gt)))
    assert set(got) == set(ref)
    for k in ref:
        assert_close(got[k], np.asarray(ref[k]), rtol=1e-5, name=k)


def test_losses_match_jax():
    """Focal, smooth-L1 (with code weights), cross-entropy and BCE
    elementwise within 1e-6 (relative)."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 50, 4).astype(np.float32) * 3
    t = (rng.rand(3, 50, 4) > 0.7).astype(np.float32)
    w = rng.rand(3, 50).astype(np.float32)
    cw = [1.0, 2.0, 0.5, 1.5]
    pairs = [(TL.sigmoid_focal_loss(to_torch(x), to_torch(t), to_torch(w)),
              JL.sigmoid_focal_loss(x, t, w)),
             (TL.weighted_smooth_l1(to_torch(x), to_torch(t), to_torch(w), code_weights=cw),
              JL.weighted_smooth_l1(x, t, w, code_weights=cw)),
             (TL.weighted_cross_entropy(to_torch(x), to_torch(t), to_torch(w)),
              JL.weighted_cross_entropy(x, t, w)),
             (TL.binary_cross_entropy_with_logits(to_torch(x), to_torch(t)),
              JL.binary_cross_entropy_with_logits(x, t))]
    for i, (got, ref) in enumerate(pairs):
        assert_close(got, np.asarray(ref), atol=1e-7, rtol=1e-6, name=f"loss {i}")


# --------------------------------------------------------------------------- #
# the RoI sampler
# --------------------------------------------------------------------------- #

def _rois_around(rng, gt, r):
    """r rois: jittered copies of the gt boxes (fg and hard bg) and boxes
    away from them (easy bg), labels 1, the last quarter invalid."""
    src = gt[rng.randint(0, len(gt), r), :7]
    jitter = rng.randn(r, 7).astype(np.float32) * [0.4, 0.4, 0.1, 0.3, 0.2, 0.1, 0.2]
    rois = (src + jitter * rng.uniform(0, 3, (r, 1))).astype(np.float32)
    rois[: r // 5, :2] += 20.0
    rois[:, 3:6] = np.abs(rois[:, 3:6]) + 0.5
    mask = np.arange(r) < 3 * r // 4
    rois = np.where(mask[:, None], rois, 0.0).astype(np.float32)
    return rois, np.where(mask, 1, 0).astype(np.int32), mask


@pytest.mark.parametrize("case", ["mixed", "no_foreground"])
def test_sample_rois_matches_jax(case):
    """With JAX's own priorities u: equal sampled rois, labels and masks,
    IoUs within 1e-6."""
    cfg = _tiny_detector_cfg().MODEL.ROI_HEAD.TARGET_CONFIG
    rng = np.random.RandomState(6)
    gt = np.zeros((5, 8), np.float32)
    gt[:3] = np.concatenate([_boxes(rng, 3, 8.0), np.ones((3, 1), np.float32)], 1)
    rois, labels, mask = _rois_around(rng, gt, 32)
    if case == "no_foreground":
        rois[:, :2] += 30.0
    scores = rng.randn(32).astype(np.float32)
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, (32,)))
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda *a: JR.sample_rois_for_rcnn(key, *a, cfg))(rois, labels, scores, mask, gt))
    got = TR.sample_rois_for_rcnn(to_torch(u), to_torch(rois), to_torch(labels),
                                  to_torch(scores), to_torch(mask), to_torch(gt),
                                  C.tiny_detector_cfg().MODEL.ROI_HEAD.TARGET_CONFIG)
    assert set(got) == set(ref)
    for k in ("rois", "roi_labels", "reg_valid_mask", "gt_of_rois", "roi_sample_mask"):
        assert_close(got[k], ref[k], name=k)
    for k in ("rcnn_cls_labels", "gt_iou_of_rois"):
        assert_close(got[k], ref[k], atol=1e-6, name=k)
    fg = int((ref["gt_iou_of_rois"] >= 0.55).sum())
    assert (fg > 0) == (case == "mixed") and ref["roi_sample_mask"].sum() > 4


def test_rcnn_iou_loss_matches_jax():
    """BCE and L2, ignored labels (-1) excluded, within 1e-6 (relative)."""
    rng = np.random.RandomState(7)
    pred = rng.randn(2, 16).astype(np.float32)
    lab = np.where(rng.rand(2, 16) > 0.3, rng.rand(2, 16), -1.0).astype(np.float32)
    for kind in ("BinaryCrossEntropy", "L2"):
        assert_close(TR.rcnn_iou_loss(to_torch(pred), to_torch(lab), kind, 0.5),
                     np.asarray(JR.rcnn_iou_loss(pred, lab, kind, 0.5)), rtol=1e-6,
                     name=kind)


# --------------------------------------------------------------------------- #
# the sparse conv's backward
# --------------------------------------------------------------------------- #

def _sparse_input(rng, shape=(6, 9, 8), batch=2, n=90, cap=100, cin=4):
    nz, ny, nx = shape
    keys = np.sort(rng.choice(batch * nz * ny * nx, n, replace=False))
    coords = np.zeros((cap, 4), np.int32)
    b, rem = np.divmod(keys, nz * ny * nx)
    z, rem = np.divmod(rem, ny * nx)
    y, x = np.divmod(rem, nx)
    coords[:n] = np.stack([b, z, y, x], 1)
    mask = np.arange(cap) < n
    feats = np.where(mask[:, None], rng.randn(cap, cin), 0.0).astype(np.float32)
    return feats, coords, mask, shape, batch


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_sparse_conv_backward_matches_autograd_and_jax(kind):
    """dx and dW of sum(y * r): the reference's backward (the transposed
    gather) against plain autograd of the gather (index_put_ accumulate)
    within 1e-5, and against jax.grad of the reference's rulebook conv
    within 1e-5 (relative 1e-5); two runs bit-equal."""
    rng = np.random.RandomState(8)
    feats, coords, mask, shape, batch = _sparse_input(rng)
    w = (rng.randn(27, 4, 5) * 0.3).astype(np.float32)
    kw = dict(kernel_size=3, padding=1) if kind == "subm" else \
        dict(kernel_size=3, stride=2, padding=1)

    def port():
        x = to_torch(feats).requires_grad_(True)
        wt = to_torch(w).requires_grad_(True)
        st = TSP.make_sparse_tensor(x, to_torch(coords), to_torch(mask), shape, batch)
        out = TSP.subm_conv3d(st, wt, **kw) if kind == "subm" else \
            TSP.sparse_conv3d(st, wt, out_capacity=feats.shape[0], **kw)
        r = torch.from_numpy(np.random.RandomState(9).randn(*out.features.shape)
                             .astype(np.float32))
        (out.features * r).sum().backward()
        return out, r, x.grad, wt.grad

    out, r, dx, dw = port()
    with plain_sparse_backward():
        out_p, _, dx_p, dw_p = port()
    _, _, dx2, dw2 = port()
    assert type(out.features.grad_fn).__name__ == "_RulebookConvBackward"
    assert type(out_p.features.grad_fn).__name__ != "_RulebookConvBackward"
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    assert_close(dx, dx_p, atol=1e-5, name="dx vs autograd")
    assert_close(dw, dw_p, atol=1e-5, name="dW vs autograd")

    def jax_loss(x, wj):
        st = JSP.make_sparse_tensor(x, jnp.asarray(coords), jnp.asarray(mask), shape,
                                    batch)
        o = JSP.subm_conv3d(st, wj, **kw) if kind == "subm" else \
            JSP.sparse_conv3d(st, wj, **kw)
        return (o.features * jnp.asarray(to_numpy(r))).sum(), o.mask

    (_, omask), (jdx, jdw) = jax.jit(jax.value_and_grad(jax_loss, (0, 1), has_aux=True))(
        jnp.asarray(feats), jnp.asarray(w))
    assert_close(out.mask, np.asarray(omask), name="output active set")
    assert int(out.mask.sum()) > 20
    assert_close(dx, np.asarray(jdx), atol=1e-5, rtol=1e-5, name="dx vs jax")
    assert_close(dw, np.asarray(jdw), atol=1e-5, rtol=1e-5, name="dW vs jax")


@pytest.mark.parametrize("kind", ["subm", "strided"])
def test_sparse_conv_backward_bf16_over_gemm_blocks_matches_jax(kind):
    """bf16 features on more rows than one matrix product takes (GEMM_ROWS),
    as the flagship's bf16 backbone has: dW, summed in f32 across the blocks,
    within 1e-5 of max |dW| (relative 1e-5) of jax.grad of the reference's
    rulebook conv, and dx, a bf16 result, within 2^-8 relative (1e-5 of max
    |dx|). The inputs hold bf16 values, so the reference runs in f32 on the
    same numbers."""
    rng = np.random.RandomState(11)
    n = TSP.GEMM_ROWS + 4000
    feats, coords, mask, shape, batch = _sparse_input(rng, shape=(20, 60, 60), n=n,
                                                      cap=n + 96)
    as_bf16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    feats, w = as_bf16(feats), as_bf16((rng.randn(27, 4, 8) * 0.3).astype(np.float32))
    kw = dict(kernel_size=3, padding=1) if kind == "subm" else \
        dict(kernel_size=3, stride=2, padding=1)
    x = to_torch(feats).bfloat16().requires_grad_(True)
    wt = to_torch(w).requires_grad_(True)
    st = TSP.make_sparse_tensor(x, to_torch(coords), to_torch(mask), shape, batch)
    out = TSP.subm_conv3d(st, wt, **kw) if kind == "subm" else \
        TSP.sparse_conv3d(st, wt, out_capacity=feats.shape[0], **kw)
    r = as_bf16(np.random.RandomState(12).randn(*out.features.shape).astype(np.float32))
    (out.features.float() * to_torch(r)).sum().backward()
    assert out.features.dtype == torch.bfloat16 and int(out.mask.sum()) > TSP.GEMM_ROWS // 4

    def jax_loss(xj, wj):
        stj = JSP.make_sparse_tensor(xj, jnp.asarray(coords), jnp.asarray(mask), shape,
                                     batch)
        o = JSP.subm_conv3d(stj, wj, **kw) if kind == "subm" else \
            JSP.sparse_conv3d(stj, wj, **kw)
        return (o.features * jnp.asarray(r)).sum()

    jdx, jdw = (np.asarray(g) for g in jax.jit(jax.grad(jax_loss, (0, 1)))(
        jnp.asarray(feats), jnp.asarray(w)))
    assert_close(wt.grad, jdw, atol=1e-5 * np.abs(jdw).max(), rtol=1e-5, name="dW vs jax")
    assert_close(x.grad.float(), jdx, atol=1e-5 * np.abs(jdx).max(), rtol=2 ** -8,
                 name="dx vs jax")


# --------------------------------------------------------------------------- #
# batch norm in training
# --------------------------------------------------------------------------- #

def test_masked_batch_norm_training_matches_flax():
    """Output within 1e-5, running mean and (biased) variance within 1e-6
    of flax's MaskedBatchNorm after one step; padding rows do not count."""
    rng = np.random.RandomState(10)
    x = (rng.randn(50, 6) * 2 + 1).astype(np.float32)
    mask = rng.rand(50) > 0.3
    x[~mask] = 100.0
    variables = {"params": {"scale": rng.rand(6).astype(np.float32) + 0.5,
                            "bias": rng.randn(6).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(6).astype(np.float32),
                                 "var": rng.rand(6).astype(np.float32) + 0.5}}
    ref, mut = jax.jit(lambda v, a, m: JaxMaskedBN().apply(
        v, a, m, train=True, mutable=["batch_stats"]))(variables, x, mask)
    bn = MaskedBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(to_torch(variables["params"]["scale"]))
        bn.bias.copy_(to_torch(variables["params"]["bias"]))
        bn.running_mean.copy_(to_torch(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(to_torch(variables["batch_stats"]["var"]))
    got = bn.train()(to_torch(x), to_torch(mask))
    assert_close(got, np.asarray(ref), atol=1e-5, name="y")
    assert_close(bn.running_mean, np.asarray(mut["batch_stats"]["mean"]), atol=1e-6,
                 name="running mean")
    assert_close(bn.running_var, np.asarray(mut["batch_stats"]["var"]), atol=1e-6,
                 name="running var")


def test_batch_norm2d_running_stats_are_biased_as_flax():
    """BN2d in training: output within 1e-5 of flax's nn.BatchNorm
    (momentum 0.99, eps 1e-3) and running statistics within 1e-6, the
    variance biased; torch's own BatchNorm2d would move it by the unbiased
    one and miss."""
    rng = np.random.RandomState(11)
    x = (rng.randn(2, 5, 3, 4) * 3 + 2).astype(np.float32)       # NCHW, few samples
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": np.ones(5, np.float32), "bias": np.zeros(5, np.float32)},
                 "batch_stats": {"mean": np.zeros(5, np.float32),
                                 "var": np.ones(5, np.float32)}}
    ref, mut = jax.jit(lambda v, a: flax_bn.apply(v, a, mutable=["batch_stats"]))(
        variables, x.transpose(0, 2, 3, 1))
    bn = BatchNorm2d(5, eps=1e-3, momentum=0.01).train()
    got = bn(to_torch(x))
    assert_close(got.permute(0, 2, 3, 1), np.asarray(ref), atol=1e-5, name="y")
    assert_close(bn.running_mean, np.asarray(mut["batch_stats"]["mean"]), atol=1e-6,
                 name="mean")
    assert_close(bn.running_var, np.asarray(mut["batch_stats"]["var"]), atol=1e-6,
                 name="var")
    plain = torch.nn.BatchNorm2d(5, eps=1e-3, momentum=0.01).train()
    plain(to_torch(x))
    assert (plain.running_var - bn.running_var).abs().max() > 1e-4


# --------------------------------------------------------------------------- #
# optimizers and schedules
# --------------------------------------------------------------------------- #

def _opt_cfg(**kw):
    base = dict(C.tiny_detector_cfg().OPTIMIZATION)
    base.update(kw)
    return Cfg(base), JaxCfg(base)


@pytest.mark.parametrize("total", [2, 37, 1000])
def test_onecycle_lr_and_b1_match_optax_over_the_first_phase(total):
    """b1 over the warm-up equal to optax's to two f32 ulps; lr at every step
    within 2.5e-7 of its peak: optax takes the cosine in f32, and two ulps
    of it, scaled by the cycle's height, are what is left where the value
    itself is small."""
    pcfg, jcfg = _opt_cfg()
    counts = np.arange(total)
    warm = min(max(int(round(0.4 * max(total, 2))), 1), max(total, 2) - 1)
    j_lr = np.asarray(jax.jit(jax.vmap(JO.build_lr_schedule(jcfg, total)))(counts))
    p_lr = np.float32([TO.build_lr_schedule(pcfg, total)(int(c)) for c in counts])
    assert_close(p_lr, j_lr, atol=2.5e-7 * float(pcfg.LR), name="lr")
    j_b1 = jax.jit(jax.vmap(JO._safe_cosine_onecycle(total, 0.85, 0.4, 0.85 / 0.95,
                                                      0.85 / 0.95)))(counts[:warm + 1])
    p_b1 = [TO.build_b1_schedule(pcfg, total)(int(c)) for c in counts[:warm + 1]]
    assert_close(np.float32(p_b1), np.asarray(j_b1), rtol=2.5e-7, name="b1")


def test_b1_departure_from_the_reference():
    """The reference's b1 ends at 0.85 / (0.85 / 0.95)^2 = 1.0618 and is >= 1
    from step 783 of 1000, where Adam's bias correction 1 - b1^t crosses 0:
    on a constant gradient its update at step 782 is more than 10 times the
    one at step 780. The port's b1 returns to 0.95 and stays below 1, and
    its updates fall smoothly (no step more than 1% above the one before)."""
    pcfg, jcfg = _opt_cfg()
    tx = JO.build_optimizer(jcfg, 1000)

    def body(carry, _):
        p, st = carry
        upd, st = tx.update(jnp.ones(()), st, p)
        return (p + upd, st), jnp.abs(upd)

    _, j_upd = jax.jit(lambda p: jax.lax.scan(body, (p, tx.init(p)), None, 1000))(
        jnp.zeros(()))
    j_upd = np.asarray(j_upd)
    assert j_upd[782] > 10 * j_upd[780]
    w = torch.nn.Parameter(torch.zeros(()))
    opt = TO.build_optimizer(pcfg, 1000, [w])
    p_upd = []
    for c in range(1000):
        before = w.detach().clone()
        w.grad = torch.ones(())
        opt.step(c)
        p_upd.append(float((w.detach() - before).abs()))
    assert_close(np.float32(p_upd[:400]), j_upd[:400], rtol=1e-4, name="updates")
    assert (np.diff(p_upd[400:]) <= 0.01 * np.array(p_upd[400:-1])).all()
    j_b1 = np.asarray(jax.jit(jax.vmap(JO._safe_cosine_onecycle(
        1000, 0.85, 0.4, 0.85 / 0.95, 0.85 / 0.95)))(np.arange(1000)))
    assert abs(j_b1[-1] - 0.85 / (0.85 / 0.95) ** 2) < 1e-4
    assert int(np.argmax(j_b1 >= 1.0)) == 783
    b1 = TO.build_b1_schedule(pcfg, 1000)
    p_b1 = np.array([b1(c) for c in range(1000)])
    assert abs(p_b1[0] - 0.95) < 1e-7 and abs(p_b1.min() - 0.85) < 1e-7
    assert abs(p_b1[-1] - 0.95) < 1e-4 and p_b1.max() <= 0.95 + 1e-7


def test_step_decay_clip_and_warmup_match_jax():
    """adam's step decay with LR_CLIP and LR_WARMUP, every step of 50,
    within two f32 ulps of JAX's."""
    pcfg, jcfg = _opt_cfg(OPTIMIZER="adam", LR=0.01, NUM_EPOCHS=5,
                          DECAY_STEP_LIST=[2, 4], LR_DECAY=0.1, LR_CLIP=2e-4,
                          LR_WARMUP=True, WARMUP_EPOCH=1)
    counts = np.arange(50)
    j = np.asarray(jax.jit(jax.vmap(JO.build_lr_schedule(jcfg, 50)))(counts))
    p = np.float32([TO.build_lr_schedule(pcfg, 50)(int(c)) for c in counts])
    assert_close(p, j, rtol=2.5e-7, name="lr")
    assert j[5] < j[9] and j[25] < j[15] and j[-1] == np.float32(2e-4)


@pytest.mark.parametrize("name", ["adam_onecycle", "adam", "adamw", "sgd"])
def test_optimizers_match_optax(name):
    """Three steps on the same gradients (one above the clip): the port's
    parameters within 1e-6 of optax's."""
    pcfg, jcfg = _opt_cfg(OPTIMIZER=name, WEIGHT_DECAY=0.05, GRAD_NORM_CLIP=3.0)
    rng = np.random.RandomState(12)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.5, 4.0, 1.0)]
    tx = JO.build_optimizer(jcfg, 10)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    step = jax.jit(tx.update)
    tp = {k: torch.nn.Parameter(to_torch(v)) for k, v in params.items()}
    opt = TO.build_optimizer(pcfg, 10, tp.values())
    for i, g in enumerate(grads):
        upd, opt_state = step(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for k, p in tp.items():
            p.grad = to_torch(g[k])
        opt.step(i)
        for k in params:
            assert_close(tp[k].detach(), np.asarray(jp[k]), atol=1e-6, name=f"{name} {k} {i}")


def test_lr_warmup_matches_reference_formula():
    """The warm-up starts at LR / DIV_FACTOR and reaches LR after
    WARMUP_EPOCH epochs (a half cosine)."""
    pcfg, _ = _opt_cfg(OPTIMIZER="sgd", LR=0.01, NUM_EPOCHS=10, LR_WARMUP=True,
                       WARMUP_EPOCH=2, DIV_FACTOR=10)
    sched = TO.build_lr_schedule(pcfg, 100)
    assert math.isclose(sched(0), 0.001) and math.isclose(sched(20), 0.01)
    assert math.isclose(sched(10), 0.001 + 0.009 / 2)
