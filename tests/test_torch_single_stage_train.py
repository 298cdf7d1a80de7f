"""Training of the single-stage detectors in the port (PointPillar, the
multi-head residual SECONDNet, the focal SECONDNet), the focal importance
loss and the ATSS assigner, against the JAX package on the CPU.

Weights: seeded_flax_variables on the tree of JAX's init, carried into the
port by ``single_stage_state_dict_from_flax``. Inputs:
chip_smoke.single_stage_train_inputs, two blob frames with ground-truth cars
on them, and in frame 0 a pedestrian and a cyclist near anchor nodes. JAX's gradients come from ``jax.value_and_grad`` of its training
forward and loss; the port's from its train step's backward, in f64 (JAX's
sparse convs pin f32).

JAX's PointPillar cannot take a training forward: its VFE's flax batch norm
runs under ``jax.vmap`` and leaks a tracer (UnexpectedTracerError; ROADMAP
§3). Its reference here is JAX's own modules (voxelize, DynamicPillarVFE,
pillar_scatter, BaseBEVBackbone, the anchor head and its loss) composed
without the vmap: the VFE over the batch's points at once, its batch norms
taking their statistics over every point row of the batch, as the port's
and the reference's DynamicPillarVFE do. In eval that composition equals
JAX's PointPillar (held below).

Tolerances, as tests/test_torch_pvrcnn_train.py holds PV-RCNN's step: loss
terms 1e-5 (absolute and relative); gradients 5e-4 of the tensor's largest
|gradient|; running statistics after the step 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import single_stage_train_inputs as _inputs
from seevcn_tpu.models.detectors.second import build_detector as jax_build
from seevcn_tpu.models.detectors.second import focal_importance_loss as jax_focal_loss
from seevcn_tpu.models.modules.backbone2d import BaseBEVBackbone as JBEV
from seevcn_tpu.models.modules.dense_heads import AnchorHeadLogic as JLogic
from seevcn_tpu.models.modules.dense_heads import build_anchor_head as jax_head
from seevcn_tpu.models.modules.map_to_bev import pillar_scatter as jax_scatter
from seevcn_tpu.models.modules.vfe import DynamicPillarVFE as JVFE
from seevcn_tpu.ops.voxelize import voxelize as jax_voxelize
from seevcn_torch.models.detectors import configs as C
from seevcn_torch.models.detectors.second import build_detector, focal_importance_loss
from seevcn_torch.models.modules.dense_heads import AnchorHeadLogic
from seevcn_torch.testing import assert_close, seeded_flax_variables, to_numpy, to_torch
from seevcn_torch.train.train import create_train_state, train_forward
from seevcn_torch.utils.weights import single_stage_state_dict_from_flax

CONFIGS = {"pointpillar": C.tiny_pointpillar_cfg,
           "second_multihead": C.tiny_second_multihead_cfg,
           "second_focal": C.tiny_second_focal_cfg}


def _export(params, stats):
    return single_stage_state_dict_from_flax(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": stats}))


def _jax_pointpillar(cfg, dcfg):
    """PointPillar's forward from JAX's modules, the VFE over the batch's
    points at once: (params, stats, points, valid, train) -> (head_out,
    new batch_stats)."""
    mcfg, b2 = cfg.MODEL, cfg.MODEL.BACKBONE_2D
    vmax = dcfg.max_voxels
    vfe = JVFE(num_filters=tuple(mcfg.VFE.NUM_FILTERS), voxel_size=tuple(dcfg.voxel_size),
               point_cloud_range=tuple(dcfg.point_cloud_range))
    bev = JBEV(layer_nums=tuple(b2.LAYER_NUMS), layer_strides=tuple(b2.LAYER_STRIDES),
               num_filters=tuple(b2.NUM_FILTERS),
               upsample_strides=tuple(b2.UPSAMPLE_STRIDES),
               num_upsample_filters=tuple(b2.NUM_UPSAMPLE_FILTERS))
    head = jax_head(mcfg.DENSE_HEAD, dcfg.head_logic, dcfg.num_class, dcfg.class_names)

    def forward(params, stats, pts, valid, train):
        b, p = pts.shape[:2]
        res = jax.vmap(lambda q, v: jax_voxelize(
            q, v, point_cloud_range=dcfg.point_cloud_range, voxel_size=dcfg.voxel_size,
            max_voxels=vmax))(pts, valid)
        flat = jax.vmap(lambda q, o: q[o])(pts, res.point_order).reshape(b * p, -1)
        frame = jnp.arange(b, dtype=jnp.int32)
        pid = jnp.where(res.point_voxel_id >= 0,
                        res.point_voxel_id + frame[:, None] * vmax, -1).reshape(-1)
        coords = jnp.concatenate([jnp.broadcast_to(frame[:, None, None], (b, vmax, 1)),
                                  res.coords], -1).reshape(b * vmax, 4)
        new = {}
        feats, new["vfe"] = vfe.apply({"params": params["vfe"], "batch_stats": stats["vfe"]},
                                      flat, pid, res.features[..., :3].reshape(-1, 3), coords,
                                      b * vmax, train, mutable=["batch_stats"])
        canvas = jax_scatter(feats, coords, res.mask.reshape(-1), b,
                             (int(dcfg.grid_size[0]), int(dcfg.grid_size[1])))
        bev2d, new["backbone_2d"] = bev.apply(
            {"params": params["backbone_2d"], "batch_stats": stats["backbone_2d"]},
            canvas, train, mutable=["batch_stats"])
        head_out = head.apply({"params": params["dense_head"]}, bev2d, train)
        return head_out, {k: v["batch_stats"] for k, v in new.items()}

    return forward


_RUNS = {}


def _run(name):
    """JAX's loss terms, gradients and updated running statistics for one
    training forward of the tiny ``name``, and the port's (f64) from its
    train step on the same weights and inputs."""
    if name in _RUNS:
        return _RUNS[name]
    cfg = CONFIGS[name]()
    jm, dcfg = jax_build(cfg)
    pts, valid, gt = _inputs()
    shapes = jax.eval_shape(lambda p, v: jm.init({"params": jax.random.PRNGKey(0)},
                                                 p, v, train=False),
                            jnp.asarray(pts), jnp.asarray(valid))
    variables = jax.tree.map(jnp.asarray, seeded_flax_variables(shapes, seed=5))
    params, stats = variables["params"], variables["batch_stats"]
    logic = dcfg.head_logic
    if name == "pointpillar":
        fwd = _jax_pointpillar(cfg, dcfg)
        eval_ref = jax.jit(lambda p, q: jm.apply(variables, p, q, train=False))(pts, valid)
        eval_mine = jax.jit(lambda p, q: fwd(params, stats, p, q, False))(pts, valid)[0]
        for k in eval_ref["head_out"]:
            assert_close(np.asarray(eval_mine[k]), np.asarray(eval_ref["head_out"][k]),
                         name=f"composed eval {k}")

        def loss_fn(prm):
            head_out, new = fwd(prm, stats, pts, valid, True)
            total, tb = logic.loss(head_out, logic.assign_targets(gt))
            return total, (tb, new)
    else:
        def loss_fn(prm):
            out, new = jm.apply({"params": prm, "batch_stats": stats}, pts, valid,
                                gt_boxes=gt, train=True, rng=jax.random.PRNGKey(1),
                                mutable=["batch_stats"])
            total, tb = jm.loss(out, jnp.asarray(gt))
            return total, (tb, new["batch_stats"])

    (loss, (tb, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    jax_terms = {"loss": float(loss), **{k: float(v) for k, v in tb.items()}}
    jax_grads = _export(grads, stats)
    jax_after = _export(params, new_stats)

    model, _ = build_detector(cfg, _export(params, stats), device="cpu")
    state = create_train_state(model.double(), cfg.OPTIMIZATION, 100)
    dbl = lambda a: torch.from_numpy(np.asarray(a)).double()     # noqa: E731
    ploss, ptb, _ = train_forward(state, dbl(pts), torch.from_numpy(valid), dbl(gt))
    state.optimizer.zero_grad()
    ploss.backward()
    port_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    state.optimizer.step(0)
    terms = {"loss": ploss.item(), **{k: v.item() for k, v in ptb.items()}}
    _RUNS[name] = (jax_terms, jax_grads, jax_after, terms, port_grads,
                   dict(model.named_buffers()))
    return _RUNS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_jax(name):
    """One train step of each tiny detector: loss terms (the focal
    SECONDNet's loss_box_of_pts among them), every gradient and the running
    statistics the step leaves; every group of the multi-head SECONDNet has
    foreground (its box branches have a gradient)."""
    jax_terms, jax_grads, jax_after, terms, grads, buffers = _run(name)
    assert set(terms) == set(jax_terms)
    for k, v in jax_terms.items():
        assert_close(np.float64(terms[k]), np.float64(v), atol=1e-5, rtol=1e-5, name=k)
    assert terms["rpn_loss_loc"] > 0
    for n, g in grads.items():
        ref = jax_grads[n]
        assert_close(g, ref, atol=5e-4 * float(ref.abs().max()) + 1e-12, name=f"grad {n}")
    for n, b in buffers.items():
        if n.endswith("running_mean") or n.endswith("running_var"):
            assert_close(b, jax_after[n], atol=1e-5, rtol=1e-5, name=n)
    if name == "second_multihead":
        for g in range(2):
            assert grads[f"dense_head.rpn_heads.{g}.conv_box.weight"].abs().max() > 0
    if name == "second_focal":
        assert terms["loss_box_of_pts"] > 0


def _focal_aux(seed=0):
    """Two focal layers' importances over voxels of two frames, a third of
    them padding, at strides 1 and 2 on the tiny grid."""
    rng = np.random.RandomState(seed)
    aux = []
    for stride, n in ((1, 300), (2, 200)):
        coords = np.stack([rng.randint(0, 2, n), rng.randint(0, 40 // stride, n),
                           rng.randint(0, 32 // stride, n), rng.randint(0, 32 // stride, n)],
                          1).astype(np.int32)
        aux.append({"importance": rng.rand(n).astype(np.float32), "coords": coords,
                    "mask": rng.rand(n) < 0.67, "stride": stride})
    aux[0]["importance"][:3] = [0.0, 1.0, 1e-9]               # the clamp's ends
    return aux


def test_focal_importance_loss_matches_jax():
    """The box-of-points BCE of the focal layers, its value and its
    gradient with respect to the importances, with voxels inside and
    outside the ground truth of their own frame (padding rows of gt too)."""
    aux = _focal_aux()
    _, _, gt = _inputs()
    gt[:, :, 3:6] *= 2.5                         # boxes that hold many voxel centres
    pcr, vs = [0, -8, -2, 16, 8, 2], [0.5, 0.5, 0.1]

    def jax_fn(imps):
        return jax_focal_loss([{**a, "importance": i, "coords": jnp.asarray(a["coords"]),
                                "mask": jnp.asarray(a["mask"])}
                               for a, i in zip(aux, imps)], jnp.asarray(gt), pcr, vs)

    ref, ref_g = jax.value_and_grad(jax_fn)([jnp.asarray(a["importance"]) for a in aux])
    imps = [to_torch(a["importance"]).requires_grad_() for a in aux]
    got = focal_importance_loss([{**a, "importance": i, "coords": to_torch(a["coords"]),
                                  "mask": to_torch(a["mask"])} for a, i in zip(aux, imps)],
                                to_torch(gt), pcr, vs)
    got.backward()
    assert_close(got.detach(), np.asarray(ref), rtol=1e-6, name="loss")
    for i, g in zip(imps, ref_g):
        assert_close(i.grad, np.asarray(g), atol=1e-6 * float(np.abs(g).max()), name="d imp")
    # both targets occur on valid voxels
    inside = 0
    for a in aux:
        c = (a["coords"][:, 1:].astype(np.float32) + 0.5) * a["stride"]
        inside += ((np.abs(c[:, 2] * 0.5 - 8) < 5) & a["mask"]).sum()
    assert inside > 0 and float(ref) > 0


# --- ATSS -----------------------------------------------------------------------


def _atss_head_cfg(classes):
    """tests/test_multiclass.py:_head_cfg() with TARGET_ASSIGNER NAME ATSS,
    TOPK 9, for the first ``classes`` anchor classes."""
    head = C._kitti_three_class_head(8)
    head.ANCHOR_GENERATOR_CONFIG = head.ANCHOR_GENERATOR_CONFIG[:classes]
    head.TARGET_ASSIGNER_CONFIG["NAME"] = "ATSS"
    head.TARGET_ASSIGNER_CONFIG["TOPK"] = 9
    return head


GRID, PCR = [128, 128, 40], [0, -32, -3, 64, 32, 1]      # a 16 x 16 map


def _atss_gt(classes):
    """A Car at (12.80, 6.40) and a Cyclist; with one class, two Cars; two
    padding rows each."""
    gt = np.zeros((1, 4, 8), np.float32)
    gt[0, 0] = [12.80, 6.40, -1.0, 3.9, 1.6, 1.56, 0.2, 1]
    gt[0, 1] = [38.4, -12.8, -0.5, 1.76, 0.6, 1.73, 1.2, 3 if classes == 3 else 1]
    return gt


def _class_major_to_per_location(x, per_loc):
    """JAX's ATSS rows (anchor classes joined class-major, each class's
    anchors per location) -> the head's order (per location, classes
    interleaved)."""
    n = len(per_loc)
    parts, start = [], 0
    loc = x.shape[1] // sum(per_loc)
    for k in per_loc:
        parts.append(x[:, start:start + loc * k].reshape(x.shape[0], loc, k, *x.shape[2:]))
        start += loc * k
    return np.concatenate(parts, 2).reshape(x.shape) if n > 1 else x


@pytest.mark.parametrize("classes", [1, 3], ids=["one_class", "three_classes"])
def test_atss_targets(classes):
    """ATSS through AnchorHeadLogic (NAME ATSS, TOPK 9). With one anchor
    class the port's targets equal JAX's. With three (the KITTI classes)
    JAX joins the classes class-major while the head predicts them per
    location: the port's targets are JAX's re-ordered into the head's
    layout, so that each label sits on the anchor the head predicts for
    its row (the departure of ROADMAP §3). JAX's flat row 294 is its Car
    label on a Car anchor at (12.80, 6.40); in the head's layout row 294 is
    a Car anchor at (4.27, -19.20), 27 m from that Car."""
    names = ["Car", "Pedestrian", "Cyclist"][:classes]
    head = _atss_head_cfg(classes)
    gt = _atss_gt(classes)
    ref_logic = JLogic(head, classes, names, GRID, PCR)
    logic = AnchorHeadLogic(head, classes, names, GRID, PCR)
    ref = {k: np.asarray(v) for k, v in ref_logic.assign_targets(jnp.asarray(gt)).items()}
    got = logic.assign_targets(to_torch(gt))
    per_loc = logic.num_anchors_per_location_list
    for k in ("box_cls_labels", "box_reg_targets", "reg_weights"):
        want = _class_major_to_per_location(ref[k], per_loc)
        if k == "box_reg_targets":
            assert_close(got[k], want, atol=1e-5, name=k)
        else:
            assert_close(got[k], want.astype(to_numpy(got[k]).dtype), name=k)
    labels = to_numpy(got["box_cls_labels"])[0]
    assert set(np.unique(labels)) == ({0, 1, 3} if classes == 3 else {0, 1})
    anchors = logic.anchors_flat
    for row in np.where(labels > 0)[0]:
        g = gt[0][gt[0, :, 7] == labels[row]]
        assert np.hypot(*(anchors[row, None, :2] - g[:, :2]).T).min() < 6.0, row
    if classes == 3:
        assert ref["box_cls_labels"][0, 294] == 1
        assert_close(anchors[294, :2], np.float32([4.2667, -19.2]), atol=1e-3, name="row 294")
        assert labels[294] == 0
